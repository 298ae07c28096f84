"""COLMAP binary/text model readers (numpy only; a copy of
adgs_tpu/data/colmap.py, which the port does not import).

Parity with scene/colmap_loader.py:83-294: cameras.bin / images.bin /
points3D.bin (and their .txt forms) as used by the offline SfM pipeline
(scripts/colmap.py) to triangulate static points with known poses.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray   # wxyz
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """scene/colmap_loader.py:29-41 (wxyz)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        n = _read(f, 8, "Q")[0]
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, np_ = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * np_, "d" * np_))
            out[cid] = ColmapCamera(cid, name, w, h, params)
    return out


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        n = _read(f, 8, "Q")[0]
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n2d = _read(f, 8, "Q")[0]
            data = np.frombuffer(f.read(24 * n2d), dtype=np.float64)
            data = data.reshape(n2d, 3) if n2d else data.reshape(0, 3)
            xys = data[:, :2]
            ids = data[:, 2].astype(np.int64)
            out[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                   name.decode("utf-8"), xys, ids)
    return out


def read_points3d_binary(path: str):
    """Returns (xyz [N,3], rgb [N,3] uint8, error [N])
    (scene/colmap_loader.py:190-222)."""
    with open(path, "rb") as f:
        n = _read(f, 8, "Q")[0]
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            _pid = _read(f, 8, "Q")[0]
            xyz[i] = _read(f, 24, "ddd")
            rgb[i] = _read(f, 3, "BBB")
            err[i] = _read(f, 8, "d")[0]
            tl = _read(f, 8, "Q")[0]
            f.read(8 * tl)  # (image_id, point2D_idx) track
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            xyz.append([float(e[1]), float(e[2]), float(e[3])])
            rgb.append([int(e[4]), int(e[5]), int(e[6])])
            err.append(float(e[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))
