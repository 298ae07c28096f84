"""Minimal binary-little-endian PLY reader/writer (numpy only; a copy of
adgs_tpu/data/ply.py, which the port does not import).

Covers the reference's PLY uses without the plyfile dependency:
  - scene point clouds with optional per-point time/obj_id
    (fetchPly/storePly, scene/dataset_readers.py:93-140)
  - Gaussian checkpoint export/import
    (save_ply/load_ply, scene/gaussian_model.py:428-543) — same property
    names (shs_dc_i, shs_rest_i, opacity, scale_i, rot_i, obj) so
    checkpoints interoperate with the reference tooling.
"""

from __future__ import annotations

import io
from typing import Mapping

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}
_NAMES = {"<f4": "float", "<f8": "double", "u1": "uchar", "i1": "char",
          "<i2": "short", "<u2": "ushort", "<i4": "int", "<u4": "uint"}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the 'vertex' element of a binary- or ascii-LE PLY into a dict of
    1D arrays keyed by property name."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    fmt = None
    count = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported")
            props.append((parts[2], _DTYPES[parts[1]]))

    if fmt == "ascii":
        body = data[header_end:].decode("ascii").split()
        arr = np.asarray(body, dtype=np.float64).reshape(count, len(props))
        return {name: arr[:, i].astype(np.dtype(dt))
                for i, (name, dt) in enumerate(props)}
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    dtype = np.dtype([(name, dt) for name, dt in props])
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=header_end)
    return {name: np.ascontiguousarray(arr[name]) for name, _ in props}


def write_ply(path: str, fields: Mapping[str, np.ndarray]) -> None:
    """Write named 1D arrays (equal length) as a binary-LE vertex element."""
    names = list(fields.keys())
    n = len(next(iter(fields.values())))
    dtype = np.dtype([(k, np.asarray(fields[k]).dtype.newbyteorder("<"))
                      for k in names])
    rec = np.empty(n, dtype=dtype)
    for k in names:
        rec[k] = np.asarray(fields[k])
    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(f"element vertex {n}\n".encode())
    for k in names:
        tname = _NAMES[rec.dtype[k].str.lstrip("=|")]
        buf.write(f"property {tname} {k}\n".encode())
    buf.write(b"end_header\n")
    buf.write(rec.tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def store_point_cloud(path: str, points: np.ndarray, colors: np.ndarray,
                      times: np.ndarray | None = None,
                      obj_id: np.ndarray | None = None) -> None:
    """storePly contract (dataset_readers.py:117-140): xyz + normals(0) +
    uchar rgb (+ optional float t, obj)."""
    fields = {
        "x": points[:, 0].astype("<f4"),
        "y": points[:, 1].astype("<f4"),
        "z": points[:, 2].astype("<f4"),
        "nx": np.zeros(len(points), "<f4"),
        "ny": np.zeros(len(points), "<f4"),
        "nz": np.zeros(len(points), "<f4"),
        "red": np.clip(colors[:, 0], 0, 255).astype("u1"),
        "green": np.clip(colors[:, 1], 0, 255).astype("u1"),
        "blue": np.clip(colors[:, 2], 0, 255).astype("u1"),
    }
    if times is not None:
        fields["t"] = np.asarray(times).reshape(-1).astype("<f4")
    if obj_id is not None:
        fields["obj"] = np.asarray(obj_id).reshape(-1).astype("<f4")
    write_ply(path, fields)


def fetch_point_cloud(path: str):
    """fetchPly contract (dataset_readers.py:93-115): returns
    (points [N,3], colors [N,3] in [0,1], times [N], obj_id [N])."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], 1)
        cols = cols.astype(np.float32)
        if cols.max() > 1.0 + 1e-6:
            cols = cols / 255.0
    else:
        cols = np.ones_like(pts) * 0.5
    times = v.get("t", np.zeros(len(pts), np.float32)).astype(np.float32)
    obj = v.get("obj", np.zeros(len(pts), np.float32)).astype(np.float32)
    return pts, cols, times, obj
