"""Per-frame camera metadata for the offline geometry tools (a copy of
adgs_tpu/geometry/scene_meta.py on the port's own readers; host code).

One loader for the three dataset contracts (sentinels as in
data/readers.py / the reference's scripts/colmap.py + segment_pcd.py
__main__ blocks): returns per-frame K/R/T, raw timestamps, the train/val
split, and the prior-file paths — without loading any images."""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..data.readers import detect_dataset, get_val_frames


class SceneMeta(NamedTuple):
    dataset: str
    K: np.ndarray          # [F, 3, 3]
    R: np.ndarray          # [F, 3, 3] world-to-camera
    T: np.ndarray          # [F, 3]
    fid: np.ndarray        # [F] raw timestamps (cloud `t` column values)
    is_val: np.ndarray     # [F] bool
    cam_id: np.ndarray     # [F] int
    step: np.ndarray       # [F] int temporal step index
    image_paths: list
    semantic_paths: list
    sky_paths: list
    width: np.ndarray      # [F] int
    height: np.ndarray     # [F] int


def load_scene_meta(path: str, split_mode: str = "nvs-75",
                    num_cam: int | None = None) -> SceneMeta:
    dataset = detect_dataset(path)
    img_files = sorted(os.listdir(os.path.join(path, "image")))

    if dataset == "kitti":
        num_cam = 2 if num_cam is None else num_cam
        meta = np.load(os.path.join(path, "poses.npz"), allow_pickle=True)
        R, T = meta["R"], meta["T"]
        H, W = int(meta["height"]), int(meta["width"])
        focal = float(meta["focal"])
        fid = np.asarray(meta["time_stamp"], np.float64)
        F = len(fid)
        K = np.broadcast_to(np.array(
            [[focal, 0.0, W / 2.0], [0.0, focal, H / 2.0], [0.0, 0.0, 1.0]],
            np.float64), (F, 3, 3))
        widths = np.full(F, W)
        heights = np.full(F, H)
        if split_mode == "nvs-25":
            i_test = set(get_val_frames(F // num_cam, train_every=4))
        elif split_mode == "nvs-50":
            i_test = set(get_val_frames(F // num_cam, test_every=2))
        elif split_mode == "nvs-75":
            i_test = set(get_val_frames(F // num_cam, test_every=4))
        else:
            raise ValueError("no such split: " + split_mode)
        is_val = np.asarray([i // num_cam in i_test for i in range(F)])
    else:
        meta_file = "cameras.npz" if dataset == "waymo" else "meta.npz"
        num_cam = ((1 if dataset == "waymo" else 3)
                   if num_cam is None else num_cam)
        meta = np.load(os.path.join(path, meta_file), allow_pickle=True)
        Kraw, R, T = meta["K"], meta["R"], meta["T"]
        fid = np.asarray(meta["time_stamps"], np.float64)
        F = len(fid)
        K = np.zeros((F, 3, 3), np.float64)
        if Kraw.ndim == 2 and Kraw.shape[1] == 4:      # waymo [fx fy cx cy]
            K[:, 0, 0], K[:, 1, 1] = Kraw[:, 0], Kraw[:, 1]
            K[:, 0, 2], K[:, 1, 2] = Kraw[:, 2], Kraw[:, 3]
        else:                                          # nuscenes [3, 3]
            K[:] = Kraw[:, :3, :3]
        K[:, 2, 2] = 1.0
        widths = np.rint(K[:, 0, 2] * 2).astype(int)
        heights = np.rint(K[:, 1, 2] * 2).astype(int)
        is_val = np.asarray(list(meta["is_val_list"]), bool)

    stems = [f.split(".")[0] for f in img_files]
    return SceneMeta(
        dataset=dataset,
        K=np.asarray(K), R=np.asarray(R[:, :3, :3], np.float64),
        T=np.asarray(T[:, :3], np.float64), fid=fid, is_val=is_val,
        cam_id=np.arange(len(fid)) % num_cam,
        step=np.arange(len(fid)) // num_cam,
        image_paths=[os.path.join(path, "image", f) for f in img_files],
        semantic_paths=[os.path.join(path, "semantic", f"mask_{s}.npy")
                        for s in stems],
        sky_paths=[os.path.join(path, "sky", f"mask_{s}.npy")
                   for s in stems],
        width=widths, height=heights)
