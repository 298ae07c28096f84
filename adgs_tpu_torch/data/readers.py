"""Scene readers for the KITTI-MOT / Waymo / nuScenes data contracts
(counterpart of adgs_tpu/data/readers.py, numpy only; the camera helpers
come from the port's core/camera.py).

Parity with scene/dataset_readers.py:142-461. The three readers share one
engine (`read_scene`): per-frame images + priors (depth .npy, semantic/sky
masks, flow .npz packages), camera poses from the dataset's npz metadata,
train/test split, and a fused init point cloud built from the per-dataset
PLY with voxel-downsampled static points and randomly subsampled object
points. Sentinel files select the dataset (scene/__init__.py:48-58):
poses.npz -> KITTI, cameras.npz -> Waymo, meta.npz -> nuScenes.

open3d's voxel_down_sample is replaced by a numpy voxel-mean implementation
(`voxel_downsample`); PIL handles images; flow packages keep the reference
list-of-[time, K, R, T, flow(2HW), vis(HW)] layout.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from ..core.camera import focal2fov, world_to_view
from .ply import fetch_point_cloud


class FrameInfo(NamedTuple):
    uid: int
    cam_id: int
    fid: float
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    width: int
    height: int
    time: float
    image_path: str
    depth: Optional[np.ndarray]
    semantic: Optional[np.ndarray]
    sky: Optional[np.ndarray]
    flow: Optional[list]     # list of [time, K, R, T, flow(2HW), vis(HW)]
    image_name: str


class SceneData(NamedTuple):
    points: np.ndarray       # [N,3]
    colors: np.ndarray       # [N,3] in [0,1]
    times: np.ndarray        # [N]
    obj_id: np.ndarray       # [N]
    train_frames: list
    test_frames: list
    cameras_extent: float
    scene_extent: float
    frame_gap: float
    bound: tuple


def get_val_frames(num_frames: int, test_every=None, train_every=None):
    """dataset_readers.py:60-68."""
    assert train_every is None or test_every is None
    if train_every is None:
        val = set(np.arange(test_every, num_frames, test_every))
    else:
        train = set(np.arange(0, num_frames, train_every))
        val = (set(np.arange(num_frames)) - train) if train_every > 1 else train
    return sorted(val)


def nerfpp_norm_radius(frames: list) -> float:
    """getNerfppNorm (dataset_readers.py:70-91): 1.1 x max distance of camera
    centers from their mean."""
    centers = []
    for f in frames:
        w2c = world_to_view(f.R, f.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, axis=1)
    dist = np.linalg.norm(centers - centers.mean(axis=1, keepdims=True), axis=0)
    return float(np.max(dist) * 1.1)


def voxel_downsample(points: np.ndarray, colors: np.ndarray,
                     voxel_size: float):
    """open3d voxel_down_sample semantics: mean of points/colors per voxel."""
    if len(points) == 0:
        return points, colors
    keys = np.floor(points / voxel_size).astype(np.int64)
    # hash voxel coords
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    n_vox = counts.shape[0]
    psum = np.zeros((n_vox, 3))
    csum = np.zeros((n_vox, 3))
    np.add.at(psum, inv, points)
    np.add.at(csum, inv, colors)
    return ((psum / counts[:, None]).astype(np.float32),
            (csum / counts[:, None]).astype(np.float32))


_DATASET_SPECS = {
    # sentinel -> (meta file, voxel size, obj keep fraction, default num_cam)
    "kitti": ("poses.npz", 0.5, 0.1, 2),
    "waymo": ("cameras.npz", 0.2, 0.3, 1),
    "nuscenes": ("meta.npz", 0.15, 0.5, 3),
}


def detect_dataset(path: str) -> str:
    """scene/__init__.py:48-58 sentinel detection."""
    for name, (meta, *_rest) in _DATASET_SPECS.items():
        if os.path.exists(os.path.join(path, meta)):
            return name
    raise ValueError(f"could not recognize scene type at {path}")


def _frame_paths(path: str, img_file: str, dataset: str, split_mode: str):
    stem = img_file.split(".")[0]
    flow_dir = (os.path.join(path, "flow", split_mode) if dataset == "kitti"
                else os.path.join(path, "flow"))
    return dict(
        image=os.path.join(path, "image", img_file),
        depth=os.path.join(path, "depth", stem + ".npy"),
        flow=os.path.join(flow_dir, stem + ".npz"),
        semantic=os.path.join(path, "semantic", "mask_" + stem + ".npy"),
        sky=os.path.join(path, "sky", "mask_" + stem + ".npy"),
    )


def read_scene(path: str, use_colmap: bool = True, split_mode: str = "nvs-75",
               num_cam: Optional[int] = None, load_priors: bool = True,
               seed: int = 0) -> SceneData:
    dataset = detect_dataset(path)
    meta_file, voxel, obj_frac, default_cams = _DATASET_SPECS[dataset]
    num_cam = num_cam if num_cam is not None else default_cams
    meta = np.load(os.path.join(path, meta_file), allow_pickle=True)

    if dataset == "kitti":
        time_stamps = meta["time_stamp"]
        R, T = meta["R"], meta["T"]
        height, width = int(meta["height"]), int(meta["width"])
        focal = float(meta["focal"])
        fovx = [focal2fov(focal, width)] * len(time_stamps)
        fovy = [focal2fov(focal, height)] * len(time_stamps)
        sizes = [(width, height)] * len(time_stamps)
    else:
        time_stamps = meta["time_stamps"]
        R, T, K = meta["R"], meta["T"], meta["K"]
        fovx, fovy, sizes = [], [], []
        for i in range(len(time_stamps)):
            if dataset == "waymo":
                fx, fy, cx, cy = K[i, 0], K[i, 1], K[i, 2], K[i, 3]
            else:
                fx, fy, cx, cy = K[i, 0, 0], K[i, 1, 1], K[i, 0, 2], K[i, 1, 2]
            fovx.append(focal2fov(fx, cx * 2))
            fovy.append(focal2fov(fy, cy * 2))
            sizes.append((int(round(cx * 2)), int(round(cy * 2))))

    frame_gap = num_cam / time_stamps.shape[0]
    t_min, t_max = float(np.min(time_stamps)), float(np.max(time_stamps))
    scale_t = lambda x: (x - t_min) / (t_max - t_min)  # noqa: E731

    # train/test split
    if dataset == "kitti":
        if split_mode == "nvs-25":
            i_test = set(get_val_frames(len(time_stamps) // num_cam,
                                        train_every=4))
            frame_gap *= 4
        elif split_mode == "nvs-50":
            i_test = set(get_val_frames(len(time_stamps) // num_cam,
                                        test_every=2))
            frame_gap *= 2
        elif split_mode == "nvs-75":
            i_test = set(get_val_frames(len(time_stamps) // num_cam,
                                        test_every=4))
        else:
            raise ValueError("no such split: " + split_mode)
        is_val = [idx // num_cam in i_test for idx in range(len(time_stamps))]
    else:
        is_val = list(meta["is_val_list"])

    img_files = sorted(os.listdir(os.path.join(path, "image")))
    train_frames, test_frames = [], []
    for idx, (img_file, fid) in enumerate(zip(img_files, time_stamps)):
        p = _frame_paths(path, img_file, dataset, split_mode)
        flow = None
        depth = semantic = sky = None
        if load_priors:
            if os.path.exists(p["depth"]):
                depth = np.load(p["depth"])
                if depth.ndim == 3:
                    depth = depth.squeeze(-1)
            if os.path.exists(p["semantic"]):
                semantic = np.load(p["semantic"]).astype(np.int32)
            if os.path.exists(p["sky"]):
                sky = np.load(p["sky"]) != 0
            if os.path.exists(p["flow"]):
                flow = list(np.load(p["flow"], allow_pickle=True)["flow"])
                for pkg in flow:
                    pkg[0] = scale_t(pkg[0])
        if dataset == "kitti":
            w, h = width, height
            fvx, fvy = fovx[idx], fovy[idx]
        else:
            w, h = sizes[idx]
            fvx, fvy = fovx[idx], fovy[idx]
        fr = FrameInfo(
            uid=idx, cam_id=idx % num_cam, fid=float(fid),
            R=R[idx, :3, :3], T=T[idx, :3], fovx=fvx, fovy=fvy,
            width=w, height=h, time=float(scale_t(fid)),
            image_path=p["image"], depth=depth, semantic=semantic, sky=sky,
            flow=flow, image_name=os.path.basename(p["image"]))
        (test_frames if is_val[idx] else train_frames).append(fr)

    cameras_extent = nerfpp_norm_radius(train_frames)

    # init point cloud
    if dataset == "kitti":
        ply_path = os.path.join(path, f"points3d-{split_mode[-2:]}.ply")
        colmap_path = os.path.join(path, f"colmap-{split_mode[-2:]}.ply")
    else:
        ply_path = os.path.join(path, "points3d.ply")
        colmap_path = os.path.join(path, "colmap.ply")
    xyz, rgb, tim, obj_id = fetch_point_cloud(ply_path)
    bound = (xyz.min(axis=0), xyz.max(axis=0))
    tim = scale_t(tim)
    if use_colmap:
        assert os.path.exists(colmap_path), f"no SfM cloud: {colmap_path}"
        cxyz, crgb, _, _ = fetch_point_cloud(colmap_path)
        xyz = np.concatenate([xyz, cxyz])
        rgb = np.concatenate([rgb, crgb])
        tim = np.concatenate([tim, np.full(len(cxyz), -1.0, np.float32)])
        obj_id = np.concatenate([obj_id, np.zeros(len(cxyz), np.float32)])

    scene_sel = obj_id <= 0.5
    obj_sel = ~scene_sel
    s_xyz, s_rgb = voxel_downsample(xyz[scene_sel], rgb[scene_sel], voxel)
    o_xyz, o_rgb = xyz[obj_sel], rgb[obj_sel]
    o_tim, o_id = tim[obj_sel], obj_id[obj_sel]
    rng = np.random.default_rng(seed)
    keep = rng.permutation(len(o_xyz))[: int(len(o_xyz) * obj_frac)]
    o_xyz, o_rgb, o_tim, o_id = o_xyz[keep], o_rgb[keep], o_tim[keep], o_id[keep]

    points = np.concatenate([s_xyz, o_xyz]).astype(np.float32)
    colors = np.concatenate([s_rgb, o_rgb]).astype(np.float32)
    times = np.concatenate([np.full(len(s_xyz), -1.0, np.float32), o_tim])
    obj_out = np.concatenate([np.zeros(len(s_xyz), np.float32), o_id])
    scene_extent = float(np.linalg.norm(bound[1] - bound[0]))

    return SceneData(
        points=points, colors=colors, times=times, obj_id=obj_out,
        train_frames=train_frames, test_frames=test_frames,
        cameras_extent=cameras_extent, scene_extent=scene_extent,
        frame_gap=float(frame_gap), bound=bound)
