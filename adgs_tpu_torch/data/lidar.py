"""Range-image LiDAR geometry on tensors (counterpart of
adgs_tpu/data/lidar.py, which is numpy; the port does not import it).

The substantive math of the Waymo converter — spherical range images to
world-frame point clouds with rolling-shutter per-pixel poses — kept
SDK-free so it is testable here and reusable by any range-image dataset.
Semantics match the reference's vendored Waymo utilities
(scripts/waymo/waymo.py:85-305: beam inclinations, extrinsic-yaw-corrected
azimuth sweep, polar->cartesian, sensor->vehicle, pixel-pose->world->
frame-vehicle); only the protobuf/tfrecord decoding stays behind the SDK
in scripts/convert_waymo.py.

The array functions run on their inputs' device in the dtypes numpy
computes in: float64 wherever the reference promotes to float64 (the
range image, the pose chain, every projection), float32 only where it
casts. A 4x4 pose inverse goes through numpy's LAPACK on the host
(`inv4`): `torch.linalg.inv` differs from it in the last bits of most
rigid transforms, and the camera matrices written to cameras.npz must be
the reference's bit for bit. `lidar_depth_map`'s duplicate pixels keep
the LATER point, as numpy's fancy assignment does, through an explicit
per-pixel argmax of the point index (a CUDA `index_put_` leaves the
winner undefined). The per-frame pose helpers (`quat_to_rotation`, `pose_rt`,
`nearest_by_timestamp`, `get_val_frames`) stay numpy on the host.

Conventions (Waymo Open Dataset):
  - range image rows sweep inclination TOP-DOWN (row 0 = max beam angle);
  - columns sweep azimuth from +pi (col 0) to -pi, centered on pixel
    middles and corrected by the sensor's extrinsic yaw;
  - vehicle frame: x forward, y left, z up; cameras use an OpenCV frame
    (x right, y down, z forward) via the OPENCV2DATASET flip.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# OpenCV camera axes expressed in the dataset/vehicle frame
# (scripts/waymo/waymo.py:323)
OPENCV2DATASET = np.array(
    [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]],
    dtype=np.float64)

F64 = torch.float64


def inv4(m: torch.Tensor) -> torch.Tensor:
    """np.linalg.inv of a float64 pose matrix, returned on m's device."""
    return torch.from_numpy(np.linalg.inv(
        m.detach().to("cpu", F64).numpy())).to(m.device)


def beam_inclinations(incl_min: float, incl_max: float, height: int,
                      device=None) -> torch.Tensor:
    """[H] uniform beam inclinations, row 0 = TOP beam (max angle).

    Pixel-centered interpolation over [min, max], then reversed into range
    image row order (waymo.py:131-139)."""
    up = ((0.5 + torch.arange(height, dtype=F64, device=device)) / height
          * (incl_max - incl_min) + incl_min)
    return up.flip(0)


def azimuths(width: int, extrinsic: torch.Tensor) -> torch.Tensor:
    """[W] pixel-centered azimuth sweep +pi -> -pi, yaw-corrected so column
    angles are measured in the VEHICLE frame's x-y plane."""
    az_correction = torch.atan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (torch.arange(width, 0, -1, dtype=F64,
                           device=extrinsic.device) - 0.5) / width
    return (ratios * 2.0 - 1.0) * np.pi - az_correction


def range_image_to_points(
    range_image: torch.Tensor,          # [H, W] ranges (<=0 -> no return)
    extrinsic: torch.Tensor,            # [4, 4] sensor -> vehicle
    inclinations: Optional[torch.Tensor] = None,  # [H]; else from min/max
    incl_min: Optional[float] = None,
    incl_max: Optional[float] = None,
    pixel_pose: Optional[torch.Tensor] = None,    # [H, W, 4, 4] pixel->world
    frame_pose: Optional[torch.Tensor] = None,    # [4, 4] vehicle->world
) -> torch.Tensor:
    """[N, 3] float32 vehicle-frame points for every pixel with range > 0.

    Mirrors extract_point_cloud_from_range_image (waymo.py:170-305): polar
    coordinates from the beam table and the azimuth sweep, cartesian in the
    SENSOR frame, rotated into the vehicle frame by the extrinsic; when the
    rolling-shutter per-pixel poses are given (TOP lidar), each point is
    carried pixel-pose -> world -> back into the frame_pose vehicle frame.
    """
    H, W = range_image.shape
    dev = range_image.device
    extrinsic = extrinsic.to(dev, F64)
    if inclinations is None:
        inclinations = beam_inclinations(incl_min, incl_max, H, dev)
    inclinations = inclinations.to(dev, F64)
    az = azimuths(W, extrinsic)

    cos_az = torch.cos(az)[None, :]
    sin_az = torch.sin(az)[None, :]
    cos_in = torch.cos(inclinations)[:, None]
    sin_in = torch.sin(inclinations)[:, None]
    r = range_image.to(F64)

    x = cos_az * cos_in * r
    y = sin_az * cos_in * r
    z = sin_in * r
    pts = torch.stack([x, y, z], dim=-1)                  # [H, W, 3] sensor

    R = extrinsic[:3, :3]
    t = extrinsic[:3, 3]
    pts = pts @ R.T + t                                   # vehicle frame

    if pixel_pose is not None:
        if frame_pose is None:
            raise ValueError("frame_pose must be set with pixel_pose")
        pixel_pose = pixel_pose.to(dev, F64)
        rot = pixel_pose[..., :3, :3]                     # [H, W, 3, 3]
        tr = pixel_pose[..., :3, 3]
        pts = (rot @ pts[..., None])[..., 0] + tr         # world
        w2v = inv4(frame_pose.to(dev, F64))
        pts = pts @ w2v[:3, :3].T + w2v[:3, 3]            # frame vehicle

    mask = range_image > 0
    return pts[mask].to(torch.float32)


def pixel_pose_matrices(rpy_xyz: torch.Tensor) -> torch.Tensor:
    """[H, W, 6] (roll, pitch, yaw, x, y, z) -> [H, W, 4, 4] float64
    transforms (the TOP lidar's per-pixel pose channel layout,
    waymo.py:116-128)."""
    rpy_xyz = rpy_xyz.to(F64)
    roll, pitch, yaw = (rpy_xyz[..., 0], rpy_xyz[..., 1], rpy_xyz[..., 2])
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    H, W = roll.shape
    out = torch.zeros((H, W, 4, 4), dtype=F64, device=rpy_xyz.device)
    # R = Rz(yaw) @ Ry(pitch) @ Rx(roll)
    out[..., 0, 0] = cy * cp
    out[..., 0, 1] = cy * sp * sr - sy * cr
    out[..., 0, 2] = cy * sp * cr + sy * sr
    out[..., 1, 0] = sy * cp
    out[..., 1, 1] = sy * sp * sr + cy * cr
    out[..., 1, 2] = sy * sp * cr - cy * sr
    out[..., 2, 0] = -sp
    out[..., 2, 1] = cp * sr
    out[..., 2, 2] = cp * cr
    out[..., :3, 3] = rpy_xyz[..., 3:6]
    out[..., 3, 3] = 1.0
    return out


def camera_world_to_cam(ego_to_world: torch.Tensor,
                        cam_extrinsic: torch.Tensor) -> torch.Tensor:
    """[4, 4] world -> OpenCV-camera matrix (waymo.py:399-400): the camera
    sits at ego_to_world @ extrinsic with dataset axes; flip to OpenCV and
    invert."""
    flip = torch.as_tensor(OPENCV2DATASET, device=ego_to_world.device)
    rt_inv = ego_to_world.to(F64) @ cam_extrinsic.to(F64) @ flip
    return inv4(rt_inv)


def project_points(points: torch.Tensor, K: torch.Tensor, RT: torch.Tensor,
                   width: int, height: int):
    """([N, 2] pixel uv, [N] depth, [N] in-image mask), float64 —
    waymo.py:405-411 (z > 0 and uv within [0, W-1] x [0, H-1])."""
    points, K, RT = points.to(F64), K.to(F64), RT.to(F64)
    cam = points @ RT[:3, :3].T + RT[:3, 3]
    depth = cam[:, 2]
    uvw = cam @ K.T
    uv = uvw[:, :2] / torch.clamp(uvw[:, 2:], min=1e-9)
    mask = ((depth > 0.0)
            & (uv[:, 0] >= 0.0) & (uv[:, 0] <= width - 1)
            & (uv[:, 1] >= 0.0) & (uv[:, 1] <= height - 1))
    return uv, depth, mask


def bilinear(image: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """[N, C] bilinear taps of image [H, W, C] at clipped float64 pixel
    coordinates (x, y), in float64 as numpy promotes a float32 image
    against float64 weights."""
    H, W = image.shape[:2]
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    img = image.to(F64)
    top = img[y0, x0] * (1 - wx) + img[y0, x1] * wx
    bot = img[y1, x0] * (1 - wx) + img[y1, x1] * wx
    return top * (1 - wy) + bot * wy


def sample_colors_aligned(image: torch.Tensor,
                          uv: torch.Tensor) -> torch.Tensor:
    """[N, 3] float64 bilinear colors with torch grid_sample(
    align_corners=True) parity for coordinates normalized by u/W*2-1
    (waymo.py:424-430): the effective sample location is
    uv * (size-1) / size."""
    H, W = image.shape[:2]
    x = torch.clamp(uv[:, 0] * (W - 1) / W, 0, W - 1)
    y = torch.clamp(uv[:, 1] * (H - 1) / H, 0, H - 1)
    return bilinear(image, x, y)


def last_writer(lin: torch.Tensor, size: int) -> torch.Tensor:
    """[size] index of the LAST entry of `lin` (flat pixel indices) that
    lands on each pixel, -1 where none does: numpy's fancy assignment
    `a[lin] = v` keeps the later value on a duplicate."""
    order = torch.arange(len(lin), device=lin.device)
    win = torch.full((size,), -1, dtype=torch.long, device=lin.device)
    return win.scatter_reduce_(0, lin, order, "amax", include_self=True)


def lidar_depth_map(uv: torch.Tensor, depth: torch.Tensor,
                    mask: torch.Tensor, width: int, height: int):
    """([H, W] float32 sparse depth, [H, W] validity) — waymo.py:412-419
    (nearest pixel rounding; later writes win ties, matching the reference
    order)."""
    dev = uv.device
    ij = torch.round(uv[mask]).to(torch.int32).long()
    win = last_writer(ij[:, 1] * width + ij[:, 0], height * width)
    hit = win >= 0
    depth_map = torch.zeros(height * width, dtype=torch.float32, device=dev)
    depth_map[hit] = depth[mask][win[hit]].to(torch.float32)
    return depth_map.view(height, width), hit.view(height, width)


def get_val_frames(num_frames: int, test_every: Optional[int] = None,
                   train_every: Optional[int] = None) -> set:
    """StreetGS split protocol (waymo.py:34-42)."""
    if train_every is None:
        return set(np.arange(test_every, num_frames, test_every).tolist())
    train = set(np.arange(0, num_frames, train_every).tolist())
    return (set(range(num_frames)) - train) if train_every > 1 else train


# ---------------------------------------------------------------------------
# quaternion-pose helpers (nuScenes metadata; scripts/nuscene/nuscene.py)
# ---------------------------------------------------------------------------

def quat_to_rotation(q: np.ndarray) -> np.ndarray:
    """[4] wxyz (any norm) -> [3, 3] (nuscene.py:27-41 build_rotation)."""
    q = np.asarray(q, np.float64)
    r, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
    ])


def pose_rt(rotation_quat, translation) -> np.ndarray:
    """(wxyz quat, xyz) -> [4, 4] rigid transform."""
    m = np.eye(4)
    m[:3, :3] = quat_to_rotation(rotation_quat)
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def nearest_by_timestamp(timestamps: np.ndarray, query: float) -> int:
    """Index of the closest timestamp (the lidar<->camera frequency
    alignment, nuscene.py:13-25/144-145)."""
    i = int(np.argmin(np.abs(np.asarray(timestamps, np.float64) - query)))
    return i
