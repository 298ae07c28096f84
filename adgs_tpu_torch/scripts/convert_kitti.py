"""KITTI-MOT -> adgs_tpu scene converter (the port's counterpart of
scripts/convert_kitti.py; the sweeps' projection, color sampling and
world transform run on a torch device).

Capability parity with scripts/kitti/kitti.py: OXTS mercator pose chain,
stereo cameras from the tracking calib (P2/P3 re-based to a shared pinhole
K), per-frame LiDAR sweeps colored by bilinear stereo image sampling and
transformed to the world frame with per-point timestamps, split-specific
init clouds, and poses.npz in the reader contract
(scene/dataset_readers.py:142-259).

The pose chain stays numpy on the host (4x4 per frame), so poses.npz is
the reference script's bit for bit. Each float32 sweep meets float64
matrices, so the device work is float64, as numpy promotes it. The
down-sampling permutation and the random colours are drawn from numpy's
`default_rng(seed)` in the reference's order.

  python -m adgs_tpu_torch.scripts.convert_kitti <kitti_tracking_root> \\
      <out_root> 0001 --first_frame 380 --last_frame 431 --use_color \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch
from PIL import Image

from .._device import resolve_device
from ..data.lidar import bilinear
from ..data.ply import store_point_cloud

F64 = torch.float64


def rotation_from_rpy(roll, pitch, heading):
    sh, ch = np.sin(heading), np.cos(heading)
    sp, cp = np.sin(pitch), np.cos(pitch)
    sr, cr = np.sin(roll), np.cos(roll)
    rz = np.array([[ch, -sh, 0], [sh, ch, 0], [0, 0, 1]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return rz @ ry @ rx


def get_val_frames(num_frames, test_every=None, train_every=None):
    if train_every is None:
        return set(np.arange(test_every, num_frames, test_every))
    train = set(np.arange(0, num_frames, train_every))
    return (set(np.arange(num_frames)) - train) if train_every > 1 else train


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """[H,W,3] image, [N,2] pixel coords -> [N,3] float64 (align_corners
    grid_sample analog)."""
    H, W = img.shape[:2]
    x = torch.clamp(uv[:, 0], 0, W - 1)
    y = torch.clamp(uv[:, 1], 0, H - 1)
    return bilinear(img, x, y)


def project_sweep(P: torch.Tensor, vel: torch.Tensor, W: int, H: int):
    """(uv [N, 2], in-image mask [N]) of homogeneous sweep points
    vel [N, 4] under the float64 [3, 4] projection P (P @ T_rect @
    T_velo2cam)."""
    proj = (P @ vel.to(F64).T).T
    m = proj[:, 2] > 0
    uv = proj[:, :2] / torch.clamp(proj[:, 2:], min=1e-9)
    m &= ((uv[:, 0] >= 0) & (uv[:, 0] <= W - 1)
          & (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1))
    return uv, m


def load_image(path: str, device) -> torch.Tensor:
    """[H, W, 3] float32 in [0, 1], as np.asarray(...) / 255.0."""
    with Image.open(path) as im:
        arr = np.asarray(im, np.float32)
    return torch.as_tensor(arr, device=device) / 255.0


def colour_sweep(vel, cams, W, H, use_color, device):
    """(color [N, 3] float32, mask [N]): the sweep's in-view mask over the
    stereo pair and, with use_color, its colour averaged over the views
    that see each point; cams: ((P_full, image path), ...)."""
    color = torch.zeros((len(vel), 3), dtype=torch.float32, device=device)
    masks = []
    for P, path in cams:
        uv, m = project_sweep(P, vel, W, H)
        masks.append(m)
        if use_color:
            img = load_image(path, device)
            color[m] = (color[m].to(F64) + bilinear_sample(img, uv[m])
                        ).to(torch.float32)
    mask = masks[0] | masks[1]
    denom = torch.clamp(masks[0].to(torch.float32)
                        + masks[1].to(torch.float32), min=1)
    return color / denom[:, None], mask


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("scene")
    p.add_argument("--part", default="training")
    p.add_argument("--first_frame", default=65, type=int)
    p.add_argument("--last_frame", default=120, type=int)
    p.add_argument("--downsample_ratio", "-r", default=1.0, type=float)
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the card unless given (e.g. cpu)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    src, scene = args.src, args.scene
    dst = os.path.join(args.dst, scene)
    left_dir = os.path.join(src, "data_tracking_image_2", args.part,
                            "image_02", scene)
    right_dir = os.path.join(src, "data_tracking_image_3", args.part,
                             "image_03", scene)
    oxts_path = os.path.join(src, "data_tracking_oxts", args.part, "oxts",
                             scene + ".txt")
    calib_path = os.path.join(src, "data_tracking_calib", args.part, "calib",
                              scene + ".txt")
    velo_dir = os.path.join(src, "data_tracking_velodyne", args.part,
                            "velodyne", scene)
    for path in (left_dir, right_dir, oxts_path, calib_path, velo_dir):
        if not os.path.exists(path):
            raise FileNotFoundError(f"Cannot find: {path}")
    os.makedirs(os.path.join(dst, "image"), exist_ok=True)

    calibs = []
    with open(calib_path) as f:
        for line in f.read().splitlines():
            calibs.append(np.array([float(v) for v in line.split()[1:]]))
    P2 = calibs[2].reshape(3, 4)
    P3 = calibs[3].reshape(3, 4)
    T_rect = np.eye(4)
    T_rect[:3, :3] = calibs[4].reshape(3, 3)
    T_velo2cam = np.concatenate([calibs[5].reshape(3, 4),
                                 [[0, 0, 0, 1.0]]], axis=0)
    T_imu2velo = np.concatenate([calibs[6].reshape(3, 4),
                                 [[0, 0, 0, 1.0]]], axis=0)
    T_imu2cam = T_rect @ T_velo2cam @ T_imu2velo

    focal = P2[0, 0]
    first = sorted(os.listdir(left_dir))[0]
    with Image.open(os.path.join(left_dir, first)) as im:
        W, H = im.size
    K = np.array([[focal, 0, W / 2.0], [0, focal, H / 2.0], [0, 0, 1.0]])
    camrect_cam2 = np.linalg.inv(K) @ P2
    camrect_cam3 = np.linalg.inv(K) @ P3
    # the reference's (P @ T_rect @ T_velo2cam) @ vel.T, left to right
    P2_full = torch.as_tensor(P2 @ T_rect @ T_velo2cam, device=dev)
    P3_full = torch.as_tensor(P3 @ T_rect @ T_velo2cam, device=dev)
    imu2velo_inv = np.linalg.inv(T_imu2velo)

    nf = args.last_frame - args.first_frame + 1
    splits = {"75": get_val_frames(nf, test_every=4),
              "50": get_val_frames(nf, test_every=2),
              "25": get_val_frames(nf, train_every=4)}
    pcds = {k: [] for k in splits}
    cols = {k: [] for k in splits}

    oxts = np.loadtxt(oxts_path)
    scale = np.cos(oxts[0][0] * np.pi / 180)
    rng = np.random.default_rng(args.seed)
    RT, time_stamp, rt_0 = [], [], None

    frames = sorted(os.listdir(left_dir))
    for idx, fname in enumerate(frames):
        if idx < args.first_frame or idx > args.last_frame:
            continue
        fi = idx - args.first_frame
        shutil.copyfile(os.path.join(left_dir, fname),
                        os.path.join(dst, "image", f"{2 * fi:06d}.png"))
        shutil.copyfile(os.path.join(right_dir, fname),
                        os.path.join(dst, "image", f"{2 * fi + 1:06d}.png"))

        o = oxts[idx]
        r_earth = 6378137.0
        x = scale * r_earth * (np.pi * o[1]) / 180
        y = scale * r_earth * np.log(np.tan((np.pi * (90 + o[0])) / 360))
        rt_inv = np.eye(4)
        rt_inv[:3] = np.concatenate(
            [rotation_from_rpy(o[3], o[4], o[5]),
             np.array([x, y, o[2]])[:, None]], axis=-1)
        if rt_0 is None:
            rt_0 = np.linalg.inv(rt_inv)
        rt_inv = rt_0 @ rt_inv
        rt = T_imu2cam @ np.linalg.inv(rt_inv)
        RT.append(camrect_cam2 @ rt)
        RT.append(camrect_cam3 @ rt)
        time_stamp += [fi, fi]

        vel = np.fromfile(os.path.join(velo_dir, f"{idx:06d}.bin"),
                          dtype=np.float32).reshape(-1, 4)
        vel[:, 3] = 1.0
        vel = torch.as_tensor(vel, device=dev)
        color, mask = colour_sweep(
            vel, ((P2_full, os.path.join(left_dir, fname)),
                  (P3_full, os.path.join(right_dir, fname))),
            W, H, args.use_color, dev)

        world = torch.as_tensor(rt_inv @ imu2velo_inv, device=dev)
        pts = (world @ vel[mask].to(F64).T).T[:, :3]
        color = color[mask]
        if args.downsample_ratio < 1.0:
            keep = rng.permutation(len(pts))[
                : int(len(pts) * args.downsample_ratio)]
            keep = torch.as_tensor(keep, device=dev)
            pts, color = pts[keep], color[keep]
        if not args.use_color:
            color = torch.as_tensor(
                rng.random((len(pts), 3)).astype(np.float32), device=dev)
        pts, color = pts.cpu().numpy(), color.cpu().numpy()
        rec = np.concatenate(
            [pts, np.full((len(pts), 1), fi, np.float32)], axis=-1)
        for k, i_test in splits.items():
            if fi not in i_test:
                pcds[k].append(rec)
                cols[k].append(color)

    RT = np.stack(RT)
    np.savez(os.path.join(dst, "poses.npz"),
             R=RT[:, :3, :3], T=RT[:, :3, 3], focal=focal,
             height=H, width=W,
             time_stamp=np.array(time_stamp, np.float64))
    for k in splits:
        pc = np.concatenate(pcds[k])
        cc = np.concatenate(cols[k])
        store_point_cloud(os.path.join(dst, f"points3d-{k}.ply"),
                          pc[:, :3], cc * 255.0, times=pc[:, 3])
        print(f"points3d-{k}.ply: {len(pc)} points")
    print("Images and poses:", RT.shape[0])


if __name__ == "__main__":
    main()
