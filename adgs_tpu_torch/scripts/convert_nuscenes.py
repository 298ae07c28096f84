"""nuScenes -> adgs_tpu scene converter (SDK-FREE; the port's counterpart
of scripts/convert_nuscenes.py, its projections, colours and depth maps
on a torch device).

Capability parity with the reference's scripts/nuscene/nuscene.py:73-275 —
quaternion pose chains rebased to the first frame, nearest-lidar-by-
timestamp alignment of the 20Hz lidar with the 12Hz cameras, 3-front-camera
extraction, train-view color averaging with align-corners sampling,
optional sparse lidar depth maps, every-4th-frame val split, and meta.npz +
image/ + points3d.ply in the reader contract.

Unlike the reference (which needs the nuscenes devkit in a dedicated env),
this reads the dataset's plain-JSON metadata tables directly
(scene/sample_data/ego_pose/calibrated_sensor/sensor.json) — zero extra
dependencies. All geometry lives in adgs_tpu_torch.data.lidar; the
quaternion pose chains stay numpy on the host, so meta.npz is the
reference script's bit for bit.

  python -m adgs_tpu_torch.scripts.convert_nuscenes <dataroot> <dst> \\
      <scene-name> [--version v1.0-trainval] [--first_frame 10] \\
      [--last_frame 69] [--use_color] [--use_depth] [-r 1.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np
import torch

from .._device import resolve_device
from ..data import lidar
from ..data.ply import store_point_cloud

F64 = torch.float64
SENSORS = ["CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT"]


def load_table(root, version, name):
    with open(os.path.join(root, version, name + ".json")) as f:
        rows = json.load(f)
    return {r["token"]: r for r in rows}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("scene")
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--first_frame", type=int, default=10)
    p.add_argument("--last_frame", type=int, default=69)
    p.add_argument("--downsample_ratio", "-r", type=float, default=1.0)
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_depth", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the card unless given (e.g. cpu)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    from PIL import Image

    src, version = args.src, args.version
    dst = os.path.join(args.dst, args.scene)
    os.makedirs(os.path.join(dst, "image"), exist_ok=True)
    if args.use_depth:
        os.makedirs(os.path.join(dst, "lidar_depth"), exist_ok=True)

    scenes = load_table(src, version, "scene")
    samples = load_table(src, version, "sample")
    sample_data = load_table(src, version, "sample_data")
    ego_poses = load_table(src, version, "ego_pose")
    calib = load_table(src, version, "calibrated_sensor")
    sensors = load_table(src, version, "sensor")

    scene = next((s for s in scenes.values() if s["name"] == args.scene),
                 None)
    if scene is None:
        raise ValueError(f"Cannot find scene: {args.scene}")
    first_sample = samples[scene["first_sample_token"]]

    def channel_of(sd):
        return sensors[calib[sd["calibrated_sensor_token"]]
                       ["sensor_token"]]["channel"]

    # entry sample_data per channel for the scene's first sample
    by_channel = {}
    for sd in sample_data.values():
        if sd["sample_token"] == first_sample["token"] and sd.get(
                "is_key_frame", True):
            by_channel.setdefault(channel_of(sd), sd)

    # full 20Hz lidar stream (for nearest-timestamp alignment)
    lidar_iter = by_channel["LIDAR_TOP"]
    lidar_stream = [lidar_iter]
    while lidar_iter["next"]:
        lidar_iter = sample_data[lidar_iter["next"]]
        lidar_stream.append(lidar_iter)
    lidar_ts = np.array([x["timestamp"] for x in lidar_stream], np.float64)
    order = np.argsort(lidar_ts)
    lidar_ts = lidar_ts[order]
    lidar_stream = [lidar_stream[i] for i in order]

    cams_iter = [by_channel[c] for c in SENSORS]
    n_frames = args.last_frame - args.first_frame + 1
    val_set = lidar.get_val_frames(n_frames, test_every=4)
    rng = np.random.default_rng(args.seed)

    global2ego0 = None
    Ks, Rs, Ts, stamps, is_val_list = [], [], [], [], []
    pointcloud, pcd_rgb = [], []

    for idx in range(args.last_frame + 1):
        if idx < args.first_frame:
            cams_iter = [sample_data[c["next"]] for c in cams_iter]
            continue
        t_rel = idx - args.first_frame
        is_val = t_rel in val_set

        li = lidar_stream[lidar.nearest_by_timestamp(
            lidar_ts, cams_iter[0]["timestamp"])]
        pts = np.fromfile(os.path.join(src, li["filename"]),
                          dtype=np.float32).reshape(-1, 5)[:, :3]
        l2e = calib[li["calibrated_sensor_token"]]
        ego = ego_poses[li["ego_pose_token"]]
        e2g = lidar.pose_rt(ego["rotation"], ego["translation"])
        if global2ego0 is None:
            global2ego0 = np.linalg.inv(e2g)
        e2g = global2ego0 @ e2g
        pts = torch.as_tensor(pts, device=dev).to(F64)
        l2e_r = torch.as_tensor(lidar.quat_to_rotation(l2e["rotation"]),
                                device=dev)
        pts = pts @ l2e_r.T + torch.as_tensor(
            np.asarray(l2e["translation"], np.float64), device=dev)
        e2g_t = torch.as_tensor(e2g, device=dev)
        pts = pts @ e2g_t[:3, :3].T + e2g_t[:3, 3]

        total_mask = torch.zeros(len(pts), dtype=torch.bool, device=dev)
        colors = torch.zeros((len(pts), 3), dtype=torch.float32, device=dev)
        counts = torch.zeros(len(pts), dtype=torch.float32, device=dev)

        for data in cams_iter:
            image_id = len(Ks)
            img_src = os.path.join(src, data["filename"])
            img_dst = os.path.join(dst, "image", f"{image_id:06d}.png")
            shutil.copyfile(img_src, img_dst)

            cs = calib[data["calibrated_sensor_token"]]
            K = np.array(cs["camera_intrinsic"], np.float64)
            cam_ego = ego_poses[data["ego_pose_token"]]
            cam_e2g = global2ego0 @ lidar.pose_rt(
                cam_ego["rotation"], cam_ego["translation"])
            c2e = lidar.pose_rt(cs["rotation"], cs["translation"])
            RT = np.linalg.inv(cam_e2g @ c2e)
            Ks.append(K)
            Rs.append(RT[:3, :3])
            Ts.append(RT[:3, 3])
            stamps.append(t_rel)
            is_val_list.append(is_val)

            W, H = data["width"], data["height"]
            uv, depth, mask = lidar.project_points(
                pts, torch.as_tensor(K, device=dev),
                torch.as_tensor(RT, device=dev), W, H)
            if args.use_depth:
                dmap, dmask = lidar.lidar_depth_map(uv, depth, mask, W, H)
                np.savez(os.path.join(dst, "lidar_depth",
                                      f"{image_id:06d}.npz"),
                         depth=dmap.cpu().numpy(), mask=dmask.cpu().numpy())
            if not is_val:
                total_mask |= mask
                if args.use_color:
                    with Image.open(img_src) as im:
                        img = torch.as_tensor(np.asarray(im, np.float32),
                                              device=dev) / 255.0
                    colors[mask] = (colors[mask].to(F64)
                                    + lidar.sample_colors_aligned(
                                        img[..., :3], uv[mask])
                                    ).to(torch.float32)
                    counts += mask.to(torch.float32)

        if not is_val:
            sel = pts[total_mask]
            col = colors[total_mask]
            cnt = counts[total_mask]
            if args.downsample_ratio < 1.0:
                keep = rng.permutation(len(sel))[
                    :int(len(sel) * args.downsample_ratio)]
                keep = torch.as_tensor(keep, device=dev)
                sel, col, cnt = sel[keep], col[keep], cnt[keep]
            if args.use_color:
                col = col / torch.clamp(cnt, min=1.0)[:, None] * 255.0
            else:
                col = torch.as_tensor(
                    rng.random((len(sel), 3)).astype(np.float32) * 255.0,
                    device=dev)
            sel = sel.cpu().numpy()
            pointcloud.append(np.concatenate(
                [sel, np.full((len(sel), 1), t_rel, np.float32)], axis=-1))
            pcd_rgb.append(col.cpu().numpy())

        if idx < args.last_frame:
            cams_iter = [sample_data[c["next"]] for c in cams_iter]

    pc = np.concatenate(pointcloud)
    store_point_cloud(os.path.join(dst, "points3d.ply"), pc[:, :3],
                      np.concatenate(pcd_rgb), times=pc[:, 3])
    np.savez(os.path.join(dst, "meta.npz"),
             K=np.stack(Ks), R=np.stack(Rs), T=np.stack(Ts),
             time_stamps=np.array(stamps, np.float32),
             is_val_list=np.array(is_val_list, bool))
    print(f"PCD {pc.shape}; images/RTs {len(Rs)} -> {dst}")


if __name__ == "__main__":
    main()
