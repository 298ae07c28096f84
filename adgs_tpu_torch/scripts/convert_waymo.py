"""Waymo Open Dataset -> adgs_tpu scene converter (the port's counterpart
of scripts/convert_waymo.py; the range images, projections, colours and
depth maps run on a torch device).

Capability parity with the reference's scripts/waymo/waymo.py:308-472: ego
poses rebased to the first frame, per-camera world->cam matrices through
the OpenCV axis flip, rolling-shutter-corrected TOP-lidar extraction,
per-point frame timestamps, train-view color averaging via align-corners
sampling, optional sparse lidar depth maps, every-4th-frame val split, and
cameras.npz + image/ + points3d.ply in the reader contract
(scene/dataset_readers.py:261-357).

ALL geometry runs in adgs_tpu_torch.data.lidar. The tfrecord framing +
Frame proto decode is STANDALONE by default (adgs_tpu_torch.data.tfrecord
+ adgs_tpu_torch.data.waymo_proto — no tensorflow, no SDK); when the
waymo-open-dataset SDK happens to be installed it is used instead (exact
upstream schema, same downstream loop). The per-frame 4x4 ego poses stay
numpy on the host; the random draws come from numpy's `default_rng(seed)`
in the reference's order.

  python -m adgs_tpu_torch.scripts.convert_waymo <segment.tfrecord> <dst> \\
      [--first_frame 0] [--last_frame -1] [--select_camera 0] \\
      [--use_color] [--use_depth] [-r 1.0] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .._device import resolve_device
from ..data import lidar
from ..data import waymo_proto as wp
from ..data.ply import store_point_cloud

F64 = torch.float64


def _from_sdk(pb, dataset_pb2, zlib) -> wp.Frame:
    """SDK proto -> the standalone Frame dataclasses (shared loop)."""
    def mat(blob):
        if not blob:
            return None
        m = dataset_pb2.MatrixFloat()
        m.ParseFromString(zlib.decompress(blob))
        return np.array(m.data, np.float32).reshape(tuple(m.shape.dims))

    fr = wp.Frame(pose=np.array(pb.pose.transform).reshape(4, 4),
                  timestamp_micros=pb.timestamp_micros)
    for c in pb.context.camera_calibrations:
        fr.camera_calibrations.append(wp.CameraCalibration(
            name=c.name, intrinsic=np.array(c.intrinsic),
            extrinsic=np.array(c.extrinsic.transform).reshape(4, 4),
            width=c.width, height=c.height))
    for c in pb.context.laser_calibrations:
        fr.laser_calibrations.append(wp.LaserCalibration(
            name=c.name, beam_inclinations=np.array(c.beam_inclinations),
            beam_inclination_min=c.beam_inclination_min,
            beam_inclination_max=c.beam_inclination_max,
            extrinsic=np.array(c.extrinsic.transform).reshape(4, 4)))
    for im in pb.images:
        fr.images.append(wp.CameraImage(name=im.name, image=im.image))
    for la in pb.lasers:
        fr.lasers.append(wp.Laser(
            name=la.name,
            range_image=mat(la.ri_return1.range_image_compressed),
            range_image_pose=mat(
                la.ri_return1.range_image_pose_compressed)))
    return fr


def load_frames(path: str):
    """Decoded Frame dataclasses — SDK when present, standalone codec
    otherwise (byte-identical tfrecord framing + proto wire format)."""
    try:
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2
    except ImportError:
        from ..data import tfrecord
        return [wp.decode_frame(rec) for rec in tfrecord.read_records(path)]
    import zlib
    frames = []
    for data in tf.data.TFRecordDataset(path, compression_type=""):
        pb = dataset_pb2.Frame()
        pb.ParseFromString(bytearray(data.numpy()))
        frames.append(_from_sdk(pb, dataset_pb2, zlib))
    return frames


def decode_range_images(frame: wp.Frame):
    """laser_name -> [H,W] first-return ranges, plus the TOP lidar's
    per-pixel pose tensor."""
    out = {}
    top_pose = None
    for laser in frame.lasers:
        if laser.range_image is None:
            continue
        out[laser.name] = laser.range_image[..., 0]   # channel 0 = range
        if laser.name == wp.LASER_TOP:
            top_pose = laser.range_image_pose        # [H, W, 6] rpy + xyz
    return out, top_pose


def frame_points(frame: wp.Frame, ego0_inv: np.ndarray,
                 ego_to_world: np.ndarray, device) -> torch.Tensor:
    """[N, 3] float64 rebased-world points of every laser of the frame,
    the TOP lidar's rolling-shutter poses applied; None for a camera-only
    frame."""
    range_images, top_pose_raw = decode_range_images(frame)
    if top_pose_raw is None:
        return None

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    ego = t(ego_to_world)
    # per-pixel poses are stored in the ORIGINAL world frame; rebase
    top_pose = lidar.pixel_pose_matrices(t(top_pose_raw).to(F64))
    top_pose = t(ego0_inv) @ top_pose

    points = []
    for calib in sorted(frame.laser_calibrations, key=lambda c: c.name):
        if calib.name not in range_images:
            continue
        incl = (t(np.array(calib.beam_inclinations)[::-1].copy())
                if len(calib.beam_inclinations) else None)
        is_top = calib.name == wp.LASER_TOP
        points.append(lidar.range_image_to_points(
            t(range_images[calib.name]), t(calib.extrinsic),
            inclinations=incl,
            incl_min=calib.beam_inclination_min,
            incl_max=calib.beam_inclination_max,
            pixel_pose=top_pose if is_top else None,
            frame_pose=ego if is_top else None))
    points = torch.cat(points, dim=0).to(F64)
    return points @ ego[:3, :3].T + ego[:3, 3]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tfrecord")
    p.add_argument("dst")
    p.add_argument("--first_frame", type=int, default=0)
    p.add_argument("--last_frame", type=int, default=-1)
    p.add_argument("--select_camera", type=int, nargs="+", default=[0],
                   help="0=FRONT 1=FRONT_LEFT 2=FRONT_RIGHT 3=SIDE_LEFT "
                        "4=SIDE_RIGHT (proto name minus one)")
    p.add_argument("--downsample_ratio", "-r", type=float, default=1.0)
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--use_depth", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the card unless given (e.g. cpu)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from PIL import Image

    os.makedirs(os.path.join(args.dst, "image"), exist_ok=True)
    if args.use_depth:
        os.makedirs(os.path.join(args.dst, "lidar_depth"), exist_ok=True)

    frames_raw = load_frames(args.tfrecord)
    last = args.last_frame if args.last_frame != -1 else len(frames_raw) - 1
    n_frames = last - args.first_frame + 1
    val_set = lidar.get_val_frames(n_frames, test_every=4)

    rng = np.random.default_rng(args.seed)
    ego0_inv = None
    Ks, Rs, Ts, stamps, is_val_list = [], [], [], [], []
    pcd, pcd_rgb = [], []

    for fid, frame in enumerate(frames_raw):
        if fid < args.first_frame or fid > last:
            continue
        t_rel = fid - args.first_frame
        ego_to_world = frame.pose
        if ego0_inv is None:
            ego0_inv = np.linalg.inv(ego_to_world)
        ego_to_world = ego0_inv @ ego_to_world  # rebase to frame 0
        is_val = t_rel in val_set

        points = frame_points(frame, ego0_inv, ego_to_world, dev)
        if points is None:
            print(f"frame {fid}: camera-only segment, no lidar; skipped")
            continue

        mask_total = torch.zeros(len(points), dtype=torch.bool, device=dev)
        colors = torch.zeros((len(points), 3), dtype=torch.float32,
                             device=dev)
        counts = torch.zeros(len(points), dtype=torch.float32, device=dev)
        for img_msg in frame.images:
            if img_msg.name - 1 not in args.select_camera:
                continue
            calib = next(c for c in frame.camera_calibrations
                         if c.name == img_msg.name)
            image_id = len(Rs)
            img_path = os.path.join(args.dst, "image",
                                    f"{image_id:06d}.jpg")
            with open(img_path, "wb") as f:
                f.write(img_msg.image)
            intr = np.array(calib.intrinsic)
            K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]],
                          [0, 0, 1.0]])
            RT = lidar.camera_world_to_cam(
                torch.as_tensor(ego_to_world, device=dev),
                torch.as_tensor(calib.extrinsic, device=dev))
            RT_np = RT.cpu().numpy()
            Ks.append(intr)
            Rs.append(RT_np[:3, :3])
            Ts.append(RT_np[:3, 3])
            stamps.append(t_rel)
            is_val_list.append(is_val)

            with Image.open(img_path) as im:
                W, H = im.size
                img_arr = (torch.as_tensor(np.asarray(im, np.float32),
                                           device=dev) / 255.0
                           if args.use_color else None)
            uv, depth, mask = lidar.project_points(
                points, torch.as_tensor(K, device=dev), RT, W, H)
            if args.use_depth:
                dmap, dmask = lidar.lidar_depth_map(uv, depth, mask, W, H)
                np.savez(os.path.join(args.dst, "lidar_depth",
                                      f"{image_id:06d}.npz"),
                         depth=dmap.cpu().numpy(), mask=dmask.cpu().numpy())
            if not is_val:
                mask_total |= mask
                if args.use_color:
                    colors[mask] = (colors[mask].to(F64)
                                    + lidar.sample_colors_aligned(
                                        img_arr, uv[mask])
                                    ).to(torch.float32)
                    counts += mask.to(torch.float32)

        if not is_val:
            pts = points[mask_total]
            col = colors[mask_total]
            cnt = counts[mask_total]
            if args.downsample_ratio < 1.0:
                keep = rng.permutation(len(pts))[
                    :int(len(pts) * args.downsample_ratio)]
                keep = torch.as_tensor(keep, device=dev)
                pts, col, cnt = pts[keep], col[keep], cnt[keep]
            if args.use_color:
                col = col / torch.clamp(cnt, min=1.0)[:, None] * 255.0
            else:
                col = torch.as_tensor(
                    rng.random((len(pts), 3)).astype(np.float32) * 255.0,
                    device=dev)
            pts = pts.cpu().numpy()
            pcd.append(np.concatenate(
                [pts, np.full((len(pts), 1), t_rel, np.float32)], axis=-1))
            pcd_rgb.append(col.cpu().numpy())

    pc = np.concatenate(pcd)
    store_point_cloud(os.path.join(args.dst, "points3d.ply"),
                      pc[:, :3], np.concatenate(pcd_rgb), times=pc[:, 3])
    np.savez(os.path.join(args.dst, "cameras.npz"),
             K=np.stack(Ks), R=np.stack(Rs), T=np.stack(Ts),
             time_stamps=np.array(stamps, np.float32),
             is_val_list=np.array(is_val_list, bool))
    print(f"PCD {pc.shape}; images/RTs {len(Rs)} -> {args.dst}")


if __name__ == "__main__":
    main()
