"""Static SfM cloud from known poses — native COLMAP-pipeline replacement
(the port's counterpart of scripts/triangulate.py; matching, the DLT and
the filters run on a torch device, SIFT on the host).

Produces the `colmap.ply` / `colmap-NN.ply` static point cloud that
`data/readers.py` requires, from the TRAIN-split images masked to the
static region (object mask == 0 AND sky mask == 0), with the dataset's
exact per-frame poses held fixed. Same contract as the reference's
scripts/colmap.py (feature_extractor + exhaustive_matcher +
point_triangulator) but self-contained: OpenCV SIFT + a batched DLT
(adgs_tpu_torch/geometry/triangulate.py), no COLMAP binary.

  python -m adgs_tpu_torch.scripts.triangulate <scene> [--split_mode nvs-75]
      [--cam N] [--window 6] [--max_features 8192] [--downscale 1]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from .._device import resolve_device
from ..data.ply import store_point_cloud
from ..geometry.scene_meta import load_scene_meta
from ..geometry.triangulate import triangulate_known_poses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--split_mode", default="nvs-75")
    ap.add_argument("--cam", type=int, default=None)
    ap.add_argument("--window", type=int, default=0,
                    help="0 = exhaustive matching; N = same-camera "
                         "temporal window + cross-camera pairs")
    ap.add_argument("--max_features", type=int, default=8192)
    ap.add_argument("--ratio", type=float, default=0.8)
    ap.add_argument("--max_reproj_err", type=float, default=4.0)
    ap.add_argument("--min_tri_angle", type=float, default=0.5)
    ap.add_argument("--downscale", type=int, default=1,
                    help="feature-detection downscale factor")
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    meta = load_scene_meta(args.path, args.split_mode, args.cam)
    train = np.where(~meta.is_val)[0]

    images, masks = [], []
    K = meta.K[train].copy()
    for i in train:
        with Image.open(meta.image_paths[i]) as im:
            img = np.asarray(im.convert("RGB"))
        mask = np.ones(img.shape[:2], bool)
        if os.path.exists(meta.semantic_paths[i]):
            mask &= np.load(meta.semantic_paths[i]) == 0
        if os.path.exists(meta.sky_paths[i]):
            mask &= np.load(meta.sky_paths[i]) == 0
        if args.downscale > 1:
            s = args.downscale
            img = img[::s, ::s]
            mask = mask[::s, ::s]
        images.append(img)
        masks.append(mask)
    if args.downscale > 1:
        K[:, :2, :] /= args.downscale

    xyz, rgb = triangulate_known_poses(
        images, masks, K, meta.R[train], meta.T[train],
        frame_steps=meta.step[train], cam_of=meta.cam_id[train],
        window=args.window, max_features=args.max_features,
        ratio=args.ratio, max_reproj_err=args.max_reproj_err,
        min_tri_angle_deg=args.min_tri_angle, verbose=True, device=dev)

    suffix = (f"-{args.split_mode.split('-')[-1]}"
              if meta.dataset == "kitti" else "")
    out = os.path.join(args.path, f"colmap{suffix}.ply")
    store_point_cloud(out, xyz.astype(np.float32), rgb.astype(np.float32))
    print(f"wrote {len(xyz)} static points -> {out}")


if __name__ == "__main__":
    main()
