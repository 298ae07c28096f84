"""Validate a scene directory against the adgs_tpu / AD-GS data contract
(the port's counterpart of scripts/validate_scene.py, on the port's own
readers; the point cloud's object count is taken on a torch device).

The reference's pseudo-label generators (scripts/flow.py, semantic.py,
run-dpt.py, segment_pcd.py, colmap.py) run external networks in separate
conda environments; what the training framework actually consumes is their
OUTPUT CONTRACT. This tool checks a scene directory for that contract and
reports exactly what is missing or malformed (exit code 1: no dataset
sentinel, 2: problems found):

  <scene>/
    poses.npz | cameras.npz | meta.npz     (dataset sentinel + poses)
    image/NNNNNN.png
    depth/NNNNNN.npy                       (H,W[,1] normalized inv-depth)
    semantic/mask_NNNNNN.npy               (H,W int object ids)
    sky/mask_NNNNNN.npy                    (H,W binary)
    flow[/<split>]/NNNNNN.npz              ('flow': list of
                                            [time,K,R,T,flow(2HW),vis(HW)])
    points3d[-25|-50|-75].ply              (xyz+rgb+t[+obj])
    colmap[-25|-50|-75].ply                (optional SfM points)

  python -m adgs_tpu_torch.scripts.validate_scene <scene>
      [--split_mode nvs-75] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .._device import resolve_device
from ..data.ply import fetch_point_cloud
from ..data.readers import _DATASET_SPECS, detect_dataset


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scene")
    p.add_argument("--split_mode", default="nvs-75")
    p.add_argument("--device", default=None,
                   help="the card unless given (e.g. cpu)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    root = args.scene
    problems = []
    infos = []

    try:
        ds = detect_dataset(root)
        infos.append(f"dataset: {ds}")
    except ValueError as e:
        print(f"FATAL: {e}")
        sys.exit(1)

    imgs = sorted(os.listdir(os.path.join(root, "image"))) \
        if os.path.isdir(os.path.join(root, "image")) else []
    if not imgs:
        problems.append("image/: empty or missing")
    infos.append(f"frames: {len(imgs)}")

    meta = np.load(os.path.join(root, _DATASET_SPECS[ds][0]),
                   allow_pickle=True)
    tkey = "time_stamp" if ds == "kitti" else "time_stamps"
    if tkey not in meta:
        problems.append(f"{_DATASET_SPECS[ds][0]}: missing '{tkey}'")
    elif len(meta[tkey]) != len(imgs):
        problems.append(
            f"{tkey} length {len(meta[tkey])} != {len(imgs)} images")

    flow_dir = (os.path.join(root, "flow", args.split_mode)
                if ds == "kitti" else os.path.join(root, "flow"))
    counts = dict(depth=0, semantic=0, sky=0, flow=0)
    for img in imgs:
        stem = img.split(".")[0]
        if os.path.exists(os.path.join(root, "depth", stem + ".npy")):
            counts["depth"] += 1
        if os.path.exists(os.path.join(root, "semantic",
                                       "mask_" + stem + ".npy")):
            counts["semantic"] += 1
        if os.path.exists(os.path.join(root, "sky", "mask_" + stem + ".npy")):
            counts["sky"] += 1
        fpath = os.path.join(flow_dir, stem + ".npz")
        if os.path.exists(fpath):
            counts["flow"] += 1
            try:
                pkgs = np.load(fpath, allow_pickle=True)["flow"]
                for pkg in pkgs:
                    t, K, R, T, fl, vis = pkg
                    if (np.asarray(K).shape != (3, 3)
                            or np.asarray(R).shape != (3, 3)
                            or np.asarray(fl).shape[0] != 2
                            or np.asarray(vis).shape
                            != np.asarray(fl).shape[1:]):
                        raise ValueError("bad entry shapes")
            except Exception as e:  # any unreadable package is reported
                problems.append(f"{fpath}: malformed flow package ({e})")
    for k, v in counts.items():
        infos.append(f"{k} priors: {v}/{len(imgs)}")
        if v == 0:
            problems.append(f"{k}/: no priors found "
                            f"(training without lambda_{k} only)")

    ply = (f"points3d-{args.split_mode[-2:]}.ply" if ds == "kitti"
           else "points3d.ply")
    if not os.path.exists(os.path.join(root, ply)):
        problems.append(f"{ply}: missing init point cloud")
    else:
        pts, cols, times, obj = fetch_point_cloud(os.path.join(root, ply))
        n_obj = int((torch.as_tensor(obj, device=dev) > 0.5).sum())
        infos.append(f"{ply}: {len(pts)} points, {n_obj} object-tagged")
        if n_obj == 0:
            problems.append(f"{ply}: no object-tagged points "
                            "(run the point-cloud segmentation step)")

    print("\n".join("  " + s for s in infos))
    if problems:
        print("\nPROBLEMS:")
        print("\n".join("  - " + s for s in problems))
        sys.exit(2)
    print("\nOK: scene satisfies the data contract")


if __name__ == "__main__":
    main()
