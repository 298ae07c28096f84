"""Tag LiDAR points with object ids from the train-view semantic masks
(the port's counterpart of scripts/segment_pcd.py; the projection and the
mask reads run on a torch device).

Rewrites the scene's `points3d.ply` / `points3d-NN.ply` in place with an
`obj` column: each train frame projects the cloud points that carry its
timestamp (and are still untagged) into the view and reads the object id
out of the frame's semantic mask with nearest align-corners sampling —
reference semantics scripts/segment_pcd.py:80-177.

  python -m adgs_tpu_torch.scripts.segment_pcd <scene> [--split_mode nvs-75]
      [--cam N] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .._device import resolve_device
from ..data.ply import fetch_point_cloud, store_point_cloud
from ..geometry.scene_meta import load_scene_meta
from ..geometry.segment import tag_object_points


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--split_mode", default="nvs-75")
    ap.add_argument("--cam", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    meta = load_scene_meta(args.path, args.split_mode, args.cam)
    suffix = (f"-{args.split_mode.split('-')[-1]}"
              if meta.dataset == "kitti" else "")
    ply_path = os.path.join(args.path, f"points3d{suffix}.ply")
    points, colors, times, _ = fetch_point_cloud(ply_path)

    train = np.where(~meta.is_val)[0]
    semantics = [torch.as_tensor(np.load(meta.semantic_paths[i])
                                 .astype(np.float32), device=dev)
                 for i in train]
    obj = tag_object_points(torch.as_tensor(points, device=dev),
                            torch.as_tensor(times, device=dev),
                            meta.fid[train], meta.K[train], meta.R[train],
                            meta.T[train], semantics, verbose=True)
    store_point_cloud(ply_path, points, colors * 255.0, times,
                      obj.cpu().numpy())
    print(f"rewrote {ply_path} with obj column")


if __name__ == "__main__":
    main()
