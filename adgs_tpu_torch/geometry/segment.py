"""Mask -> LiDAR point-cloud object tagging on a torch device (counterpart
of adgs_tpu/geometry/segment.py, which is numpy).

Native equivalent of the reference's scripts/segment_pcd.py:80-177: for
each TRAIN frame in order, project the cloud's points whose timestamp
matches the frame (and which are still untagged) into the view and read the
object-id out of the frame's semantic mask with nearest-neighbour
align-corners sampling — exactly torch.nn.functional.grid_sample(...,
mode='nearest', align_corners=True) on coordinates normalized as
(px / W) * 2 - 1. Points outside the frustum (or behind the camera) read 0.
The first frame that tags a point wins; later frames only see untagged
points, so the sweep over frames stays sequential. This produces the
per-point `obj` column the object-aware model keys on (data/readers.py
obj_id).

The projection runs in float64 as numpy promotes the float32 cloud against
float64 poses. The timestamps are compared in the dtype numpy compares
them in: float64 against a numpy float64 frame time (segment_pcd's
`meta.fid`), the cloud's float32 against a Python float.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

F64 = torch.float64


def _numpy_compare_dtype(dtype: torch.dtype, value) -> torch.dtype:
    """The dtype numpy compares a `dtype` array with `value` in (NEP 50: a
    Python float takes the array's dtype, a numpy float64 keeps its own)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return getattr(torch, np.result_type(np_dtype, value).name)


def nearest_sample_aligned(mask: torch.Tensor, px: torch.Tensor,
                           py: torch.Tensor) -> torch.Tensor:
    """grid_sample(mode='nearest', align_corners=True) parity for pixel
    coordinates px in [0, W), py in [0, H): normalized x = (px/W)*2-1 maps
    to index x_n * (W-1) / 2 + (W-1) / 2 = px * (W-1) / W, rounded to
    nearest (half to even, as np.rint)."""
    H, W = mask.shape
    ix = torch.round(px * (W - 1) / W).long()
    iy = torch.round(py * (H - 1) / H).long()
    ix = torch.clamp(ix, 0, W - 1)
    iy = torch.clamp(iy, 0, H - 1)
    return mask[iy, ix]


def tag_points_one_frame(points: torch.Tensor, K: torch.Tensor,
                         R: torch.Tensor, T: torch.Tensor,
                         semantic: torch.Tensor) -> torch.Tensor:
    """float32 object id per point for a single view (0 where out of view).

    points: [N, 3] world; K [3,3]; R [3,3], T [3] world-to-camera;
    semantic: [H, W] integer object-id map (0 = background)."""
    H, W = semantic.shape
    cam = points.to(F64) @ R.to(F64).T + T.to(F64)
    uvw = cam @ K.to(F64).T
    z_ok = uvw[:, 2] > 0.0
    z = torch.where(z_ok, uvw[:, 2], 1.0)
    px, py = uvw[:, 0] / z, uvw[:, 1] / z
    in_view = z_ok & (px > 0.0) & (px < W) & (py > 0.0) & (py < H)
    obj = nearest_sample_aligned(semantic.to(torch.float32), px, py)
    return torch.where(in_view, obj, 0.0).to(torch.float32)


def tag_object_points(points: torch.Tensor, point_time: torch.Tensor,
                      frame_time: Sequence[float],
                      K: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                      semantics: Sequence[torch.Tensor],
                      verbose: bool = False) -> torch.Tensor:
    """Sequential first-tag-wins sweep over frames (segment_pcd.py:104-123),
    on the points' device.

    points [N, 3], point_time [N] raw timestamps; frame_time[i] must equal
    the timestamp value stored in the cloud for that frame's LiDAR points.
    K: [F, 3, 3] or [3, 3]; R/T: [F, 3, 3] / [F, 3]."""
    dev = points.device
    N = len(points)
    F = len(semantics)
    K = torch.as_tensor(K, dtype=F64, device=dev)
    Ks = K.expand(F, 3, 3) if K.ndim != 3 else K
    R = torch.as_tensor(R, dtype=F64, device=dev)
    T = torch.as_tensor(T, dtype=F64, device=dev)
    point_time = point_time.to(dev)
    obj = torch.zeros(N, dtype=torch.float32, device=dev)
    for i in range(F):
        cmp = _numpy_compare_dtype(point_time.dtype, frame_time[i])
        at = torch.tensor(frame_time[i], dtype=cmp, device=dev)
        sel = (point_time.to(cmp) == at) & (obj == 0.0)
        if not bool(sel.any()):
            continue
        obj[sel] = tag_points_one_frame(points[sel], Ks[i], R[i], T[i],
                                        semantics[i].to(dev))
    if verbose:
        print(f"[segment] total {N} points, object points "
              f"{int((obj > 0).sum())}")
    return obj
