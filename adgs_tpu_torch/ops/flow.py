"""Optical-flow pseudo-label loss: project the blended 3D flow points with
the flow package's (K, R, T) and compare with the tracked pixel targets
(counterpart of adgs_tpu/ops/flow.py). The pixel selection is mask
arithmetic at full [H, W] shape."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..profiling import copied_in


class FlowPackage(NamedTuple):
    """One flow supervision target."""

    time: torch.Tensor     # 0-d: the tracked frame's time
    K: torch.Tensor        # [3,3] intrinsics
    R: torch.Tensor        # [3,3] world->cam
    T: torch.Tensor        # [3] translation
    flow: torch.Tensor     # [2,H,W] target pixel coords at `time`
    vis: torch.Tensor      # [H,W] visibility in {0,1}


def flow_points_project(pts: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                        T: torch.Tensor, dist: float = 1e-3):
    """[N,3] world -> ([N,2] pixels, [N] in-front mask)."""
    proj = (pts @ R.T + T) @ K.T
    mask = proj[..., 2] > dist
    uv = proj[..., :2] / torch.clamp(proj[..., 2:3], min=dist)
    return uv, mask


def flow_loss_sums(img_flow: torch.Tensor, flow_img: torch.Tensor,
                   vis_img: torch.Tensor, K, R, T,
                   img_opacity: Optional[torch.Tensor] = None,
                   dist: float = 1e-3,
                   full_hw: Optional[tuple[int, int]] = None,
                   pix_mask: Optional[torch.Tensor] = None):
    """Per-pixel decomposition of flow_loss: (err_sum, vis_count). Every
    term is pixel-local, so slab-sharded callers psum the two sums and
    divide once. full_hw: the FULL image (H, W) for the axis
    normalization and bounds (the slab may be a row slice of it);
    pix_mask: [h, w] validity of this region's pixels (row padding)."""
    H, W = full_hw if full_hw is not None else flow_img.shape[1:]
    vis = ((vis_img > 0.5)
           & (flow_img[0] <= W - 1.0) & (flow_img[0] >= 0.0)
           & (flow_img[1] <= H - 1.0) & (flow_img[1] >= 0.0))
    if pix_mask is not None:
        vis = vis & (pix_mask > 0)
    count = torch.sum(vis)
    weight = vis.to(img_flow.dtype)
    if img_opacity is not None:
        weight = weight * img_opacity

    pts = img_flow.reshape(3, -1).T                      # [hw, 3]
    uv, front = flow_points_project(pts, K, R, T, dist)
    weight = weight.reshape(-1) * front.to(weight.dtype)

    target = flow_img.reshape(2, -1).T                   # [hw, 2]
    err = torch.abs(uv - target) * weight[:, None]
    size = err.new_tensor([float(W), float(H)])
    copied_in(size)
    err = err / size
    return torch.sum(err), count


def flow_loss(img_flow: torch.Tensor, pkg: FlowPackage,
              img_opacity: Optional[torch.Tensor] = None,
              dist: float = 1e-3) -> torch.Tensor:
    """img_flow [3,H,W] blended 3D flow points; pkg.flow [2,H,W] targets.
    Weighted per pixel by visibility (and rendered opacity), axes
    normalized by W and H, mean over the selected pixels."""
    total, count = flow_loss_sums(img_flow, pkg.flow, pkg.vis,
                                  pkg.K, pkg.R, pkg.T, img_opacity, dist)
    total = total / torch.clamp(count, min=1)
    return torch.where(count > 0, total, torch.zeros_like(total))
