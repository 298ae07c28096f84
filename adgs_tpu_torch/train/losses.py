"""Loss assembly for one training frame (counterpart of
adgs_tpu/train/losses.py).

L1 + D-SSIM photometric, scale-shift-aligned monocular depth, projected
optical flow, object-mask BCE, sky BCE on (1 - accumulated opacity),
time-sigma prior and the two KNN-variance regularizers; a zero lambda
removes its term. Loss weights come from OptimizationConfig.

The KNN group gather has its own backward, as the JAX package's
`_group_gather`: a stable sort of the flat group ids, one row gather and
a segmented sum over the sorted rows (kernel B5, `segment_sum`). It is
deterministic, where autograd's scatter-add backward of an index would use
float atomics on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _kernels
from ..models.gaussians import GaussianConfig, GaussianParams, GaussianState
from ..ops import depth as depth_ops
from ..ops import flow as flow_ops
from ..ops import image as image_ops
from ..raster.render import segment_sum, segment_sum_torch
from .config import OptimizationConfig


class FrameBatch(NamedTuple):
    """Ground-truth supervision for one camera frame. Missing channels are
    zero arrays; the lambdas decide which terms exist."""

    image: torch.Tensor            # [3,H,W]
    depth: torch.Tensor            # [H,W] normalized inverse depth prior
    sky: torch.Tensor              # [H,W] 1 = sky
    semantic: torch.Tensor         # [H,W] >0 = object
    flow: Optional[flow_ops.FlowPackage] = None
    flow_valid: Optional[torch.Tensor] = None  # 0-d bool


def _bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """F.binary_cross_entropy after the caller's clip."""
    return -torch.mean(target * torch.log(pred)
                       + (1 - target) * torch.log(1 - pred))


def sorted_group_rows(d_g: torch.Tensor, idx: torch.Tensor, n: int):
    """The group gather's cotangent [A, K, D] as rows [A*K, D] in stable
    order of their value ids idx [A, K], the sorted ids, and the [n+1]
    bounds of each value's run of rows: the segmented sum's inputs."""
    D = d_g.shape[-1]
    s, perm = torch.sort(idx.reshape(-1).long(), stable=True)
    rows = d_g.reshape(-1, D)[perm].contiguous()
    bounds = torch.searchsorted(
        s, torch.arange(n + 1, device=s.device)).to(torch.int32)
    return rows, s, bounds


class GroupGather(torch.autograd.Function):
    """values2d [No, D], idx [A, K] -> [A, K, D], with a sorted segmented
    sum as its backward (B5, or its twin, as `_kernels.use` says at the
    forward; the backward follows it)."""

    @staticmethod
    def forward(ctx, values2d, idx):
        ctx.save_for_backward(idx)
        ctx.n, ctx.kernel = values2d.shape[0], _kernels.use(values2d)
        return values2d[idx.long()]

    @staticmethod
    def backward(ctx, d_g):
        (idx,) = ctx.saved_tensors
        rows, _, bounds = sorted_group_rows(d_g, idx, ctx.n)
        seg = segment_sum if ctx.kernel else segment_sum_torch
        with _kernels.following(ctx.kernel):
            return seg(rows, bounds), None


def _group_variance(g2: torch.Tensor) -> torch.Tensor:
    """[A, K, D] group members -> [A, D] unbiased variance (torch.var)."""
    k = g2.shape[1]
    mean2 = torch.mean(g2, dim=1, keepdim=True)
    return torch.sum((g2 - mean2) ** 2, dim=1) / max(k - 1, 1)


def _weighted_group_mean(var: torch.Tensor, shape, valid) -> torch.Tensor:
    """mean over valid groups of sum(var over the member's leaf shape)."""
    A = var.shape[0]
    summed = torch.sum(var.reshape((A,) + tuple(shape[1:])), dim=-1)
    per_group = summed.reshape(A, -1).mean(dim=-1)
    w = valid.to(torch.float32)
    return torch.sum(per_group * w) / torch.clamp(torch.sum(w), min=1.0)


def _group_variance_loss(values: torch.Tensor, idx: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Mean over groups of sum(var over group members): the KNN trajectory
    regularizer. values [No, ...], idx [A, K], valid [A]."""
    vflat = values.reshape(values.shape[0], -1)
    var = _group_variance(GroupGather.apply(vflat, idx))
    return _weighted_group_mean(var, values.shape, valid)


def _group_variance_pair(values_a, values_b, idx, valid):
    """Both KNN regularizers through one gather and one backward (the
    flattened columns concatenate; the per-column math is independent)."""
    fa = values_a.reshape(values_a.shape[0], -1)
    fb = values_b.reshape(values_b.shape[0], -1)
    wa = fa.shape[1]
    var = _group_variance(GroupGather.apply(torch.cat([fa, fb], dim=1), idx))
    return (_weighted_group_mean(var[:, :wa], values_a.shape, valid),
            _weighted_group_mean(var[:, wa:], values_b.shape, valid))


def _knn_reg_losses(params: GaussianParams, state: GaussianState,
                    opt: OptimizationConfig) -> dict:
    """The active KNN-variance regularizers, fused into one gather when
    both are on."""
    want_r = opt.lambda_reg > 0.0
    want_s = opt.lambda_sigma > 0.0 and opt.lambda_sigma_reg > 0.0
    idx, valid = state.obj_near_idx, state.obj_near_valid
    out: dict = {}
    if want_r and want_s:
        out["reg_loss"], out["sigma_reg_loss"] = _group_variance_pair(
            params.xyz_deform, params.gs_time_sigma, idx, valid)
    elif want_r:
        out["reg_loss"] = _group_variance_loss(params.xyz_deform, idx, valid)
    elif want_s:
        out["sigma_reg_loss"] = _group_variance_loss(params.gs_time_sigma,
                                                     idx, valid)
    return out


def _add_gaussian_terms(total, logs: dict, params: GaussianParams,
                        state: GaussianState, opt: OptimizationConfig,
                        frame_gap: float):
    """Add the per-Gaussian terms to `total` in the JAX package's order
    (regularizer, sigma prior, sigma regularizer)."""
    reg_logs = _knn_reg_losses(params, state, opt)
    logs.update(reg_logs)
    if "reg_loss" in reg_logs:
        total = total + opt.lambda_reg * reg_logs["reg_loss"]
    if opt.lambda_sigma > 0.0:
        sigma = torch.exp(params.gs_time_sigma)
        alive = state.obj_alive.to(torch.float32)
        per = torch.abs(frame_gap / torch.mean(sigma, dim=-1))
        sg = torch.sum(per * alive) / torch.clamp(torch.sum(alive), min=1.0)
        total = total + opt.lambda_sigma * sg
        logs["sigma_loss"] = sg
        if "sigma_reg_loss" in reg_logs:
            total = total + opt.lambda_sigma_reg * reg_logs["sigma_reg_loss"]
    return total


def gaussian_term_losses(params: GaussianParams, state: GaussianState,
                         opt: OptimizationConfig,
                         frame_gap: float) -> tuple[torch.Tensor, dict]:
    """The per-Gaussian (image-free) loss terms: KNN-variance regularizers
    and the time-sigma prior."""
    logs: dict = {}
    zero = torch.zeros((), dtype=torch.float32,
                       device=params.gs_time_sigma.device)
    total = _add_gaussian_terms(zero, logs, params, state, opt, frame_gap)
    return total, logs


def compute_losses(render_pkg: dict, batch: FrameBatch,
                   params: GaussianParams, state: GaussianState,
                   config: GaussianConfig, opt: OptimizationConfig,
                   frame_gap: float,
                   scene_extent: float) -> tuple[torch.Tensor, dict]:
    """(total loss, {term: value}) of one frame."""
    del config  # the same signature as the JAX package
    image = render_pkg["render"]
    logs = {}

    l1 = torch.mean(torch.abs(image - batch.image))
    dssim = 1.0 - image_ops.ssim(image, batch.image)
    total = ((1.0 - opt.lambda_dssim) * opt.lambda_l1 * l1
             + opt.lambda_dssim * dssim)
    logs["l1_loss"] = l1
    logs["dssim_loss"] = dssim

    if opt.lambda_depth > 0.0:
        d = depth_ops.depth_loss(render_pkg["depth"], batch.depth)
        total = total + opt.lambda_depth * d
        logs["depth_loss"] = d

    if opt.lambda_flow > 0.0 and batch.flow is not None:
        fl = flow_ops.flow_loss(render_pkg["img_flow"], batch.flow,
                                render_pkg["img_opacity"],
                                dist=scene_extent * 1e-3)
        if batch.flow_valid is not None:
            fl = torch.where(batch.flow_valid, fl, torch.zeros_like(fl))
        total = total + opt.lambda_flow * fl
        logs["flow_loss"] = fl

    if opt.lambda_obj > 0.0:
        pred = torch.clamp(render_pkg["img_semantic"][0], 1e-3, 1.0 - 1e-3)
        ob = _bce(pred, (batch.semantic > 0).to(torch.float32))
        total = total + opt.lambda_obj * ob
        logs["obj_loss"] = ob

    if opt.lambda_sky > 0.0:
        pred = torch.clamp(render_pkg["img_opacity"], 1e-3, 1.0 - 1e-3)
        sk = _bce(1.0 - pred, batch.sky)
        total = total + opt.lambda_sky * sk
        logs["sky_loss"] = sk

    total = _add_gaussian_terms(total, logs, params, state, opt, frame_gap)
    logs["total_loss"] = total
    return total, logs
