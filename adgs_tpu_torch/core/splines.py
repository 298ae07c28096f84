"""Temporal trajectory bases: B-spline, polynomial, Fourier and the
cumulative quaternion B-spline (counterpart of adgs_tpu/core/splines.py).

The active control window depends on t; it is selected with an index
tensor built on t's device, so evaluating at a CUDA time never syncs.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import quaternion as quat
from ..profiling import copied_in


@functools.lru_cache(maxsize=None)
def deboor_cox_matrix(order: int) -> np.ndarray:
    """(order+1, order+1) uniform B-spline basis matrix M with
    basis(u) = [1, u, ..., u^k] @ M."""
    if order == 0:
        return np.array([[1.0]], dtype=np.float32)
    prior = deboor_cox_matrix(order - 1)
    zrow = np.zeros((1, prior.shape[1]), np.float32)
    prior_left = np.concatenate([prior, zrow], axis=0)
    prior_right = np.concatenate([zrow, prior], axis=0)
    idx = np.arange(order)
    teo_left = np.zeros((order, order + 1), dtype=np.float32)
    teo_left[idx, idx] = idx + 1
    teo_left[idx, idx + 1] = order - idx - 1
    teo_right = np.zeros((order, order + 1), dtype=np.float32)
    teo_right[idx, idx] = -1
    teo_right[idx, idx + 1] = 1
    return ((prior_left @ teo_left + prior_right @ teo_right)
            / order).astype(np.float32)


def bspline_basis(u: torch.Tensor, order: int) -> torch.Tensor:
    """Basis weights over the order+1 control points of the window."""
    mat = torch.as_tensor(deboor_cox_matrix(order), device=u.device)
    copied_in(mat)
    powers = u ** torch.arange(0.0, order + 1.0, device=u.device)
    return powers @ mat


def poly_basis(v: torch.Tensor, order: int) -> torch.Tensor:
    return v ** torch.arange(1.0, order + 1.0, device=v.device)


def fourier_basis(v: torch.Tensor, order: int) -> torch.Tensor:
    freq = torch.arange(1.0, order + 1.0, device=v.device) * math.pi
    return torch.cat([torch.sin(v * freq), torch.cos(v * freq)], dim=-1)


class BasisConfig(NamedTuple):
    """Per-quantity basis spec after default filling."""

    bspline_ctrl: int = 0
    bspline_order: int = 0
    poly_order: int = 0
    fft_order: int = 0
    quat_ctrl: int = 0
    quat_order: int = 0

    @property
    def param_count(self) -> int:
        return (self.bspline_ctrl + self.poly_order + 2 * self.fft_order
                + self.quat_ctrl)


def default_basis_config(args: Optional[list], frame_num: int,
                         downsample_ratio: int = 3) -> BasisConfig:
    """Fill None entries like set_default_param_order."""
    a = list(args) if args is not None else [None] * 6
    bspline_ctrl = a[0] if a[0] is not None else int(frame_num // downsample_ratio)
    bspline_order = 0
    if bspline_ctrl > 0:
        bspline_order = a[1] if a[1] is not None else 5
        bspline_order = min(bspline_order, bspline_ctrl - 1)
    poly_order = a[2] if a[2] is not None else int(frame_num // downsample_ratio)
    fft_order = a[3] if a[3] is not None else 6
    quat_ctrl = a[4] if a[4] is not None else int(frame_num // downsample_ratio)
    quat_order = 0
    if quat_ctrl > 0:
        quat_order = a[5] if a[5] is not None else 1
        quat_order = min(quat_order, quat_ctrl - 1)
    return BasisConfig(bspline_ctrl, bspline_order, poly_order, fft_order,
                       quat_ctrl, quat_order)


def _window(param: torch.Tensor, t: torch.Tensor, ctrl: int, order: int,
            offset: int):
    """(ctrl_pts [..., order+1], local coordinate u) of the active window."""
    interval = ctrl - order
    start = torch.clamp(torch.floor(t * interval).to(torch.int64),
                        max=interval - 1)
    start = torch.clamp(start, min=0)
    idx = offset + start + torch.arange(order + 1, device=param.device)
    pts = param.index_select(-1, idx)
    u = t * interval - start.to(t.dtype)
    return pts, u


def eval_trajectory(t: torch.Tensor, param: torch.Tensor,
                    cfg: BasisConfig) -> torch.Tensor:
    """B-spline + polynomial + Fourier terms; param [..., C] -> [...].
    A quaternion block is evaluated by eval_quat_trajectory."""
    result = torch.zeros(param.shape[:-1], dtype=param.dtype,
                         device=param.device)
    offset = 0
    if cfg.bspline_ctrl != 0:
        pts, u = _window(param, t, cfg.bspline_ctrl, cfg.bspline_order, 0)
        result = result + torch.sum(pts * bspline_basis(u, cfg.bspline_order),
                                    dim=-1)
        offset += cfg.bspline_ctrl
    if cfg.poly_order != 0:
        p = param[..., offset:offset + cfg.poly_order]
        result = result + torch.sum(p * poly_basis(t, cfg.poly_order), dim=-1)
        offset += cfg.poly_order
    if cfg.fft_order != 0:
        p = param[..., offset:offset + 2 * cfg.fft_order]
        result = result + torch.sum(
            p * fourier_basis(t[..., None], cfg.fft_order), dim=-1)
        offset += 2 * cfg.fft_order
    return result


def eval_quat_trajectory(t: torch.Tensor, param: torch.Tensor,
                         cfg: BasisConfig) -> torch.Tensor:
    """Cumulative quaternion B-spline, wxyz; param [N, 4, C] with the quat
    control block in the LAST cfg.quat_ctrl columns:
    q(t) = q0 * prod_i exp(cum_i * log(q_{i-1}^-1 q_i))."""
    if cfg.quat_ctrl == 0:
        raise ValueError("no quaternion spline block configured")
    offset = cfg.bspline_ctrl + cfg.poly_order + 2 * cfg.fft_order
    pts, u = _window(param, t, cfg.quat_ctrl, cfg.quat_order, offset)

    identity = param.new_tensor([1.0, 0.0, 0.0, 0.0])
    copied_in(identity)
    ctrl = quat.normalize((pts + identity[:, None]).transpose(-1, -2))

    basis = bspline_basis(u, cfg.quat_order)                 # [k+1]
    cum = torch.cumsum(basis.flip(-1), dim=-1).flip(-1)[1:]  # [k]

    delta = quat.multiply(quat.conjugate(ctrl[:, :-1, :]), ctrl[:, 1:, :])
    vec = quat.unit_to_rotvec(delta)                         # [N, k, 3]
    steps = quat.rotvec_to_unit(vec * cum[None, :, None])    # [N, k, 4]

    out = ctrl[:, 0, :]
    for i in range(cfg.quat_order):
        out = quat.multiply(out, steps[:, i, :])
    return out
