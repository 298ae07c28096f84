"""Monocular-depth alignment: closed-form scale/shift least squares and
the aligned L1 depth loss (counterpart of adgs_tpu/ops/depth.py)."""

from __future__ import annotations

from typing import Optional

import torch


def depth_scale_shift(prediction: torch.Tensor, target: torch.Tensor,
                      mask: Optional[torch.Tensor] = None):
    """Closed-form (scale, shift) minimizing ||scale*pred + shift - target||^2
    over masked pixels. Returns (scale, shift); degenerate -> (0, 0)."""
    if mask is None:
        mask = torch.ones_like(prediction)
    a00 = torch.sum(mask * prediction * prediction)
    a01 = torch.sum(mask * prediction)
    a11 = torch.sum(mask)
    b0 = torch.sum(mask * prediction * target)
    b1 = torch.sum(mask * target)
    det = a00 * a11 - a01 * a01
    degenerate = det == 0.0
    safe = torch.where(degenerate, torch.ones_like(det), det)
    zero = torch.zeros_like(det)
    scale = torch.where(degenerate, zero, (a11 * b0 - a01 * b1) / safe)
    shift = torch.where(degenerate, zero, (-a01 * b0 + a00 * b1) / safe)
    return scale, shift


def scaled_shifted_depth(prediction: torch.Tensor, target: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    scale, shift = depth_scale_shift(prediction, target, mask)
    return scale * prediction + shift


def depth_loss(prediction: torch.Tensor, target: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked L1 after the scale/shift alignment."""
    pred = scaled_shifted_depth(prediction, target, mask)
    if mask is None:
        mask = torch.ones_like(pred)
    return (torch.sum(torch.abs(pred - target) * mask)
            / torch.clamp(torch.sum(mask), min=1.0))
