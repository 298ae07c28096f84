"""Front-to-back alpha compositing in closed form (counterpart of
adgs_tpu/raster/composite.py): the plain tier the compositing kernel is
held to.

  raw loop:  alpha = min(0.99, op * exp(power)); skip if power > 0 or
             alpha < 1/255; stop (all later too) once T*(1-alpha) < 1e-4;
             C += f * alpha * T; T *= (1-alpha)

The gates stay in lockstep with csrc/composite.cu and the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
DEPTH_EPS = 1e-7


class BlendWeights(NamedTuple):
    weights: torch.Tensor  # [..., G] alpha_j * T_j
    t_eff: torch.Tensor    # [...] effective transmittance (the rendered T)
    include: torch.Tensor  # [..., G] contributions before termination
    t_excl: torch.Tensor   # [..., G] T_j, the transmittance before j


def blend_weights(alpha: torch.Tensor) -> BlendWeights:
    """Closed-form front-to-back weights along the LAST axis (a whole
    instance list at once, T starting at 1). Termination is a test on the
    RAW running product, which only decreases, so the included
    contributions are always a prefix."""
    log_t_raw = torch.cumsum(torch.log1p(-alpha), dim=-1)
    include = torch.exp(log_t_raw) >= T_EPS
    a_eff = torch.where(include, alpha, torch.zeros_like(alpha))
    log1m_eff = torch.log1p(-a_eff)
    log_t_excl = torch.cumsum(log1m_eff, dim=-1) - log1m_eff
    t_excl = torch.exp(log_t_excl)
    weights = a_eff * t_excl
    t_eff = torch.exp(log_t_excl[..., -1] + log1m_eff[..., -1])
    return BlendWeights(weights=weights, t_eff=t_eff, include=include,
                        t_excl=t_excl)


def depth_feature(depth: torch.Tensor, inv_depth: bool) -> torch.Tensor:
    if inv_depth:
        return 1.0 / (depth + DEPTH_EPS)
    return depth
