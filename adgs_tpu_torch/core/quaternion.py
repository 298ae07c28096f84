"""Quaternion algebra in (w, x, y, z) convention (counterpart of
adgs_tpu/core/quaternion.py). Norms are NaN-gradient-safe at 0, because
capacity-padded dead slots hold exact zeros."""

from __future__ import annotations

import torch

_EPS = 1e-8


def _safe_norm(v: torch.Tensor, dim=-1, keepdim=False) -> torch.Tensor:
    """||v|| with gradient 0 (not NaN) at v == 0."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    zero = sq == 0.0
    safe = torch.sqrt(torch.where(zero, torch.ones_like(sq), sq))
    return torch.where(zero, torch.zeros_like(sq), safe)


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Division by max(||q||, eps) (F.normalize semantics)."""
    return q / torch.clamp(_safe_norm(q, dim=-1, keepdim=True), min=eps)


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, wxyz."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def unit_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector, flipped to the w >= 0 hemisphere
    first (shortest arc)."""
    q = torch.where(q[..., 0:1] < 0.0, -q, q)
    w = q[..., 0]
    v = q[..., 1:]
    vn = _safe_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vn, w)
    half = 0.5 * angle
    small = vn < _EPS
    scale = torch.where(small, 2.0 + half * half / 3.0,
                        angle / torch.where(small, torch.ones_like(vn), vn))
    return v * scale[..., None]


def rotvec_to_unit(rv: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> unit quaternion, wxyz."""
    angle = _safe_norm(rv, dim=-1)
    half = 0.5 * angle
    small = angle < _EPS
    k = torch.where(small, 0.5 - angle * angle / 48.0,
                    torch.sin(half)
                    / torch.where(small, torch.ones_like(angle), angle))
    w = torch.cos(half)
    return torch.cat([w[..., None], rv * k[..., None]], dim=-1)
