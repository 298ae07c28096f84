"""Quaternion algebra in (w, x, y, z) convention (counterpart of
adgs_tpu/core/quaternion.py). Norms are NaN-gradient-safe at 0, because
capacity-padded dead slots hold exact zeros."""

from __future__ import annotations

import torch

from ..profiling import copied_in

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
    sign = q.new_tensor([1.0, -1.0, -1.0, -1.0])
    copied_in(sign)
    return q * sign


def to_rotation_matrix(q: torch.Tensor, normalized: bool = False
                       ) -> torch.Tensor:
    """[..., 4] wxyz quaternion -> [..., 3, 3] rotation matrix
    (build_rotation)."""
    if not normalized:
        q = normalize(q)
    r, x, y, z = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


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


def log(q: torch.Tensor) -> torch.Tensor:
    """General quaternion log: [log|q|, axis * atan2(|v|, w)]."""
    qn = torch.clamp(_safe_norm(q, dim=-1, keepdim=True), min=1e-5)
    w = q[..., 0:1]
    v = q[..., 1:]
    vn = _safe_norm(v, dim=-1, keepdim=True)
    axis = v / torch.clamp(vn, min=1e-12)
    angle = torch.atan2(vn, w)
    return torch.cat([torch.log(qn), axis * angle], dim=-1)


def exp(q: torch.Tensor) -> torch.Tensor:
    """General quaternion exp."""
    s = q[..., 0:1]
    v = q[..., 1:]
    vn = _safe_norm(v, dim=-1, keepdim=True)
    small = vn < _EPS
    sinc = torch.where(small, 1.0 - vn * vn / 6.0,
                       torch.sin(vn) / torch.where(small, torch.ones_like(vn),
                                                   vn))
    out = torch.cat([torch.cos(vn), sinc * v], dim=-1)
    return torch.exp(s) * out
