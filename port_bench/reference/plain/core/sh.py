"""Real spherical harmonics (degrees 0..3) and RGB<->SH helpers
(counterpart of adgs_tpu/core/sh.py)."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """[..., (deg+1)**2] basis values with the coefficients folded in."""
    if not (0 <= deg <= 3):
        raise ValueError(f"SH degree must be in [0, 3], got {deg}")
    cols = [SH_C0 * torch.ones_like(dirs[..., 0:1])]
    if deg > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            cols += [SH_C2[0] * xy, SH_C2[1] * yz,
                     SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
                     SH_C2[4] * (xx - yy)]
            if deg > 2:
                cols += [
                    SH_C3[0] * y * (3.0 * xx - yy),
                    SH_C3[1] * xy * z,
                    SH_C3[2] * y * (4.0 * zz - xx - yy),
                    SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                    SH_C3[4] * x * (4.0 * zz - xx - yy),
                    SH_C3[5] * z * (xx - yy),
                    SH_C3[6] * x * (xx - 3.0 * yy),
                ]
    return torch.cat(cols, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh [..., K, C] at unit dirs [..., 3] -> [..., C] (no offset, no clamp)."""
    k = num_sh_coeffs(deg)
    return torch.sum(sh_basis(deg, dirs)[..., :, None] * sh[..., :k, :], dim=-2)


def eval_sh_color(deg: int, sh: torch.Tensor, means: torch.Tensor,
                  campos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(max(raw + 0.5, 0), raw + 0.5) at the camera-to-mean direction."""
    d = means - campos
    sq = torch.sum(d * d, dim=-1, keepdim=True)
    zero = sq == 0.0
    n = torch.sqrt(torch.where(zero, torch.ones_like(sq), sq))
    d = d / torch.where(zero, torch.ones_like(n), n)
    raw = eval_sh(deg, sh, d) + 0.5
    return torch.clamp(raw, min=0.0), raw


def rgb_to_sh(rgb):
    return (rgb - 0.5) / SH_C0


def sh_to_rgb(sh):
    return sh * SH_C0 + 0.5
