"""3D covariance and its EWA projection to screen space (counterpart of
adgs_tpu/core/covariance.py; same closed-form elementwise order)."""

from __future__ import annotations

from typing import NamedTuple

import torch


def build_cov3d(scaling: torch.Tensor, rotation: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """[N,3] activated scales + [N,4] unit wxyz -> [N,6] upper triangle
    [xx, xy, xz, yy, yz, zz] of Sigma = R^T diag(s^2) R."""
    r, x, y, z = rotation.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0, s1, s2 = ((scale_modifier * scaling) ** 2).unbind(-1)
    return torch.stack([
        s0 * r00 * r00 + s1 * r10 * r10 + s2 * r20 * r20,
        s0 * r00 * r01 + s1 * r10 * r11 + s2 * r20 * r21,
        s0 * r00 * r02 + s1 * r10 * r12 + s2 * r20 * r22,
        s0 * r01 * r01 + s1 * r11 * r11 + s2 * r21 * r21,
        s0 * r01 * r02 + s1 * r11 * r12 + s2 * r21 * r22,
        s0 * r02 * r02 + s1 * r12 * r12 + s2 * r22 * r22,
    ], dim=-1)


class Cov2D(NamedTuple):
    cov: torch.Tensor     # [N,3] (xx, xy, yy) including the +0.3 low-pass
    conic: torch.Tensor   # [N,3] inverse covariance (a, b, c)
    det: torch.Tensor     # [N]
    radius: torch.Tensor  # [N] float 3-sigma pixel radius (ceil applied)


def project_cov3d_to_2d(mean_view: torch.Tensor, cov3d: torch.Tensor,
                        world_view: torch.Tensor, focal_x: float,
                        focal_y: float, tan_fovx: float,
                        tan_fovy: float) -> Cov2D:
    """EWA projection with the reference's clamps (forward.cu:74-113)."""
    tx, ty, tz = mean_view.unbind(-1)
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txz = torch.clamp(tx / tz, -limx, limx) * tz
    tyz = torch.clamp(ty / tz, -limy, limy) * tz

    a = world_view[:3, :3].T  # world->cam rotation (stored transposed)
    v0, v1, v2, v3, v4, v5 = cov3d.unbind(-1)
    t00 = a[0, 0] * v0 + a[0, 1] * v1 + a[0, 2] * v2
    t01 = a[0, 0] * v1 + a[0, 1] * v3 + a[0, 2] * v4
    t02 = a[0, 0] * v2 + a[0, 1] * v4 + a[0, 2] * v5
    t10 = a[1, 0] * v0 + a[1, 1] * v1 + a[1, 2] * v2
    t11 = a[1, 0] * v1 + a[1, 1] * v3 + a[1, 2] * v4
    t12 = a[1, 0] * v2 + a[1, 1] * v4 + a[1, 2] * v5
    t20 = a[2, 0] * v0 + a[2, 1] * v1 + a[2, 2] * v2
    t21 = a[2, 0] * v1 + a[2, 1] * v3 + a[2, 2] * v4
    t22 = a[2, 0] * v2 + a[2, 1] * v4 + a[2, 2] * v5

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * txz * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * tyz * inv_z2

    s00 = t00 * a[0, 0] + t01 * a[0, 1] + t02 * a[0, 2]
    s01 = t00 * a[1, 0] + t01 * a[1, 1] + t02 * a[1, 2]
    s02 = t00 * a[2, 0] + t01 * a[2, 1] + t02 * a[2, 2]
    s11 = t10 * a[1, 0] + t11 * a[1, 1] + t12 * a[1, 2]
    s12 = t10 * a[2, 0] + t11 * a[2, 1] + t12 * a[2, 2]
    s22 = t20 * a[2, 0] + t21 * a[2, 1] + t22 * a[2, 2]

    cxx = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22) + 0.3
    cxy = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    cyy = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22) + 0.3

    det = cxx * cyy - cxy * cxy
    det_inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], dim=-1)

    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))
    return Cov2D(cov=torch.stack([cxx, cxy, cyy], dim=-1), conic=conic,
                 det=det, radius=radius)
