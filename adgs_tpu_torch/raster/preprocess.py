"""Per-Gaussian preprocessing: projection, covariance, conic, radii, tile
rects (counterpart of adgs_tpu/raster/preprocess.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import sh as sh_lib
from ..profiling import copied_in
from ..core.camera import ndc_to_pix, transform_point_4x3, transform_point_4x4
from ..core.covariance import build_cov3d, project_cov3d_to_2d
from .types import RasterSettings, TILE_X, TILE_Y


class Preprocessed(NamedTuple):
    mean2d: torch.Tensor         # [N,2] pixel-space centres
    depth: torch.Tensor          # [N] view-space z
    conic: torch.Tensor          # [N,3] inverse 2D covariance (a,b,c)
    opacity: torch.Tensor        # [N]
    rgb: torch.Tensor            # [N,3] SH colours (clamped)
    radii: torch.Tensor          # [N] float pixel radius (0 = culled)
    extent: torch.Tensor         # [N,2] per-axis half extents (px)
    rect_min: torch.Tensor       # [N,2] int32 tile rect (x, y) inclusive
    rect_max: torch.Tensor       # [N,2] int32 tile rect (x, y) exclusive
    tiles_touched: torch.Tensor  # [N] int32
    visible: torch.Tensor        # [N] bool


def _ifloor(v: torch.Tensor) -> torch.Tensor:
    """int32(floor(v)) with XLA's saturating conversion: NaN -> 0, out of
    range -> the nearest int32 bound."""
    f = torch.floor(v).double().nan_to_num(nan=0.0)
    return f.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64).to(torch.int32)


def get_rect(mean2d: torch.Tensor, extent: torch.Tensor, grid_x: int,
             grid_y: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact float tile coverage of the per-axis extents: the covered
    pixels are [ceil(lo), floor(hi)], the tiles [ceil(lo)//T, floor(hi)//T+1)."""
    rx, ry = extent[..., 0], extent[..., 1]
    mx, my = mean2d[..., 0], mean2d[..., 1]
    rmin_x = torch.clamp(_ifloor(torch.ceil(mx - rx) / TILE_X), 0, grid_x)
    rmin_y = torch.clamp(_ifloor(torch.ceil(my - ry) / TILE_Y), 0, grid_y)
    rmax_x = torch.clamp(_ifloor(torch.floor(mx + rx) / TILE_X) + 1, 0, grid_x)
    rmax_y = torch.clamp(_ifloor(torch.floor(my + ry) / TILE_Y) + 1, 0, grid_y)
    return (torch.stack([rmin_x, rmin_y], dim=-1),
            torch.stack([rmax_x, rmax_y], dim=-1))


def preprocess(means3d: torch.Tensor, scales: torch.Tensor,
               rotations: torch.Tensor, opacities: torch.Tensor,
               shs: Optional[torch.Tensor], settings: RasterSettings,
               colors_precomp: Optional[torch.Tensor] = None,
               screen_offset: Optional[torch.Tensor] = None,
               active_mask: Optional[torch.Tensor] = None) -> Preprocessed:
    """screen_offset: [N, 2] zeros added to mean2d; its gradient is
    dL/dmean2d, which the densification statistics accumulate."""
    if opacities.dim() == 2:
        opacities = opacities[..., 0]

    p_view = transform_point_4x3(means3d, settings.viewmatrix)
    in_front = p_view[..., 2] > 0.2

    p_hom = transform_point_4x4(means3d, settings.projmatrix)
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    p_proj = p_hom[..., :3] * p_w[..., None]
    mean2d = torch.stack([ndc_to_pix(p_proj[..., 0], settings.image_width),
                          ndc_to_pix(p_proj[..., 1], settings.image_height)],
                         dim=-1)
    if screen_offset is not None:
        mean2d = mean2d + screen_offset

    cov3d = build_cov3d(scales, rotations, settings.scale_modifier)
    forward = p_view.new_tensor([0.0, 0.0, 1.0])
    copied_in(forward)
    safe_view = torch.where(in_front[..., None], p_view, forward)
    c2 = project_cov3d_to_2d(safe_view, cov3d, settings.viewmatrix,
                             settings.focal_x, settings.focal_y,
                             settings.tanfovx, settings.tanfovy)

    # exact AABB of the 3-sigma ellipse, shrunk to the opacity-aware
    # support q <= 2 ln(255 op) (+1e-3 slack) where alpha can clear 1/255
    extent = 3.0 * torch.sqrt(torch.clamp(c2.cov[..., 0::2], min=0.0))
    q_max = 2.0 * torch.log(255.0 * torch.clamp(opacities, min=1e-30)) + 1e-3
    # detached, as JAX's stop_gradient: the support bound is integer
    # plumbing, not a differentiable quantity
    shrink = torch.sqrt(torch.clamp(q_max, 0.0, 9.0) / 9.0).detach()
    extent = extent * shrink[..., None]
    # peak alpha below the gate contributes nothing anywhere
    alive_op = opacities * 255.0 >= 1.0 - 1e-5
    rect_min, rect_max = get_rect(mean2d, extent, settings.grid_x,
                                  settings.grid_y)
    tiles = ((rect_max[..., 0] - rect_min[..., 0])
             * (rect_max[..., 1] - rect_min[..., 1]))

    visible = in_front & (c2.det != 0.0) & (tiles > 0) & alive_op
    if active_mask is not None:
        visible = visible & active_mask
    radius = torch.where(visible, c2.radius, torch.zeros_like(c2.radius))
    tiles_touched = torch.where(visible, tiles,
                                torch.zeros_like(tiles)).to(torch.int32)

    if colors_precomp is not None:
        rgb = colors_precomp
    elif shs is not None:
        rgb, _ = sh_lib.eval_sh_color(settings.sh_degree, shs, means3d,
                                      settings.campos)
    else:
        rgb = means3d.new_zeros(means3d.shape[:-1] + (3,))

    return Preprocessed(mean2d=mean2d, depth=p_view[..., 2], conic=c2.conic,
                        opacity=opacities, rgb=rgb, radii=radius,
                        extent=extent, rect_min=rect_min, rect_max=rect_max,
                        tiles_touched=tiles_touched, visible=visible)
