"""Per-Gaussian preprocessing: projection, covariance, conic, radii, tile
rects (counterpart of adgs_tpu/raster/preprocess.py).

`preprocess` runs kernel P1 (csrc/preprocess.cu) where `_kernels.use`
says kernel, inside an autograd Function whose backward is kernel P2;
elsewhere it runs `preprocess_torch`, the plain version, which P1 matches
bit for bit in its integer outputs.
`preprocess_bwd_torch` is P2's plain twin.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels
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


def preprocess_torch(means3d: torch.Tensor, scales: torch.Tensor,
                     rotations: torch.Tensor, opacities: torch.Tensor,
                     shs: Optional[torch.Tensor], settings: RasterSettings,
                     colors_precomp: Optional[torch.Tensor] = None,
                     screen_offset: Optional[torch.Tensor] = None,
                     active_mask: Optional[torch.Tensor] = None
                     ) -> Preprocessed:
    """The plain version of `preprocess`, on any device."""
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


def preprocess(means3d: torch.Tensor, scales: torch.Tensor,
               rotations: torch.Tensor, opacities: torch.Tensor,
               shs: Optional[torch.Tensor], settings: RasterSettings,
               colors_precomp: Optional[torch.Tensor] = None,
               screen_offset: Optional[torch.Tensor] = None,
               active_mask: Optional[torch.Tensor] = None) -> Preprocessed:
    """screen_offset: [N, 2] zeros added to mean2d; its gradient is
    dL/dmean2d, which the densification statistics accumulate.
    P1, and P2 for the gradient, or the plain version, as `_kernels.use`
    says for means3d. The kernels write rgb 0 for a slot that is not
    visible, a constant with no gradient; the plain version evaluates its
    SH colour all the same."""
    if not _kernels.use(means3d):
        return preprocess_torch(means3d, scales, rotations, opacities, shs,
                                settings, colors_precomp=colors_precomp,
                                screen_offset=screen_offset,
                                active_mask=active_mask)
    if opacities.dim() == 2:
        opacities = opacities[..., 0]
    if colors_precomp is not None:
        shs = None
    inputs = (_operand(means3d, 4), _operand(scales, 4),
              _operand(rotations, 16),
              None if shs is None else _operand(shs, 16),
              None if screen_offset is None else _operand(screen_offset, 8))
    opac = _operand(opacities.detach(), 4)
    active = None if active_mask is None else _operand(active_mask, 1)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        out = _Preprocess.apply(*inputs, opac, active, settings)
    else:
        out = _preprocess_fwd(*inputs, opac, active, settings)
    mean2d, depth, conic, rgb, radii, extent, rmin, rmax, tiles, vis = out
    return Preprocessed(
        mean2d=mean2d, depth=depth, conic=conic, opacity=opacities,
        rgb=rgb if colors_precomp is None else colors_precomp, radii=radii,
        extent=extent, rect_min=rmin, rect_max=rmax, tiles_touched=tiles,
        visible=vis)


def _operand(t: torch.Tensor, align: int) -> torch.Tensor:
    """t contiguous, at a multiple of `align` bytes (the kernels load
    rows of 8 and 16 bytes at once); a copy only where it is neither."""
    t = t.contiguous()
    return t if t.data_ptr() % align == 0 else t.clone()


def _camera_args(settings: RasterSettings, n: int, k: int):
    """The camera's pointers (its matrices read at their strides) and the
    float32 constants and integers of adgs_preprocess_fwd / _bwd, rounded
    as the plain version rounds them: Python floats as float32, x / s by a
    CPU scalar as x * float32(1 / s) (PyTorch's division of a CUDA tensor
    by a CPU scalar)."""
    if not 0 <= settings.sh_degree <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got "
                         f"{settings.sh_degree}")
    if k and (settings.sh_degree + 1) ** 2 > k:
        raise ValueError(f"preprocess: SH degree {settings.sh_degree} needs "
                         f"{(settings.sh_degree + 1) ** 2} coefficients, the "
                         f"rows hold {k}")
    cam, strides = [], []
    for name in ("viewmatrix", "projmatrix", "campos"):
        t = getattr(settings, name)
        if not (t.is_cuda and t.dtype == torch.float32 and t.shape == (
                (4, 4) if name != "campos" else (3,))):
            raise ValueError(f"{name}: expected a float32 CUDA tensor of "
                             f"that shape, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        cam.append(t.data_ptr())
        strides += t.stride()
    one = np.float32(1.0)
    consts = np.array([settings.image_width, settings.image_height,
                       settings.focal_x, settings.focal_y, -settings.focal_x,
                       -settings.focal_y, 1.3 * settings.tanfovx,
                       1.3 * settings.tanfovy, settings.scale_modifier,
                       one / np.float32(TILE_X), one / np.float32(TILE_Y),
                       one / np.float32(9.0)], np.float32)
    ints = np.array([n, k, settings.grid_x, settings.grid_y,
                     settings.sh_degree] + strides, np.int64)
    return cam, consts, ints


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _preprocess_fwd(means3d, scales, rotations, shs, screen_offset, opac,
                    active, settings):
    """One launch of P1 (each operand as `preprocess` prepares it): mean2d,
    depth, conic, rgb, radii, extent, rect_min, rect_max, tiles_touched,
    visible."""
    n = means3d.shape[0]
    k = 0 if shs is None else shs.shape[1]
    _kernels.require(means3d, "means3d", torch.float32, (n, 3))
    _kernels.require(scales, "scales", torch.float32, (n, 3))
    _kernels.require(rotations, "rotations", torch.float32, (n, 4))
    _kernels.require(opac, "opacities", torch.float32, (n,))
    if shs is not None:
        _kernels.require(shs, "shs", torch.float32, (n, k, 3))
    if screen_offset is not None:
        _kernels.require(screen_offset, "screen_offset", torch.float32,
                         (n, 2))
    if active is not None:
        _kernels.require(active, "active_mask", torch.bool, (n,))
    cam, consts, ints = _camera_args(settings, n, k)
    f32 = dict(dtype=torch.float32, device=means3d.device)
    i32 = dict(dtype=torch.int32, device=means3d.device)
    out = (torch.empty((n, 2), **f32), torch.empty((n,), **f32),
           torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
           torch.empty((n,), **f32), torch.empty((n, 2), **f32),
           torch.empty((n, 2), **i32), torch.empty((n, 2), **i32),
           torch.empty((n,), **i32),
           torch.empty((n,), dtype=torch.bool, device=means3d.device))
    ptrs = np.array(cam + [_ptr(t) for t in (
        means3d, scales, rotations, opac, shs, screen_offset, active)]
        + [t.data_ptr() for t in out], np.int64)
    err = _kernels.entry("preprocess", "adgs_preprocess_fwd", "pppp")(
        ptrs.ctypes.data, consts.ctypes.data, ints.ctypes.data,
        _kernels.stream(means3d))
    _kernels.check(err, "preprocess")
    _kernels.launches["preprocess"] += 1
    return out


def _preprocess_bwd(means3d, scales, rotations, shs, settings, g_mean2d,
                    g_depth, g_conic, g_rgb, radii):
    """One launch of P2: dL/d(means3d, scales, rotations, shs) (None for
    shs without SH) from dL/d(mean2d, depth, conic, rgb), rgb's taken
    only where P1's `radii` are above 0 (its visible slots)."""
    n = means3d.shape[0]
    k = 0 if shs is None else shs.shape[1]
    grads = [g.contiguous() for g in (g_mean2d, g_depth, g_conic, g_rgb)]
    for g, name, shape in zip(grads, ("mean2d", "depth", "conic", "rgb"),
                              ((n, 2), (n,), (n, 3), (n, 3))):
        _kernels.require(g, f"dL/d{name}", torch.float32, shape)
    _kernels.require(radii, "radii", torch.float32, (n,))
    cam, consts, ints = _camera_args(settings, n, k)
    out = (torch.empty_like(means3d), torch.empty_like(scales),
           torch.empty_like(rotations),
           None if shs is None else torch.empty_like(shs))
    ptrs = np.array(cam + [_ptr(t) for t in (means3d, scales, rotations,
                                             shs)]
                    + [t.data_ptr() for t in grads[:3]]
                    + [0 if shs is None else grads[3].data_ptr()]
                    + [_ptr(t) for t in out] + [radii.data_ptr()],
                    np.int64)
    err = _kernels.entry("preprocess_bwd", "adgs_preprocess_bwd", "pppp")(
        ptrs.ctypes.data, consts.ctypes.data, ints.ctypes.data,
        _kernels.stream(means3d))
    _kernels.check(err, "preprocess_bwd")
    _kernels.launches["preprocess_bwd"] += 1
    return out


class _Preprocess(torch.autograd.Function):
    """P1 forward, P2 backward: differentiable in mean2d, depth, conic and
    rgb with respect to means3d, scales, rotations, shs and screen_offset
    (whose gradient is dL/dmean2d itself). P2 recomputes the forward's
    intermediates, so only the inputs and the radii (above 0 where rgb is
    not the constant 0; the caller keeps them anyway) are saved."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, shs, screen_offset, opac,
                active, settings):
        out = _preprocess_fwd(means3d, scales, rotations, shs, screen_offset,
                              opac, active, settings)
        ctx.save_for_backward(means3d, scales, rotations, shs, out[4])
        ctx.settings = settings
        ctx.mark_non_differentiable(*out[4:])
        return out

    @staticmethod
    def backward(ctx, g_mean2d, g_depth, g_conic, g_rgb, *_):
        means3d, scales, rotations, shs, radii = ctx.saved_tensors
        g_m, g_s, g_r, g_sh = _preprocess_bwd(
            means3d, scales, rotations, shs, ctx.settings, g_mean2d, g_depth,
            g_conic, g_rgb, radii)
        g_off = g_mean2d if ctx.needs_input_grad[4] else None
        return g_m, g_s, g_r, g_sh, g_off, None, None, None


def preprocess_bwd_torch(means3d, scales, rotations, shs, settings, g_mean2d,
                         g_depth, g_conic, g_rgb, radii=None):
    """Plain twin of P2, on any device: dL/d(means3d, scales, rotations,
    shs) (None for shs when shs is None) of `preprocess_torch`'s mean2d,
    depth, conic and rgb, by the closed-form chain rule in the kernel's
    steps, from the forward's intermediates recomputed in the plain
    version's order. With `radii`, rgb is P1's, 0 off the visible slots:
    its gradient is taken only where the radius is above 0. A slot whose
    incoming gradients are all zero gets exact zeros."""
    if radii is not None:
        g_rgb = torch.where(radii[:, None] > 0.0, g_rgb, 0.0)
    V, P = settings.viewmatrix, settings.projmatrix
    # the forward (preprocess_torch, core/covariance.py)
    p_view = transform_point_4x3(means3d, V)
    in_front = p_view[:, 2] > 0.2
    p_hom = transform_point_4x4(means3d, P)
    pw = 1.0 / (p_hom[:, 3] + 1e-7)
    tx = torch.where(in_front, p_view[:, 0], 0.0)
    ty = torch.where(in_front, p_view[:, 1], 0.0)
    tz = torch.where(in_front, p_view[:, 2], 1.0)
    r, x, y, z = rotations.unbind(-1)
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
         [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
         [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)]]
    sm = settings.scale_modifier * scales
    sq = (sm ** 2).unbind(-1)
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    v = [sq[0] * R[0][i] * R[0][j] + sq[1] * R[1][i] * R[1][j]
         + sq[2] * R[2][i] * R[2][j] for i, j in pairs]
    limx, limy = 1.3 * settings.tanfovx, 1.3 * settings.tanfovy
    rx, ry = tx / tz, ty / tz
    cx = torch.clamp(rx, -limx, limx)
    cy = torch.clamp(ry, -limy, limy)
    txz, tyz = cx * tz, cy * tz
    a = V[:3, :3].T
    col = ((v[0], v[1], v[2]), (v[1], v[3], v[4]), (v[2], v[4], v[5]))
    t = [[a[i, 0] * col[j][0] + a[i, 1] * col[j][1] + a[i, 2] * col[j][2]
          for j in range(3)] for i in range(3)]
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    fx, fy = settings.focal_x, settings.focal_y
    j00, j11 = fx * inv_z, fy * inv_z
    j02 = -fx * txz * inv_z2
    j12 = -fy * tyz * inv_z2

    def s_(i, j):
        return t[i][0] * a[j, 0] + t[i][1] * a[j, 1] + t[i][2] * a[j, 2]

    s00, s01, s02 = s_(0, 0), s_(0, 1), s_(0, 2)
    s11, s12, s22 = s_(1, 1), s_(1, 2), s_(2, 2)
    A, B = j00 * s00 + j02 * s02, j00 * s02 + j02 * s22
    C, D = j11 * s01 + j12 * s02, j11 * s12 + j12 * s22
    E, F = j11 * s11 + j12 * s12, j11 * s12 + j12 * s22
    cxx = j00 * A + j02 * B + 0.3
    cxy = j00 * C + j02 * D
    cyy = j11 * E + j12 * F + 0.3
    det = cxx * cyy - cxy * cxy
    det_inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)

    # conic = (cyy, -cxy, cxx) / det
    ga, gb, gc = g_conic.unbind(-1)
    gdinv = ga * cyy + gb * (-cxy) + gc * cxx
    gdet = torch.where(det != 0.0, -gdinv * (det_inv * det_inv), 0.0)
    gcxx = gc * det_inv + gdet * cyy
    gcyy = ga * det_inv + gdet * cxx
    gcxy = -(gb * det_inv) + -2.0 * gdet * cxy
    gA, gB, gC = gcxx * j00, gcxx * j02, gcxy * j00
    gD, gE, gF = gcxy * j02, gcyy * j11, gcyy * j12
    gj00 = gcxx * A + gcxy * C + gA * s00 + gB * s02
    gj02 = gcxx * B + gcxy * D + gA * s02 + gB * s22
    gj11 = gcyy * E + gC * s01 + gD * s12 + gE * s11 + gF * s12
    gj12 = gcyy * F + gC * s02 + gD * s22 + gE * s12 + gF * s22
    gs = {(0, 0): gA * j00, (0, 1): gC * j11,
          (0, 2): gA * j02 + gB * j00 + gC * j12, (1, 1): gE * j11,
          (1, 2): gD * j11 + gE * j12 + gF * j11,
          (2, 2): gB * j02 + gD * j12 + gF * j12}
    gt = [[sum(gs[(i, c)] * a[c, k] for c in range(3) if (i, c) in gs)
           for k in range(3)] for i in range(3)]
    gS = [[a[0, k] * gt[0][c] + a[1, k] * gt[1][c] + a[2, k] * gt[2][c]
           for c in range(3)] for k in range(3)]
    gv = [gS[0][0], gS[0][1] + gS[1][0], gS[0][2] + gS[2][0], gS[1][1],
          gS[1][2] + gS[2][1], gS[2][2]]
    gR, g_scales = [], []
    for k in range(3):
        r0, r1, r2 = R[k]
        gsq = (gv[0] * r0 * r0 + gv[1] * r0 * r1 + gv[2] * r0 * r2
               + gv[3] * r1 * r1 + gv[4] * r1 * r2 + gv[5] * r2 * r2)
        g_scales.append(gsq * (2.0 * sm[:, k]) * settings.scale_modifier)
        gR.append([sq[k] * (2.0 * gv[0] * r0 + gv[1] * r1 + gv[2] * r2),
                   sq[k] * (gv[1] * r0 + 2.0 * gv[3] * r1 + gv[4] * r2),
                   sq[k] * (gv[2] * r0 + gv[4] * r1 + 2.0 * gv[5] * r2)])
    g_rot = torch.stack([
        2.0 * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] - x * gR[1][2]
               - y * gR[2][0] + x * gR[2][1]),
        2.0 * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0]
               - 2.0 * x * gR[1][1] - r * gR[1][2] + z * gR[2][0]
               + r * gR[2][1] - 2.0 * x * gR[2][2]),
        2.0 * (-2.0 * y * gR[0][0] + x * gR[0][1] + r * gR[0][2]
               + x * gR[1][0] + z * gR[1][2] - r * gR[2][0] + z * gR[2][1]
               - 2.0 * y * gR[2][2]),
        2.0 * (-2.0 * z * gR[0][0] - r * gR[0][1] + x * gR[0][2]
               + r * gR[1][0] - 2.0 * z * gR[1][1] + y * gR[1][2]
               + x * gR[2][0] + y * gR[2][1])], dim=-1)
    # J, the frustum clamps (inclusive), safe_view, depth
    gtxz = gj02 * inv_z2 * -fx
    gtyz = gj12 * inv_z2 * -fy
    ginv_z2 = gj02 * (txz * -fx) + gj12 * (tyz * -fy)
    ginv_z = gj00 * fx + gj11 * fy + 2.0 * ginv_z2 * inv_z
    grx = torch.where((rx >= -limx) & (rx <= limx), gtxz * tz, 0.0)
    gry = torch.where((ry >= -limy) & (ry <= limy), gtyz * tz, 0.0)
    gtz = (-ginv_z * (inv_z * inv_z) + gtxz * cx + gtyz * cy
           - grx * (rx / tz) - gry * (ry / tz))
    gpv = torch.stack([torch.where(in_front, grx / tz, 0.0),
                       torch.where(in_front, gry / tz, 0.0),
                       torch.where(in_front, gtz, 0.0) + g_depth], dim=-1)
    # mean2d = ((p_hom . w + 1) size - 1) / 2
    gpp0 = g_mean2d[:, 0] * 0.5 * settings.image_width
    gpp1 = g_mean2d[:, 1] * 0.5 * settings.image_height
    gpw = gpp0 * p_hom[:, 0] + gpp1 * p_hom[:, 1]
    gph = torch.stack([gpp0 * pw, gpp1 * pw, -gpw * (pw * pw)], dim=-1)
    g_means = gpv @ V[:3, :3].T + gph @ P[:3, [0, 1, 3]].T

    work = ((g_mean2d != 0).any(-1) | (g_depth != 0)
            | (g_conic != 0).any(-1))
    g_shs = None
    if shs is not None:
        need = (g_rgb != 0).any(-1)
        work = work | need
        deg = settings.sh_degree
        kd = (deg + 1) ** 2
        d = means3d - settings.campos
        dsq = torch.sum(d * d, dim=-1, keepdim=True)
        zero = dsq == 0.0
        nrm = torch.sqrt(torch.where(zero, torch.ones_like(dsq), dsq))
        den = torch.where(zero, torch.ones_like(nrm), nrm)
        u = d / den
        basis = sh_lib.sh_basis(deg, u)
        raw = torch.sum(basis[:, :, None] * shs[:, :kd, :], dim=1) + 0.5
        graw = torch.where(raw >= 0.0, g_rgb, 0.0)
        g_shs = torch.zeros_like(shs)
        g_shs[:, :kd] = basis[:, :, None] * graw[:, None, :]
        gbk = torch.sum(shs[:, :kd, :] * graw[:, None, :], dim=-1)
        gu = _sh_basis_vjp(deg, u, gbk)
        gd = gu / den - torch.where(
            zero, 0.0, torch.sum(gu * (u / den), dim=-1, keepdim=True)
            / (2.0 * nrm) * 2.0 * d)
        g_means = g_means + torch.where(need[:, None], gd, 0.0)
        g_shs = torch.where(work[:, None, None], g_shs, 0.0)

    def zeroed(g):
        return torch.where(work[:, None], g, 0.0)

    return (zeroed(g_means), zeroed(torch.stack(g_scales, dim=-1)),
            zeroed(g_rot), g_shs)


def _sh_basis_vjp(deg: int, u: torch.Tensor, gb: torch.Tensor):
    """sum_k gb[:, k] d basis_k / d u, for sh_lib.sh_basis at unit dirs u
    [N, 3] and gb [N, (deg + 1)^2] -> [N, 3]."""
    x, y, z = u.unbind(-1)
    zero = torch.zeros_like(x)
    gx, gy, gz = zero, zero, zero
    if deg > 0:
        c1 = sh_lib.SH_C1
        gx = -c1 * gb[:, 3]
        gy = -c1 * gb[:, 1]
        gz = c1 * gb[:, 2]
    if deg > 1:
        c2 = sh_lib.SH_C2
        gx = (gx + c2[0] * y * gb[:, 4] + c2[2] * (-2.0 * x) * gb[:, 6]
              + c2[3] * z * gb[:, 7] + c2[4] * (2.0 * x) * gb[:, 8])
        gy = (gy + c2[0] * x * gb[:, 4] + c2[1] * z * gb[:, 5]
              + c2[2] * (-2.0 * y) * gb[:, 6] + c2[4] * (-2.0 * y) * gb[:, 8])
        gz = (gz + c2[1] * y * gb[:, 5] + c2[2] * (4.0 * z) * gb[:, 6]
              + c2[3] * x * gb[:, 7])
    if deg > 2:
        c3 = sh_lib.SH_C3
        xx, yy, zz = x * x, y * y, z * z
        gx = (gx + c3[0] * y * (6.0 * x) * gb[:, 9] + c3[1] * y * z * gb[:, 10]
              + c3[2] * y * (-2.0 * x) * gb[:, 11]
              + c3[3] * z * (-6.0 * x) * gb[:, 12]
              + c3[4] * (4.0 * zz - 3.0 * xx - yy) * gb[:, 13]
              + c3[5] * z * (2.0 * x) * gb[:, 14]
              + c3[6] * (3.0 * xx - 3.0 * yy) * gb[:, 15])
        gy = (gy + c3[0] * (3.0 * xx - 3.0 * yy) * gb[:, 9]
              + c3[1] * x * z * gb[:, 10]
              + c3[2] * (4.0 * zz - xx - 3.0 * yy) * gb[:, 11]
              + c3[3] * z * (-6.0 * y) * gb[:, 12]
              + c3[4] * x * (-2.0 * y) * gb[:, 13]
              + c3[5] * z * (-2.0 * y) * gb[:, 14]
              + c3[6] * x * (-6.0 * y) * gb[:, 15])
        gz = (gz + c3[1] * x * y * gb[:, 10]
              + c3[2] * y * (8.0 * z) * gb[:, 11]
              + c3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * gb[:, 12]
              + c3[4] * x * (8.0 * z) * gb[:, 13]
              + c3[5] * (xx - yy) * gb[:, 14])
    return torch.stack([gx, gy, gz], dim=-1)
