"""Compositing forward over binned instances (counterpart of
adgs_tpu/raster/pallas/render.py:116-155, 1232-1279).

`composite_fwd` is kernel B3 (csrc/composite.cu) on CUDA tensors and its
plain twin `composite_fwd_torch` on CPU tensors. Both read packed
per-Gaussian rows [N, F] (8 geometry columns: mean2d, conic, log-opacity,
2 pad; then ch features padded to a multiple of 8) and return the JAX
kernel's layout: blended [T, ch, 256] and final_t [T, 256].

Forward only: the autograd Function over the backward kernels belongs to
the training path.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _kernels
from . import composite as composite_mod
from .binning import Binning
from .preprocess import Preprocessed
from .types import RasterOutput, RasterSettings, TILE_PIX, TILE_X, TILE_Y

F_GEOM = 8
OP_FLOOR = 1e-37   # log(max(op, OP_FLOOR)) keeps dead slots finite
# plain twin: elements of one [tiles, 256, instances] temporary
PLAIN_BATCH_ELEMS = 1 << 25


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def pack_gaussian_rows(mean2d, conic, log_opacity, features):
    """[N, F] rows: mean2d, conic, log-opacity, 2 zero columns, features,
    zero-padded so F = 8 + round8(ch)."""
    n = mean2d.shape[0]
    ch = features.shape[-1]
    F = F_GEOM + _round8(ch)
    z = mean2d.new_zeros
    cols = [mean2d, conic, log_opacity[:, None], z((n, 2)), features]
    if F - F_GEOM - ch:
        cols.append(z((n, F - F_GEOM - ch)))
    return torch.cat(cols, dim=-1).contiguous(), F


def _tile_batches(tile_count: torch.Tensor, budget: int):
    """Consecutive tile ranges whose [tiles, 256, max count] temporaries
    stay within `budget` elements."""
    counts = tile_count.cpu().tolist()
    out, lo, m = [], 0, 1
    for i, c in enumerate(counts):
        grown = max(m, c)
        if i > lo and (i + 1 - lo) * TILE_PIX * grown > budget:
            out.append((lo, i))
            lo, m = i, max(c, 1)
        else:
            m = grown
    out.append((lo, len(counts)))
    return out


def composite_fwd_torch(packed: torch.Tensor, ch: int, gauss_id: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        grid_x: int, count_pairs: bool = False):
    """Plain twin of kernel B3: every tile's whole instance list at once,
    alpha gated as in the kernel and weights from composite.blend_weights
    (log-space prefix sums instead of the kernel's running product, so the
    two agree to ~1e-5, not bitwise). Tiles run in batches bounded by
    PLAIN_BATCH_ELEMS to bound memory.

    count_pairs=True also returns the number of (instance, pixel) pairs the
    sequential loop evaluates: each pixel's instances up to and including
    the one that ends it."""
    T = tile_start.shape[0]
    dev = packed.device
    R = gauss_id.shape[0]
    blended = packed.new_zeros((T, ch, TILE_PIX))
    final_t = packed.new_ones((T, TILE_PIX))
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    pix = torch.arange(TILE_PIX, device=dev)
    ox = (pix % TILE_X).to(torch.float32)
    oy = (pix // TILE_X).to(torch.float32)
    for lo, hi in _tile_batches(tile_count, PLAIN_BATCH_ELEMS):
        cnt = tile_count[lo:hi].long()
        m = int(cnt.max()) if hi > lo else 0
        if m == 0:
            continue
        t = torch.arange(lo, hi, device=dev)
        j = torch.arange(m, device=dev)
        in_range = j[None, :] < cnt[:, None]                     # [G, M]
        idx = torch.clamp(tile_start[lo:hi, None].long() + j[None, :], 0,
                          R - 1)
        rows = packed[gauss_id[idx].long()]                      # [G, M, F]
        px = ((t % grid_x) * TILE_X).to(torch.float32)[:, None] + ox
        py = ((t // grid_x) * TILE_Y).to(torch.float32)[:, None] + oy
        dx = rows[:, None, :, 0] - px[:, :, None]                # [G, P, M]
        dy = rows[:, None, :, 1] - py[:, :, None]
        power = (-0.5 * (rows[:, None, :, 2] * dx * dx
                         + rows[:, None, :, 4] * dy * dy)
                 - rows[:, None, :, 3] * dx * dy)
        alpha = torch.clamp(torch.exp(rows[:, None, :, 5] + power),
                            max=composite_mod.ALPHA_MAX)
        gate = ((power > 0.0) | (alpha < composite_mod.ALPHA_MIN)
                | ~in_range[:, None, :])
        alpha = torch.where(gate, torch.zeros_like(alpha), alpha)
        bw = composite_mod.blend_weights(alpha)
        feats = rows[:, :, F_GEOM:F_GEOM + ch]                   # [G, M, ch]
        blended[lo:hi] = torch.matmul(bw.weights, feats).transpose(1, 2)
        final_t[lo:hi] = bw.t_eff
        if count_pairs:
            inc = bw.include & in_range[:, None, :]
            n_inc = inc.sum(-1)
            ended = n_inc < cnt[:, None]
            pairs += (n_inc + ended.long()).sum()
    if count_pairs:
        return blended, final_t, pairs
    return blended, final_t


def composite_fwd(packed: torch.Tensor, ch: int, gauss_id: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  grid_x: int):
    """Kernel B3 on CUDA tensors; its plain twin on CPU tensors."""
    if packed.device.type == "cpu":
        return composite_fwd_torch(packed, ch, gauss_id, tile_start,
                                   tile_count, grid_x)
    n, F = packed.shape
    if not 1 <= ch <= 8 or F != F_GEOM + _round8(ch):
        raise ValueError(f"composite_fwd: ch={ch} with F={F} unsupported")
    T = tile_start.shape[0]
    _kernels.require(packed, "packed", torch.float32, (n, F))
    _kernels.require(gauss_id, "gauss_id", torch.int32)
    _kernels.require(tile_start, "tile_start", torch.int32, (T,))
    _kernels.require(tile_count, "tile_count", torch.int32, (T,))
    out = torch.empty((T, ch + 1, TILE_PIX), dtype=torch.float32,
                      device=packed.device)
    fn = _kernels.library("composite_fwd").adgs_composite_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    p = _kernels.ptr
    err = fn(p(packed), F, p(gauss_id), p(tile_start), p(tile_count), T,
             grid_x, ch, p(out), _kernels.stream(packed.device))
    _kernels.check(err, "composite_fwd")
    _kernels.launches["composite_fwd"] += 1
    return out[:, :ch, :], out[:, ch, :]


def tiles_to_image(tile_px: torch.Tensor,
                   settings: RasterSettings) -> torch.Tensor:
    """[T, P, CH] -> [CH, H, W] (crops the tile padding)."""
    gy, gx = settings.grid_y, settings.grid_x
    ch = tile_px.shape[-1]
    img = tile_px.reshape(gy, gx, TILE_Y, TILE_X, ch)
    img = img.permute(0, 2, 1, 3, 4).reshape(gy * TILE_Y, gx * TILE_X, ch)
    img = img[: settings.image_height, : settings.image_width]
    return img.permute(2, 0, 1)


def _render(prep: Preprocessed, binning: Binning, settings: RasterSettings,
            flow_points, semantic, composite) -> RasterOutput:
    feats = [prep.rgb, composite_mod.depth_feature(
        prep.depth, settings.inv_depth)[:, None]]
    if flow_points is not None:
        feats.append(flow_points)
    if semantic is not None:
        feats.append(semantic)
    features = torch.cat(feats, dim=-1)
    opac = torch.where(prep.visible, prep.opacity,
                       torch.zeros_like(prep.opacity))
    log_op = torch.log(torch.clamp(opac, min=OP_FLOOR))
    packed, _ = pack_gaussian_rows(prep.mean2d, prep.conic, log_op, features)
    blended, t_final = composite(packed, features.shape[-1],
                                 binning.gauss_id, binning.tile_start,
                                 binning.tile_count, settings.grid_x)
    blended = blended.transpose(1, 2)                   # [T, P, CH]

    color_t = blended[..., :3] + t_final[..., None] * settings.bg
    color = tiles_to_image(color_t, settings)
    depth = tiles_to_image(blended[..., 3:4], settings)
    opacity = tiles_to_image(1.0 - t_final[..., None], settings)
    chc = 4
    flow_img = sem_img = None
    if flow_points is not None:
        flow_img = tiles_to_image(blended[..., chc:chc + 3], settings)
        chc += 3
    if semantic is not None:
        sem_img = tiles_to_image(
            blended[..., chc:chc + semantic.shape[-1]], settings)
    return RasterOutput(color=color, radii=prep.radii.to(torch.int32),
                        depth=depth, opacity=opacity, flow=flow_img,
                        semantic=sem_img)


@torch.no_grad()
def render_cuda(prep: Preprocessed, binning: Binning,
                settings: RasterSettings,
                flow_points: Optional[torch.Tensor] = None,
                semantic: Optional[torch.Tensor] = None) -> RasterOutput:
    """Composite through kernel B3 (its plain twin on CPU tensors)."""
    return _render(prep, binning, settings, flow_points, semantic,
                   composite_fwd)


@torch.no_grad()
def render_torch(prep: Preprocessed, binning: Binning,
                 settings: RasterSettings,
                 flow_points: Optional[torch.Tensor] = None,
                 semantic: Optional[torch.Tensor] = None) -> RasterOutput:
    """Composite through the plain twin on any device."""
    return _render(prep, binning, settings, flow_points, semantic,
                   composite_fwd_torch)
