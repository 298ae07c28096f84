"""Compositing over binned instances, forward and backward (counterpart of
adgs_tpu/raster/pallas/render.py: composite_packed, its VJP and
render_pallas).

Four kernels, each beside its plain twin; a wrapper launches the kernel
or runs the twin as `_kernels.use` says:
  - B3 `composite_fwd` (csrc/composite.cu) / `composite_fwd_torch`: packed
    per-Gaussian rows [N, F] (8 geometry columns: mean2d, conic,
    log-opacity, 2 pad; then ch features padded to a multiple of 8) ->
    blended [T, ch, 256] and final_t [T, 256], the JAX kernel's layout;
    its blocks take the tiles longest first, and its warps skip the
    instances that `quarter_masks_torch` rules out of their 8x8 quarter;
  - B4 `composite_bwd` (csrc/composite_bwd.cu) / `composite_bwd_torch`:
    the front-to-back replay -> one gradient row per instance, written to
    its presort slot `slot_sorted[r]` ([R, gc], gc = round8(6 + ch)); its
    blocks take the tiles longest first;
  - B5 `segment_sum` (csrc/segment_sum.cu) / `segment_sum_torch`: the sum
    of each segment of contiguous rows; over `contiguous_bounds` it turns
    B4's presort rows into per-Gaussian gradients;
  - B6 `pad_to_lanes` (csrc/pad_lanes.cu) / `pad_to_lanes_torch`: the
    [F, N] -> [N_pad, 128] transposing lane pad of the rows layout.
`CompositePacked` is the autograd Function over them: B3 forward, B4 then
B5 backward, or the twins, as its forward decided. A Function calls a
kernel's wrapper only where it decided on the kernel, so that a count of
wrapper calls counts launches.

Instance layouts (`layout`, the JAX package's ADGS_RM=0/1):
  - "gather": B3 and B4 read instance r of a tile through gauss_id from
    the packed [N, F] rows;
  - "rows": `build_instances_rows` lane-pads the packed rows with B6 and
    gathers them once into tile order, [R, 128]; B3 and B4 read instance r
    as row tile_start + r. The same values reach the same arithmetic, so
    both layouts give bitwise equal outputs. The backward keeps B4's write
    of each gradient row to its presort slot and B5 in both layouts (the
    JAX package's 128-lane gradient rows and their permute serve its DMA
    fast path and give the same values).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _kernels
from . import composite as composite_mod
from .binning import Binning
from .preprocess import Preprocessed
from .types import RasterOutput, RasterSettings, TILE_PIX, TILE_X, TILE_Y

F_GEOM = 8
LANES = 128        # row width of the rows layout
PAD_BLK = 1024     # B6 pads N up to a multiple of this (the JAX block)
LAYOUTS = ("gather", "rows")
N_GEOM_GRAD = 6    # d mean2d (2), d conic (3), d log-opacity
OP_FLOOR = 1e-37   # log(max(op, OP_FLOOR)) keeps dead slots finite
# csrc/composite_common.cuh kLogAlphaMinSafe (the float -5.6f): below it
# the 1/255 gate rules a pair out for certain
LOG_ALPHA_MIN_SAFE = float(torch.tensor(-5.6, dtype=torch.float32))
# csrc/composite_common.cuh kTEps (the float 1e-4f): the pixel's stop
T_EPS_F32 = float(torch.tensor(composite_mod.T_EPS, dtype=torch.float32))
# plain twins: elements of one [tiles, 256, instances] temporary
PLAIN_BATCH_ELEMS = 1 << 25
SEG_ITEMS = 512      # rows and segment ends of one of B5's blocks
SEG_FAN = 32         # B5's partials a group, at each level (csrc/segment_sum.cu)


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def grad_cols(ch: int) -> int:
    """Columns of a B4 gradient row: 6 geometry + ch features, padded."""
    return _round8(N_GEOM_GRAD + ch)


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


class PairCounts(NamedTuple):
    """(instance, pixel) pairs the sequential compositing loop evaluates."""
    hit: torch.Tensor    # composited: alpha > 0, before the pixel's stop
    gated: torch.Tensor  # alpha gated to 0, plus the pair that stops a pixel
    reach: torch.Tensor  # [T] a tile's instances up to its last pixel's stop
    # of the gated pairs, those in (instance, quarter)s that B3's quarter
    # culling rules out, so that B3 never evaluates them (0 without masks)
    culled: torch.Tensor


class _TileBatch(NamedTuple):
    idx: torch.Tensor       # [G, M] sorted instance index (clamped)
    in_range: torch.Tensor  # [G, M] j < tile_count
    rows: torch.Tensor      # [G, M, F] packed rows of the instances
    dx: torch.Tensor        # [G, P, M] mean.x - px
    dy: torch.Tensor        # [G, P, M]
    e: torch.Tensor         # [G, P, M] exp(log-opacity + power)
    alpha: torch.Tensor     # [G, P, M] gated alpha (0 = skipped)


def _tile_alpha(src, F: int, gauss_id, tile_start, tile_count, lo: int,
                hi: int, m: int, grid_x: int, layout: str) -> _TileBatch:
    """The gated alpha of every (instance, pixel) pair of tiles [lo, hi),
    with csrc/composite_common.cuh's expressions, one PyTorch op per
    rounding. src is the packed [N, F] rows ("gather") or the tile-ordered
    [R, 128] instance rows ("rows"); either way the instances' first F
    columns are fetched into one fresh [G, M, F] tensor, so the two
    layouts run the same arithmetic on the same values."""
    dev = src.device
    R = gauss_id.shape[0]
    cnt = tile_count[lo:hi].long()
    t = torch.arange(lo, hi, device=dev)
    j = torch.arange(m, device=dev)
    in_range = j[None, :] < cnt[:, None]
    idx = torch.clamp(tile_start[lo:hi, None].long() + j[None, :], 0, R - 1)
    if layout == "rows":
        rows = src[:, :F][idx]
    else:
        rows = src[gauss_id[idx].long()]
    pix = torch.arange(TILE_PIX, device=dev)
    px = (((t % grid_x) * TILE_X).to(torch.float32)[:, None]
          + (pix % TILE_X).to(torch.float32))
    py = (((t // grid_x) * TILE_Y).to(torch.float32)[:, None]
          + (pix // TILE_X).to(torch.float32))
    dx = rows[:, None, :, 0] - px[:, :, None]
    dy = rows[:, None, :, 1] - py[:, :, None]
    power = (-0.5 * (rows[:, None, :, 2] * dx * dx
                     + rows[:, None, :, 4] * dy * dy)
             - rows[:, None, :, 3] * dx * dy)
    e = torch.exp(rows[:, None, :, 5] + power)
    alpha = torch.clamp(e, max=composite_mod.ALPHA_MAX)
    gate = ((power > 0.0) | (alpha < composite_mod.ALPHA_MIN)
            | ~in_range[:, None, :])
    alpha = torch.where(gate, torch.zeros_like(alpha), alpha)
    return _TileBatch(idx, in_range, rows, dx, dy, e, alpha)


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown instance layout: {layout}")


def composite_fwd_torch(packed: torch.Tensor, ch: int, gauss_id: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        grid_x: int, count_pairs: bool = False,
                        layout: str = "gather",
                        masks: Optional[torch.Tensor] = None):
    """Plain twin of kernel B3 (`packed` is the instance rows under
    layout "rows"): every tile's whole instance list at once,
    alpha gated as in the kernel and weights from composite.blend_weights
    (log-space prefix sums instead of the kernel's running product, so the
    two agree to ~1e-5, not bitwise). Tiles run in batches bounded by
    PLAIN_BATCH_ELEMS to bound memory. Differentiable by autograd.

    count_pairs=True also returns the PairCounts of the pairs the
    sequential loop evaluates: each pixel's instances up to and including
    the one that ends it, split into composited and gated pairs, and per
    tile the most any of its pixels evaluates; with `masks`
    (quarter_masks_torch's), also the gated pairs that the masks cull."""
    _check_layout(layout)
    T = tile_start.shape[0]
    F = F_GEOM + _round8(ch)
    blended = packed.new_zeros((T, ch, TILE_PIX))
    final_t = packed.new_ones((T, TILE_PIX))
    hit = torch.zeros((), dtype=torch.int64, device=packed.device)
    gated = torch.zeros((), dtype=torch.int64, device=packed.device)
    reach = torch.zeros((T,), dtype=torch.int64, device=packed.device)
    culled = torch.zeros((), dtype=torch.int64, device=packed.device)
    for lo, hi in _tile_batches(tile_count, PLAIN_BATCH_ELEMS):
        cnt = tile_count[lo:hi].long()
        m = int(cnt.max()) if hi > lo else 0
        if m == 0:
            continue
        tb = _tile_alpha(packed, F, gauss_id, tile_start, tile_count, lo, hi,
                         m, grid_x, layout)
        bw = composite_mod.blend_weights(tb.alpha)
        feats = tb.rows[:, :, F_GEOM:F_GEOM + ch]                # [G, M, ch]
        blended[lo:hi] = torch.matmul(bw.weights, feats).transpose(1, 2)
        final_t[lo:hi] = bw.t_eff
        if count_pairs:
            inc = bw.include & tb.in_range[:, None, :]
            n_inc = inc.sum(-1)
            n_hit = (inc & (tb.alpha > 0.0)).sum(-1)
            ended = n_inc < cnt[:, None]
            hit += n_hit.sum()
            gated += (n_inc - n_hit + ended.long()).sum()
            reach[lo:hi] = n_inc.max(-1).values
            if masks is not None:
                culled += (inc & (tb.alpha == 0.0)
                           & ~_quarter_kept(masks, tb.idx)).sum()
    if count_pairs:
        return blended, final_t, PairCounts(hit, gated, reach, culled)
    return blended, final_t


def _quarter_kept(masks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[G, P, M] bool: the quarter of pixel p is kept for instance idx[g, m]
    by `masks` (quarter_masks_torch's)."""
    pix = torch.arange(TILE_PIX, device=idx.device)
    quarter = (pix % TILE_X >= 8).long() + 2 * (pix // TILE_X >= 8).long()
    bits = masks[idx].long()                                  # [G, M]
    return ((bits[:, None, :] >> quarter[None, :, None]) & 1).bool()


def composite_final_t_serial(packed: torch.Tensor, ch: int,
                             gauss_id: torch.Tensor, tile_start: torch.Tensor,
                             tile_count: torch.Tensor, grid_x: int,
                             layout: str = "gather") -> torch.Tensor:
    """B3's final_t [T, 256] as its kernel computes it, for checks only:
    per pixel the running product over the gated alphas of `_tile_alpha`
    (the kernel's bits), pair by pair front to back, with next_t's
    rounding and its stop (T (1 - alpha) below 1e-4 ends the pixel, the
    pair not composited). Bit for bit the kernel's, where
    composite_fwd_torch's log-space prefix sums agree only to ~1e-5: a
    pair with alpha >= 1/255 that the kernel skipped changes its T by a
    factor of at most 1 - 1/255, which a bitwise check cannot miss. One
    step per instance of the longest tile of each batch."""
    _check_layout(layout)
    T = tile_start.shape[0]
    F = F_GEOM + _round8(ch)
    final_t = packed.new_ones((T, TILE_PIX))
    for lo, hi in _tile_batches(tile_count, PLAIN_BATCH_ELEMS):
        m = int(tile_count[lo:hi].max()) if hi > lo else 0
        if m == 0:
            continue
        alpha = _tile_alpha(packed, F, gauss_id, tile_start, tile_count, lo,
                            hi, m, grid_x, layout).alpha
        t = final_t[lo:hi].clone()
        live = torch.ones_like(t, dtype=torch.bool)
        for a in alpha.permute(2, 0, 1).contiguous().unbind(0):
            nt = t * (1.0 - a)
            go = live & (a > 0.0)
            stop = go & (nt < T_EPS_F32)
            t = torch.where(go & ~stop, nt, t)
            live = live & ~stop
        final_t[lo:hi] = t
    return final_t


def quarter_masks_torch(packed: torch.Tensor, gauss_id: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        grid_x: int, layout: str = "gather") -> torch.Tensor:
    """B3's quarter culling (csrc/composite.cu `quarter_mask`, which states
    why it is exact), rendered in float64 for tests and checks: [R] int32,
    for sorted instance r of tile t, bit q set unless no pixel of the 8x8
    quarter (q % 2, q / 2) of tile t can pass the kLogAlphaMinSafe
    pre-test; 0 for the instances past the valid ones."""
    _check_layout(layout)
    R = gauss_id.shape[0]
    dev = packed.device
    T = tile_start.shape[0]
    total = int(tile_start[-1] + tile_count[-1]) if T else 0
    tid = torch.repeat_interleave(torch.arange(T, device=dev),
                                  tile_count.long())
    if layout == "rows":
        src = packed[:total]
    else:
        src = packed[gauss_id[:total].long()]
    g = src[:, :6].double()
    mx, my, a, b, c, lo = g.unbind(-1)
    x0 = ((tid % grid_x) * TILE_X).double()
    y0 = ((tid // grid_x) * TILE_Y).double()
    det = a * c - b * b
    ex = torch.maximum((mx - x0).abs(), (mx - (x0 + 15)).abs())
    ey = torch.maximum((my - y0).abs(), (my - (y0 + 15)).abs())
    e = torch.clamp(torch.maximum(ex, ey), min=1.0)
    coef = torch.maximum(torch.maximum(a.abs(), b.abs()), c.abs())
    keep_all = ~(torch.isfinite(g).all(-1) & (a > 0.0) & (det > 0.0)
                 & (coef * e * e < 1e37))
    t = lo - LOG_ALPHA_MIN_SAFE
    s_max = a.abs() * ex * ex + c.abs() * ey * ey + 2.0 * b.abs() * ex * ey
    tt = t + 4.0 * 2.0 ** -24 * s_max + 1e-4
    hx = torch.sqrt(2.0 * tt * c / det) + 1.0
    hy = torch.sqrt(2.0 * tt * a / det) + 1.0
    mask = torch.zeros_like(tid)
    for q in range(4):
        qx = x0 + (q & 1) * 8
        qy = y0 + (q >> 1) * 8
        reach = ((mx + hx >= qx) & (mx - hx <= qx + 7.0) & (my + hy >= qy)
                 & (my - hy <= qy + 7.0))
        mask |= reach.long() << q
    mask = torch.where(t < 0.0, torch.zeros_like(mask), mask)
    mask = torch.where(keep_all, torch.full_like(mask, 0xF), mask)
    out = torch.zeros(R, dtype=torch.int32, device=dev)
    out[:total] = mask.to(torch.int32)
    return out


def _kernel_src(packed: torch.Tensor, ch: int, gauss_id: torch.Tensor,
                layout: str, name: str) -> int:
    """Check B3's / B4's row operand and return its row stride: the packed
    [N, F] rows ("gather") or the [R, 128] instance rows ("rows")."""
    _check_layout(layout)
    F = F_GEOM + _round8(ch)
    n, ld = packed.shape
    if not 1 <= ch <= 8:
        raise ValueError(f"{name}: ch={ch} unsupported")
    if layout == "rows":
        _kernels.require(packed, "inst", torch.float32,
                         (gauss_id.shape[0], LANES))
    else:
        if ld != F:
            raise ValueError(f"{name}: ch={ch} with F={ld} unsupported")
        _kernels.require(packed, "packed", torch.float32, (n, F))
    return ld


def composite_fwd(packed: torch.Tensor, ch: int, gauss_id: torch.Tensor,
                  tile_start: torch.Tensor, tile_count: torch.Tensor,
                  grid_x: int, layout: str = "gather"):
    """Kernel B3, or its plain twin where `_kernels.use` says so. `packed`
    is the instance rows under layout "rows"."""
    if not _kernels.use(packed):
        return composite_fwd_torch(packed, ch, gauss_id, tile_start,
                                   tile_count, grid_x, layout=layout)
    ld = _kernel_src(packed, ch, gauss_id, layout, "composite_fwd")
    T = tile_start.shape[0]
    _kernels.require(gauss_id, "gauss_id", torch.int32)
    _kernels.require(tile_start, "tile_start", torch.int32, (T,))
    _kernels.require(tile_count, "tile_count", torch.int32, (T,))
    out = torch.empty((T, ch + 1, TILE_PIX), dtype=torch.float32,
                      device=packed.device)
    order = torch.empty((T,), dtype=torch.int32, device=packed.device)
    fn = _kernels.entry("composite_fwd", "adgs_composite_fwd", "piippppiiipp")
    err = fn(packed.data_ptr(), ld, int(layout == "rows"), gauss_id.data_ptr(),
             tile_start.data_ptr(), tile_count.data_ptr(), order.data_ptr(), T,
             grid_x, ch, out.data_ptr(), _kernels.stream(packed))
    _kernels.check(err, "composite_fwd")
    _kernels.launches["composite_fwd"] += 1
    return out[:, :ch, :], out[:, ch, :]


def composite_bwd_torch(packed: torch.Tensor, ch: int,
                        gauss_id: torch.Tensor, slot_sorted: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        grid_x: int, fwd_out: torch.Tensor,
                        g_out: torch.Tensor,
                        layout: str = "gather") -> torch.Tensor:
    """Plain twin of kernel B4 (`packed` is the instance rows under layout
    "rows"). fwd_out and g_out are [T, ch+1, 256]: the
    forward's blended channels and final T, and their cotangents. Returns
    [R, gc] gradient rows in presort order (csrc/composite_bwd.cu states
    the formulas); rows of instances that no pixel reached are zero. The
    replay is the forward twin's: log-space blend_weights."""
    _check_layout(layout)
    R = gauss_id.shape[0]
    F = F_GEOM + _round8(ch)
    gc = grad_cols(ch)
    out = packed.new_zeros((R, gc))
    for lo, hi in _tile_batches(tile_count, PLAIN_BATCH_ELEMS):
        m = int(tile_count[lo:hi].max()) if hi > lo else 0
        if m == 0:
            continue
        tb = _tile_alpha(packed, F, gauss_id, tile_start, tile_count, lo, hi,
                         m, grid_x, layout)
        alpha = tb.alpha
        bw = composite_mod.blend_weights(alpha)
        gf = g_out[lo:hi, :ch]                                   # [G, ch, P]
        A = (fwd_out[lo:hi, :ch] * gf).sum(1)                    # [G, P]
        gt_tfin = g_out[lo:hi, ch] * fwd_out[lo:hi, ch]          # [G, P]
        feats = tb.rows[:, :, F_GEOM:F_GEOM + ch]                # [G, M, ch]
        fg = torch.matmul(gf.transpose(1, 2), feats.transpose(1, 2))
        prefix = torch.cumsum(bw.weights * fg, dim=-1)           # [G, P, M]
        inv = 1.0 / (1.0 - alpha)
        d_alpha = (bw.t_excl * fg - (A[..., None] - prefix) * inv
                   - gt_tfin[..., None] * inv)
        d_alpha = torch.where(bw.include & (alpha > 0.0), d_alpha,
                              torch.zeros_like(d_alpha))
        dp = torch.where(tb.e < composite_mod.ALPHA_MAX, d_alpha * alpha,
                         torch.zeros_like(d_alpha))
        a = tb.rows[:, None, :, 2]
        b = tb.rows[:, None, :, 3]
        c = tb.rows[:, None, :, 4]
        dx, dy = tb.dx, tb.dy
        geom = torch.stack([
            -(dp * (a * dx + b * dy)).sum(1),
            -(dp * (c * dy + b * dx)).sum(1),
            (-0.5 * dp * dx * dx).sum(1),
            (-dp * dx * dy).sum(1),
            (-0.5 * dp * dy * dy).sum(1),
            dp.sum(1)], dim=-1)                                  # [G, M, 6]
        d_f = torch.matmul(bw.weights.transpose(1, 2),
                           gf.transpose(1, 2))                   # [G, M, ch]
        vals = torch.cat([geom, d_f], dim=-1)
        sel = tb.in_range
        out[slot_sorted[tb.idx[sel]].long(), :vals.shape[-1]] = vals[sel]
    return out


def composite_bwd(packed: torch.Tensor, ch: int, gauss_id: torch.Tensor,
                  slot_sorted: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, grid_x: int,
                  fwd_out: torch.Tensor, g_out: torch.Tensor,
                  layout: str = "gather") -> torch.Tensor:
    """Kernel B4, or its plain twin where `_kernels.use` says so. `packed`
    is the instance rows under layout "rows"."""
    if not _kernels.use(packed):
        return composite_bwd_torch(packed, ch, gauss_id, slot_sorted,
                                   tile_start, tile_count, grid_x, fwd_out,
                                   g_out, layout=layout)
    T = tile_start.shape[0]
    R = gauss_id.shape[0]
    # every row is written by the kernel: no zero fill
    rows = torch.empty((R, grad_cols(ch)), dtype=torch.float32,
                       device=packed.device)
    order = torch.empty((T,), dtype=torch.int32, device=packed.device)
    return composite_bwd_into(rows, order, packed, ch, gauss_id, slot_sorted,
                              tile_start, tile_count, grid_x, fwd_out, g_out,
                              layout=layout)


def composite_bwd_into(rows: torch.Tensor, order: torch.Tensor,
                       packed: torch.Tensor, ch: int, gauss_id: torch.Tensor,
                       slot_sorted: torch.Tensor, tile_start: torch.Tensor,
                       tile_count: torch.Tensor, grid_x: int,
                       fwd_out: torch.Tensor, g_out: torch.Tensor,
                       layout: str = "gather") -> torch.Tensor:
    """`composite_bwd` into the caller's buffers, so that a check can see
    what the kernel writes: every row of `rows` [R, gc] (whatever it held
    before), and in `order` [T] int32 the order its blocks take the tiles
    in (by descending instance count, ties in tile order; each tile's rows
    are the same in any order). Where `_kernels.use` says twin: the plain
    twin's rows and a stable sort of the counts."""
    T = tile_start.shape[0]
    R = gauss_id.shape[0]
    gc = grad_cols(ch)
    if not _kernels.use(packed):
        rows.copy_(composite_bwd_torch(packed, ch, gauss_id, slot_sorted,
                                       tile_start, tile_count, grid_x,
                                       fwd_out, g_out, layout=layout))
        order.copy_(torch.sort(tile_count, descending=True,
                               stable=True).indices)
        return rows
    ld = _kernel_src(packed, ch, gauss_id, layout, "composite_bwd")
    _kernels.require(gauss_id, "gauss_id", torch.int32, (R,))
    _kernels.require(slot_sorted, "slot_sorted", torch.int32, (R,))
    _kernels.require(tile_start, "tile_start", torch.int32, (T,))
    _kernels.require(tile_count, "tile_count", torch.int32, (T,))
    _kernels.require(fwd_out, "fwd_out", torch.float32, (T, ch + 1, TILE_PIX))
    _kernels.require(g_out, "g_out", torch.float32, (T, ch + 1, TILE_PIX))
    _kernels.require(rows, "rows", torch.float32, (R, gc))
    _kernels.require(order, "order", torch.int32, (T,))
    fn = _kernels.entry("composite_bwd", "adgs_composite_bwd",
                        "piipppppiiippiipp")
    err = fn(packed.data_ptr(), ld, int(layout == "rows"), gauss_id.data_ptr(),
             slot_sorted.data_ptr(), tile_start.data_ptr(),
             tile_count.data_ptr(), order.data_ptr(), T, grid_x, ch,
             fwd_out.data_ptr(), g_out.data_ptr(), gc, R, rows.data_ptr(),
             _kernels.stream(packed))
    _kernels.check(err, "composite_bwd")
    _kernels.launches["composite_bwd"] += 1
    return rows


def pad_to_lanes_torch(packed_t: torch.Tensor) -> torch.Tensor:
    """Plain twin of kernel B6: [F, N] -> [N_pad, 128] with out[n, f] =
    packed_t[f, n], N_pad = N rounded up to PAD_BLK, zeros elsewhere."""
    F, n = packed_t.shape
    out = packed_t.new_zeros((-(-n // PAD_BLK) * PAD_BLK, LANES))
    out[:n, :F] = packed_t.t()
    return out


def pad_to_lanes(packed_t: torch.Tensor) -> torch.Tensor:
    """Kernel B6, or its plain twin where `_kernels.use` says so. packed_t
    [F, N] f32 (F <= 128) is read by its strides, so packed.t() needs no
    copy."""
    if not _kernels.use(packed_t):
        return pad_to_lanes_torch(packed_t)
    F, n = packed_t.shape
    if not 1 <= F <= LANES:
        raise ValueError(f"pad_to_lanes: F={F} unsupported")
    if packed_t.device.type != "cuda" or packed_t.dtype != torch.float32:
        raise ValueError("pad_to_lanes: expected a CUDA float32 tensor, got "
                         f"{packed_t.dtype} on {packed_t.device}")
    n_pad = -(-n // PAD_BLK) * PAD_BLK
    out = torch.empty((n_pad, LANES), dtype=torch.float32,
                      device=packed_t.device)
    fn = _kernels.entry("pad_lanes", "adgs_pad_lanes", "piqqqqpp")
    sf, sn = packed_t.stride()
    err = fn(packed_t.data_ptr(), F, n, sf, sn, n_pad, out.data_ptr(),
             _kernels.stream(packed_t))
    _kernels.check(err, "pad_lanes")
    _kernels.launches["pad_lanes"] += 1
    return out


def build_instances_rows(gauss_id: torch.Tensor,
                         packed: torch.Tensor) -> torch.Tensor:
    """[R, 128] tile-ordered instance rows (counterpart of
    build_instances_rm): B6 lane-pads the packed [N, F] rows, then one row
    gather by gauss_id (an XLA gather in the JAX package, outside any
    Pallas kernel). The JAX package appends 256 rows of Gaussian 0 only
    to keep the TPU's last window DMA in bounds; no kernel here reads past
    row R, so they are left out."""
    wide = pad_to_lanes(packed.t())
    return torch.index_select(wide, 0, gauss_id.long())


def segment_sum_torch(rows: torch.Tensor,
                      bounds: torch.Tensor) -> torch.Tensor:
    """Plain twin of kernel B5: out[i] = rows[bounds[i]:bounds[i+1]].sum(0),
    as differences of a float64 running sum (so not bitwise the kernel's
    f32 sums)."""
    cs = torch.cumsum(rows.to(torch.float64), dim=0)
    cs = torch.cat([cs.new_zeros((1, rows.shape[1])), cs], dim=0)
    b = bounds.long()
    return (cs[b[1:]] - cs[b[:-1]]).to(rows.dtype)


def _segment_sum_partials(R: int, n: int) -> int:
    """The partial sums B5 keeps for R rows and n segments: one a block of
    SEG_ITEMS rows and ends, then one a group of SEG_FAN of the level
    below, level by level until a level fits in one group."""
    size = max(1, -(-(n + R) // SEG_ITEMS))
    total = size
    while size > SEG_FAN:
        size = -(-size // SEG_FAN)
        total += size
    return total


def segment_sum(rows: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Kernel B5, or its plain twin where `_kernels.use` says so. rows
    [R, D] f32, bounds [n+1] int32 non-decreasing with bounds[n] <= R
    -> [n, D]. The kernel's scratch (`_segment_sum_partials` rows of D
    floats and one int each) is allocated here."""
    if not _kernels.use(rows):
        return segment_sum_torch(rows, bounds)
    R, D = rows.shape
    n = bounds.shape[0] - 1
    _kernels.require(rows, "rows", torch.float32)
    _kernels.require(bounds, "bounds", torch.int32)
    out = torch.empty((n, D), dtype=torch.float32, device=rows.device)
    if n <= 0 or D == 0:
        return out
    s = _segment_sum_partials(R, n)
    part = torch.empty(s * D, dtype=torch.float32, device=rows.device)
    meta = torch.empty(s, dtype=torch.int32, device=rows.device)
    err = _kernels.entry("segment_sum", "adgs_segment_sum", "piipiipppp")(
        rows.data_ptr(), R, D, bounds.data_ptr(), n, SEG_ITEMS,
        out.data_ptr(), part.data_ptr(), meta.data_ptr(),
        _kernels.stream(rows))
    _kernels.check(err, "segment_sum")
    _kernels.launches["segment_sum"] += 1
    return out


def contiguous_bounds(gauss_start: torch.Tensor, num_rendered: torch.Tensor,
                      capacity: int) -> torch.Tensor:
    """[N+1] segment bounds of each Gaussian's presort rows:
    [gauss_start[i], gauss_start[i] + tiles_i), clipped to
    min(num_rendered, capacity) as the JAX reduce clips them (rows past the
    capacity were never rendered). Computed on the device."""
    limit = torch.clamp(num_rendered.to(torch.int32), max=capacity)
    ext = torch.cat([gauss_start.to(torch.int32),
                     num_rendered.to(torch.int32).reshape(1)])
    return torch.minimum(ext, limit).contiguous()


class CompositePacked(torch.autograd.Function):
    """Composite packed rows [N, F] through a Binning: (blended [T, ch, P],
    final_t [T, P]), differentiable with respect to the rows: B3 forward,
    B4 + B5 backward, and B6 under layout "rows", or their twins, as
    `_kernels.use` says at the forward; the backward follows it. layout:
    "gather" or "rows" (module docstring)."""

    @staticmethod
    def forward(ctx, packed, binning: Binning, ch: int, grid_x: int,
                layout: str = "gather"):
        _check_layout(layout)
        ctx.kernel = _kernels.use(packed)
        src = packed
        if layout == "rows":
            src = build_instances_rows(binning.gauss_id, packed)
        fwd = composite_fwd if ctx.kernel else composite_fwd_torch
        blended, final_t = fwd(src, ch, binning.gauss_id, binning.tile_start,
                               binning.tile_count, grid_x, layout=layout)
        ctx.save_for_backward(src, torch.cat([blended, final_t[:, None]],
                                             dim=1))
        ctx.binning, ctx.ch, ctx.grid_x = binning, ch, grid_x
        ctx.layout, ctx.packed_shape = layout, tuple(packed.shape)
        return blended, final_t

    @staticmethod
    def backward(ctx, g_blended, g_final_t):
        src, fwd_out = ctx.saved_tensors
        b, ch = ctx.binning, ctx.ch
        g_out = torch.cat([g_blended, g_final_t[:, None]], dim=1).contiguous()
        bwd, seg = ((composite_bwd, segment_sum) if ctx.kernel
                    else (composite_bwd_torch, segment_sum_torch))
        with _kernels.following(ctx.kernel):
            rows = bwd(src, ch, b.gauss_id, b.slot_sorted, b.tile_start,
                       b.tile_count, ctx.grid_x, fwd_out, g_out,
                       layout=ctx.layout)
            per = seg(rows, contiguous_bounds(b.gauss_start, b.num_rendered,
                                              rows.shape[0]))
        n, F = ctx.packed_shape
        z = src.new_zeros
        pieces = [per[:, :N_GEOM_GRAD], z((n, F_GEOM - N_GEOM_GRAD)),
                  per[:, N_GEOM_GRAD:N_GEOM_GRAD + ch]]
        if F - F_GEOM - ch:
            pieces.append(z((n, F - F_GEOM - ch)))
        return torch.cat(pieces, dim=-1), None, None, None, None


def tiles_to_image(tile_px: torch.Tensor,
                   settings: RasterSettings) -> torch.Tensor:
    """[T, P, CH] -> [CH, H, W] (crops the tile padding)."""
    gy, gx = settings.grid_y, settings.grid_x
    ch = tile_px.shape[-1]
    img = tile_px.reshape(gy, gx, TILE_Y, TILE_X, ch)
    img = img.permute(0, 2, 1, 3, 4).reshape(gy * TILE_Y, gx * TILE_X, ch)
    img = img[: settings.image_height, : settings.image_width]
    return img.permute(2, 0, 1)


def render(prep: Preprocessed, binning: Binning, settings: RasterSettings,
           flow_points: Optional[torch.Tensor] = None,
           semantic: Optional[torch.Tensor] = None,
           layout: str = "gather") -> RasterOutput:
    """Composite a preprocessed frame through CompositePacked (counterpart
    of render_pallas) in the given instance layout; differentiable with
    respect to prep's floats, the flow points and the semantic feature."""
    feats = [prep.rgb, composite_mod.depth_feature(
        prep.depth, settings.inv_depth)[:, None]]
    if flow_points is not None:
        feats.append(flow_points)
    if semantic is not None:
        feats.append(semantic)
    features = torch.cat(feats, dim=-1)
    opac = torch.where(prep.visible, prep.opacity,
                       torch.zeros_like(prep.opacity))
    # dead slots: log(OP_FLOOR) keeps them finite, and the clamp gives them
    # an exact zero gradient
    log_op = torch.log(torch.clamp(opac, min=OP_FLOOR))
    packed, _ = pack_gaussian_rows(prep.mean2d, prep.conic, log_op, features)
    blended, t_final = CompositePacked.apply(
        packed, binning, features.shape[-1], settings.grid_x, layout)
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
                        semantic=sem_img, num_rendered=binning.num_rendered)
