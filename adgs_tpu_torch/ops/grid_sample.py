"""Bilinear grid sampling for the environment map and its adjoint
(counterpart of adgs_tpu/ops/grid_sample.py and
env_map._grid_sample_align_corners with its custom VJP).

  - `grid_sample` is kernel B7 (csrc/grid_sample.cu) or its plain twin
    `grid_sample_torch`, as `_kernels.use` says. The contract is torch's
    F.grid_sample(align_corners=True, padding_mode='zeros') for a [C, Hg, Wg]
    grid at [..., 2] (x, y) coords in [-1, 1], returning [C, ...];
  - `grid_sample_bwd` is kernel B8 (csrc/grid_sample_bwd.cu), the gradient
    with respect to the grid, and `grid_sample_bwd_torch` its twin, the
    per-channel flat scatter of env_map._grid_sample_bwd;
    `grid_sample_bwd_pixel_order` renders B8's own steps (pixel base keys,
    a stable order, per-cell sums in tap order) for tests and
    chip_smoke.py, bitwise equal to the kernel on any device;
  - `GridSample` is the autograd Function over them (coordinates get no
    gradient, as in the JAX package).
The port never calls F.grid_sample itself.
"""

from __future__ import annotations

import torch

from .. import _kernels


def _taps(grid_shape, coords: torch.Tensor):
    """((xi, yi, w) x 4): tap indices (clipped) and bilinear weights, with
    w = 0 for out-of-bounds taps."""
    _, Hg, Wg = grid_shape
    x = (coords[..., 0] + 1.0) * 0.5 * (Wg - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (Hg - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    out = []
    for xi, yi, w in ((x0, y0, (1 - wx) * (1 - wy)),
                      (x0 + 1, y0, wx * (1 - wy)),
                      (x0, y0 + 1, (1 - wx) * wy),
                      (x0 + 1, y0 + 1, wx * wy)):
        inb = (xi >= 0) & (xi <= Wg - 1) & (yi >= 0) & (yi <= Hg - 1)
        # NaN -> index 0, as XLA's saturating float->int conversion does
        xc = torch.nan_to_num(torch.clamp(xi, 0, Wg - 1), nan=0.0)
        yc = torch.nan_to_num(torch.clamp(yi, 0, Hg - 1), nan=0.0)
        out.append((xc.to(torch.int64), yc.to(torch.int64),
                    torch.where(inb, w, torch.zeros_like(w))))
    return out


def grid_sample_torch(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain twin of kernel B7: [C, Hg, Wg] at [..., 2] -> [C, ...]."""
    C, Hg, Wg = grid.shape
    flat = grid.reshape(C, Hg * Wg)
    v = None
    for xi, yi, w in _taps(grid.shape, coords):
        tap = flat[:, (yi * Wg + xi).reshape(-1)].reshape((C,) + w.shape) * w
        v = tap if v is None else v + tap
    return v


def grid_sample(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Kernel B7, or its plain twin where `_kernels.use` says so. The
    kernel's path does its checks, one allocation and one ctypes call, so
    that a call costs the host about what one PyTorch operator does."""
    if not _kernels.use(grid):
        return grid_sample_torch(grid, coords)
    if grid.dim() != 3 or coords.shape[-1] != 2:
        raise ValueError("grid_sample: expected grid [C,Hg,Wg], coords [...,2]")
    C, Hg, Wg = grid.shape
    npix = coords.numel() // 2
    if C * Hg * Wg >= 2 ** 31 or C * npix >= 2 ** 31:
        raise ValueError("grid_sample: too large for int32 indexing")
    _kernels.require(grid, "grid", torch.float32)
    _kernels.require(coords, "coords", torch.float32)
    out = grid.new_empty((C,) + coords.shape[:-1])
    err = _kernels.entry("grid_sample", "adgs_grid_sample", "piiipipp")(
        grid.data_ptr(), C, Hg, Wg, coords.data_ptr(), npix, out.data_ptr(),
        _kernels.stream(grid))
    _kernels.check(err, "grid_sample")
    _kernels.launches["grid_sample"] += 1
    return out


def grid_sample_bwd_torch(g: torch.Tensor, coords: torch.Tensor,
                          grid_shape) -> torch.Tensor:
    """Plain twin of kernel B8: d_grid [C, Hg, Wg] = the adjoint of the
    sample at coords [..., 2] applied to g [C, ...], one flat index_add_
    per channel in tap order (tap-major, as env_map._grid_sample_bwd)."""
    C, Hg, Wg = grid_shape
    taps = _taps(grid_shape, coords.reshape(-1, 2))
    ids4 = torch.cat([yi * Wg + xi for xi, yi, _ in taps])
    gf = g.reshape(C, -1)
    d_grid = g.new_zeros((C, Hg * Wg))
    for c in range(C):
        vals4 = torch.cat([gf[c] * w for _, _, w in taps])
        d_grid[c].index_add_(0, ids4, vals4)
    return d_grid.reshape(C, Hg, Wg)


def pixel_keys_torch(coords: torch.Tensor, grid_shape) -> torch.Tensor:
    """[npix] int32 base keys of B8's order: (y0 + 1) * (Wg + 1) + x0 + 1
    for a pixel's base tap (x0, y0) (the grid one larger than the sky's,
    shifted by one), or the sentinel (Hg + 1) * (Wg + 1) when all four of
    its taps are off the grid (NaN coordinates included)."""
    _, Hg, Wg = grid_shape
    c = coords.reshape(-1, 2)
    fx = torch.floor((c[:, 0] + 1.0) * 0.5 * (Wg - 1))
    fy = torch.floor((c[:, 1] + 1.0) * 0.5 * (Hg - 1))
    live = (fx >= -1) & (fx <= Wg - 1) & (fy >= -1) & (fy <= Hg - 1)
    key = ((torch.where(live, fy, 0.0).to(torch.int64) + 1) * (Wg + 1)
           + torch.where(live, fx, 0.0).to(torch.int64) + 1)
    return torch.where(live, key, (Hg + 1) * (Wg + 1)).to(torch.int32)


def grid_sample_bwd_pixel_order(g: torch.Tensor, coords: torch.Tensor,
                                grid_shape) -> torch.Tensor:
    """Plain rendition of kernel B8's steps, deterministic on any device:
    the pixels' base keys (pixel_keys_torch), their stable order, each
    pixel's four products w_t * g, then every cell's sum over tap 0's run,
    tap 1's, 2's and 3's, each run in pixel order, one element of every
    run per addition. For tests and chip_smoke.py only."""
    C, Hg, Wg = grid_shape
    W1 = Wg + 1
    keys = pixel_keys_torch(coords, grid_shape).long()
    skeys, order = torch.sort(keys, stable=True)
    live = skeys < (Hg + 1) * W1
    skeys, order = skeys[live], order[live]
    gf = g.reshape(C, -1)[:, order]
    # run heads and lengths of equal keys
    head = torch.ones_like(skeys, dtype=torch.bool)
    head[1:] = skeys[1:] != skeys[:-1]
    starts = torch.nonzero(head).flatten()
    lens = torch.diff(torch.cat([starts, starts.new_tensor([skeys.numel()])]))
    bx = skeys[starts] % W1 - 1           # base (x0, y0) of each run
    by = skeys[starts] // W1 - 1
    taps = _taps(grid_shape, coords.reshape(-1, 2)[order])
    d_grid = g.new_zeros((C, Hg * Wg))
    for t, (dx, dy) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        x, y = bx + dx, by + dy
        on = (x >= 0) & (x < Wg) & (y >= 0) & (y < Hg)
        cell, st, ln = (y * Wg + x)[on], starts[on], lens[on]
        vals = gf * taps[t][2]
        for j in range(int(ln.max()) if ln.numel() else 0):
            more = ln > j
            d_grid[:, cell[more]] += vals[:, st[more] + j]
    return d_grid.reshape(C, Hg, Wg)


def grid_sample_bwd(g: torch.Tensor, coords: torch.Tensor,
                    grid_shape) -> torch.Tensor:
    """Kernel B8, or its plain twin where `_kernels.use` says so. B8 keys
    the pixels by base cell, a stable torch.sort orders them between its
    launches, and B8 takes each tap's product once, writes the zeros of
    the gradient in one pass and then each cell that taps reach with its
    sum, taken in tap order."""
    if not _kernels.use(g):
        return grid_sample_bwd_torch(g, coords, grid_shape)
    C, Hg, Wg = grid_shape
    npix = coords.numel() // 2
    if (C * Hg * Wg >= 2 ** 31 or 4 * C * npix >= 2 ** 31
            or (Hg + 2) * (Wg + 1) >= 2 ** 31 or Hg > 65535):
        raise ValueError("grid_sample_bwd: too large for int32 indexing")
    if not 1 <= C <= 8:
        raise ValueError(f"grid_sample_bwd: {C} channels unsupported")
    _kernels.require(coords, "coords", torch.float32)
    _kernels.require(g, "g", torch.float32, (C,) + tuple(coords.shape[:-1]))
    dev = g.device
    if npix == 0:
        return torch.zeros((C, Hg, Wg), dtype=torch.float32, device=dev)
    st = _kernels.stream(g)
    keys = torch.empty(npix, dtype=torch.int32, device=dev)
    fn = _kernels.entry("grid_sample_bwd", "adgs_sky_pixel_keys", "piiipp")
    _kernels.check(fn(coords.data_ptr(), npix, Hg, Wg, keys.data_ptr(), st),
                   "grid_sample_bwd (pixel keys)")
    sorted_keys, order = torch.sort(keys, stable=True)
    vals = torch.empty(4 * C * npix, dtype=torch.float32, device=dev)
    # the first sorted position of each base row's segments; the table's
    # length is the kernel's to say
    n_table = _kernels.entry("grid_sample_bwd", "adgs_sky_table_len",
                             "ii")(Hg, Wg)
    seg_start = torch.empty(n_table, dtype=torch.int32, device=dev)
    fn = _kernels.entry("grid_sample_bwd", "adgs_sky_tap_values",
                        "ppippiiippp")
    _kernels.check(fn(sorted_keys.data_ptr(), order.data_ptr(), npix,
                      coords.data_ptr(), g.data_ptr(), C, Hg, Wg,
                      vals.data_ptr(), seg_start.data_ptr(), st),
                   "grid_sample_bwd (tap values)")
    d_grid = torch.empty((C, Hg, Wg), dtype=torch.float32, device=dev)
    fn = _kernels.entry("grid_sample_bwd", "adgs_sky_sum_fill", "pppiiiipp")
    _kernels.check(fn(sorted_keys.data_ptr(), seg_start.data_ptr(),
                      vals.data_ptr(), npix, C, Hg, Wg, d_grid.data_ptr(),
                      st),
                   "grid_sample_bwd (sum and fill)")
    _kernels.launches["grid_sample_bwd"] += 1
    return d_grid


class GridSample(torch.autograd.Function):
    """Sample grid [C, Hg, Wg] at coords [..., 2] -> [C, ...],
    differentiable with respect to the grid only: B7 forward, B8 backward,
    or their twins, as `_kernels.use` says at the forward; the backward
    follows it."""

    @staticmethod
    def forward(ctx, grid, coords):
        ctx.save_for_backward(coords)
        ctx.grid_shape, ctx.kernel = tuple(grid.shape), _kernels.use(grid)
        fwd = grid_sample if ctx.kernel else grid_sample_torch
        return fwd(grid, coords)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        bwd = grid_sample_bwd if ctx.kernel else grid_sample_bwd_torch
        with _kernels.following(ctx.kernel):
            return bwd(g.contiguous(), coords, ctx.grid_shape), None
