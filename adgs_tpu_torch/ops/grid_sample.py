"""Bilinear grid sampling for the environment map (counterpart of
adgs_tpu/ops/grid_sample.py and env_map._grid_sample_align_corners).

`grid_sample` is kernel B7 (csrc/grid_sample.cu) on CUDA tensors and its
plain twin `grid_sample_torch` on CPU tensors. The contract is torch's
F.grid_sample(align_corners=True, padding_mode='zeros') for a [C, Hg, Wg]
grid at [..., 2] (x, y) coords in [-1, 1], returning [C, ...]; the port
never calls F.grid_sample itself.
"""

from __future__ import annotations

import ctypes

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
    """Kernel B7 on CUDA tensors; its plain twin on CPU tensors."""
    if grid.device.type == "cpu":
        return grid_sample_torch(grid, coords)
    if grid.dim() != 3 or coords.shape[-1] != 2:
        raise ValueError("grid_sample: expected grid [C,Hg,Wg], coords [...,2]")
    C, Hg, Wg = grid.shape
    if C * Hg * Wg >= 2 ** 31:
        raise ValueError("grid_sample: grid too large for int32 indexing")
    _kernels.require(grid, "grid", torch.float32)
    _kernels.require(coords, "coords", torch.float32)
    out = torch.empty((C,) + tuple(coords.shape[:-1]), dtype=torch.float32,
                      device=grid.device)
    npix = coords.numel() // 2
    fn = _kernels.library("grid_sample").adgs_grid_sample
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    p = _kernels.ptr
    err = fn(p(grid), C, Hg, Wg, p(coords), npix, p(out),
             _kernels.stream(grid.device))
    _kernels.check(err, "grid_sample")
    _kernels.launches["grid_sample"] += 1
    return out
