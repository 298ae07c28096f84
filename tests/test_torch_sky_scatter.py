"""Kernel B8's order (the sky scatter keyed by pixel base cells) on the CPU:
`grid_sample_bwd_pixel_order`, the plain rendition of B8's steps, and the
scatter twin `grid_sample_bwd_torch` against the JAX package's backward
(jax.vjp of env_map._grid_sample_align_corners on a 40^2 grid, of
ops.grid_sample.grid_sample_image in interpret mode on a 256^2 grid; rtol
1e-5, atol 1e-6, as tests/test_torch_env.py), and the two twins against
each other (1e-6 of max|twin|, and bitwise: both sum every cell in tap
order). Coordinates on the grid's edges, off the grid and NaN; C = 1 and
C = 3; runs of several pixels on one base; a cell fed by four bases."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.models import env_map as jenv
from adgs_tpu.ops import grid_sample as jgs
from adgs_tpu_torch.ops import grid_sample as tgs

H, W = 24, 40


def _edge_coords(rng, lo, hi):
    """[24, 40, 2] uniform in [lo, hi], with the grid's edges and corners
    (x = +-1, y = +-1), runs of pixels on one base and, below -1 or above
    1, coordinates whose only taps in the grid are taps 1-3."""
    c = rng.uniform(lo, hi, size=(H, W, 2)).astype(np.float32)
    c[0, :8] = [[1, 1], [-1, -1], [1, -1], [-1, 1],
                [1, 0.3], [-1, 0.3], [0.3, 1], [0.3, -1]]
    c[1, :6] = c[1, 6]                      # six pixels on one base
    c[2, :4] = [[-1.01, 0.2], [0.2, -1.01], [-1.01, -1.01], [1.001, 1.001]]
    return c


CASES = {
    "inside": (-0.9, 0.9, False),
    "edges and off-grid": (-1.3, 1.3, False),
    "NaN": (-1.1, 1.1, True),
}


def _case(rng, name, C, r):
    lo, hi, nan = CASES[name]
    coords = _edge_coords(rng, lo, hi)
    if nan:
        coords[rng.random(coords.shape) < 0.05] = np.nan
        coords[3, 0] = [np.nan, np.nan]
    g = rng.normal(size=(C, H, W)).astype(np.float32)
    return coords, g, (C, r, r)


def _port(fn, g, coords, shape):
    return fn(torch.as_tensor(g), torch.as_tensor(coords), shape).numpy()


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_sky_scatter_matches_jax_generic(rng, name, C):
    """Both twins against jax.vjp of the generic align_corners sample (its
    backward is env_map._grid_sample_bwd) on a 40^2 grid."""
    coords, g, shape = _case(rng, name, C, 40)
    grid = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(lambda gr: jenv._grid_sample_align_corners(
        gr, jnp.asarray(coords)), jnp.asarray(grid))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    assert np.isfinite(want).all() and np.abs(want).max() > 0.1
    for fn in (tgs.grid_sample_bwd_pixel_order, tgs.grid_sample_bwd_torch):
        np.testing.assert_allclose(_port(fn, g, coords, shape), want,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("C", [1, 3])
def test_sky_scatter_matches_jax_blocked(rng, C):
    """Both twins against jax.vjp of grid_sample_image on a 256^2 grid (the
    blocked Pallas scatter in interpret mode), with coordinates across the
    right edge that send their blocks to its residual path."""
    ys, xs = np.meshgrid(np.linspace(-0.2, 0.2, H), np.linspace(-0.3, 0.3, W),
                         indexing="ij")
    coords = np.stack([xs, ys], -1).astype(np.float32)
    coords[0, :8] = [[1.0 + 0.004 * k, 0.1] for k in range(8)]
    coords[1, :4] = [[1.0, 1.0], [-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0]]
    shape = (C, 256, 256)
    grid = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=(C, H, W)).astype(np.float32)
    _, vjp = jax.vjp(lambda gr: jgs.grid_sample_image(gr, jnp.asarray(coords)),
                     jnp.asarray(grid))
    (want,) = vjp(jnp.asarray(g))
    for fn in (tgs.grid_sample_bwd_pixel_order, tgs.grid_sample_bwd_torch):
        np.testing.assert_allclose(_port(fn, g, coords, shape),
                                   np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("r", [40, 256])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_pixel_order_matches_scatter_twin(rng, name, C, r):
    """B8's order against the tap-major scatter twin: within 1e-6 of
    max|twin|, and bitwise (both add a cell's taps in tap order, each
    tap's pixels in pixel order)."""
    coords, g, shape = _case(rng, name, C, r)
    got = _port(tgs.grid_sample_bwd_pixel_order, g, coords, shape)
    want = _port(tgs.grid_sample_bwd_torch, g, coords, shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(got, want)
    # the wrapper on CPU tensors is the scatter twin
    np.testing.assert_array_equal(
        _port(tgs.grid_sample_bwd, g, coords, shape), want)


def test_pixel_keys():
    """Base keys (y0 + 1) * (Wg + 1) + x0 + 1 on the grid one larger than
    the sky's: x = -1 and y = -1 give base column / row 1 (x0 = 0), a
    coordinate just below -1 gives x0 = -1, x = +1 gives x0 = Wg - 1; all
    taps off the grid, or NaN, give the sentinel (Hg + 1) * (Wg + 1)."""
    Hg, Wg = 9, 13
    W1 = Wg + 1
    step_x, step_y = 2 / (Wg - 1), 2 / (Hg - 1)
    coords = torch.tensor([
        [-1.0, -1.0],                      # (0, 0)
        [1.0, 1.0],                        # (Wg - 1, Hg - 1)
        [-1.0 - 0.5 * step_x, 0.0],        # x0 = -1, y0 = 4
        [0.0, -1.0 - 0.5 * step_y],        # x0 = 6, y0 = -1
        [1.0 + 0.5 * step_x, 1.0],         # x0 = Wg - 1: taps 0 and 2 only
        [-1.0 - 1.5 * step_x, 0.0],        # x0 = -2: every tap off
        [1.0 + 1.5 * step_x, 0.0],         # x0 = Wg: every tap off
        [float("nan"), 0.0],
        [0.0, float("nan")],
    ])
    keys = tgs.pixel_keys_torch(coords, (3, Hg, Wg)).tolist()
    sentinel = (Hg + 1) * W1
    assert keys == [1 * W1 + 1, Hg * W1 + Wg, 5 * W1 + 0, 0 * W1 + 7,
                    Hg * W1 + Wg, sentinel, sentinel, sentinel, sentinel]


def test_cell_fed_by_four_bases(rng):
    """One cell (x, y) fed by tap 0 of base (x, y), tap 1 of (x - 1, y),
    tap 2 of (x, y - 1) and tap 3 of (x - 1, y - 1), two pixels on each
    base: its value is the sum in tap order, then pixel order, and agrees
    with JAX and bitwise with the scatter twin."""
    C, Hg, Wg = 3, 12, 10
    x, y = 5, 7
    bases = [(x, y), (x - 1, y), (x, y - 1), (x - 1, y - 1)]
    px = []
    for bx, by in bases:
        for f in (0.25, 0.625):          # fractions exact in binary
            px.append([(bx + f) / (Wg - 1) * 2 - 1,
                       (by + 1 - f) / (Hg - 1) * 2 - 1])
    coords = np.asarray(px, np.float32)[::-1].copy().reshape(1, 8, 2)
    g = rng.normal(size=(C, 1, 8)).astype(np.float32)
    got = _port(tgs.grid_sample_bwd_pixel_order, g, coords, (C, Hg, Wg))
    want = _port(tgs.grid_sample_bwd_torch, g, coords, (C, Hg, Wg))
    np.testing.assert_array_equal(got, want)
    # by hand: pixel order was reversed, so each base's pixels come in
    # the order of their flat index, tap 0's base first
    taps = tgs._taps((C, Hg, Wg), torch.as_tensor(coords.reshape(-1, 2)))
    acc = np.zeros(C, np.float32)
    for t in range(4):
        cells = (taps[t][1] * Wg + taps[t][0]).numpy()
        w = taps[t][2].numpy()
        for p in range(8):
            if cells[p] == y * Wg + x and w[p] != 0:
                acc = (acc + g[:, 0, p] * w[p]).astype(np.float32)
    np.testing.assert_array_equal(got[:, y, x], acc)
    _, vjp = jax.vjp(lambda gr: jenv._grid_sample_align_corners(
        gr, jnp.asarray(coords)), jnp.zeros((C, Hg, Wg), jnp.float32))
    (ref,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
