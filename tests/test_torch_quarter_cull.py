"""B3's quarter culling (csrc/composite.cu `quarter_mask`, rendered in
float64 by raster/render.py `quarter_masks_torch`): a warp skips an
instance whose bit for its 8x8 quarter of the tile is clear, so the
culling must never rule out an (instance, quarter) in which the gates of
the plain compositing twin (`_tile_alpha`: power > 0, alpha below 1/255)
let a pixel through; nor, what its derivation promises, one in which a
pixel passes the kernel's exp pre-test. Held exactly on the scenes of
test_torch_composite.py, on the ch=8 saturated scene of
test_bwd_matches_jax_vjp_long_tiles, and on seeded random splats with
near-degenerate conics, opacities near 0.99 and near 1/255, centres
just outside a quarter, and pixels on the pre-test's level set.

The card holds the culling through B3's final T, bitwise its serial
replay (`composite_final_t_serial`); held here to the twin's final T,
and shown to see one skipped pair of alpha 1/255 at a T near the stop.
The composite scenes are `_case`'s splats (make_case, seed 0), binned by
the port's own preprocess and binning: the JAX build of the same scene
costs seconds of compiling."""

import functools
import math

import numpy as np
import pytest
import torch

from adgs_tpu_torch.raster import binning as tbin
from adgs_tpu_torch.raster import preprocess as tprep
from adgs_tpu_torch.raster import render as trender
from adgs_tpu_torch.raster.types import TILE_PIX, TILE_X
from tests.test_torch_composite import _packed
from tests.test_torch_composite_bwd import _features
from tests.test_torch_composite_bwd import _packed as _packed_ch
from tests.test_torch_preprocess import make_case, port_settings


@functools.lru_cache(maxsize=None)
def _binned(saturated):
    """test_torch_composite.py `_case(default_rng(0), saturated)`'s scene,
    through the port: (Preprocessed, Binning, grid_x)."""
    rng = np.random.default_rng(0)
    js, g, active = make_case(rng, n=512, w=64, h=48, op_low=0.05)
    if saturated:
        g["opacities"][:] = 0.99
        g["scales"] *= 4.0
    ps = port_settings(js)
    tp = tprep.preprocess(*(torch.as_tensor(g[k]) for k in
                            ("means3d", "scales", "rotations", "opacities")),
                          torch.as_tensor(g["shs"]), ps,
                          active_mask=torch.as_tensor(active))
    tb = tbin.bin_gaussians(tp, ps, int(tp.tiles_touched.sum()) + 512)
    return tp, tb, ps.grid_x


def _scene(rng, kind):
    """(packed rows, F, gauss_id, tile_start, tile_count, grid_x)."""
    if kind == "random_splats":
        return _random_splats(rng)
    tp, tb, grid_x = _binned(kind != "ch4")
    if kind == "saturated_ch8":
        packed = _packed_ch(tp, _features(rng, tp, 8))
    else:
        packed = _packed(tp)
    return (packed, packed.shape[1], tb.gauss_id, tb.tile_start,
            tb.tile_count, grid_x)


def _random_splats(rng, n=3000, grid_x=2, grid_y=2):
    """n splats, each an instance of every tile of a grid_x x grid_y grid:
    centres near the tiles' quarter edges (within half a pixel to a few
    pixels either side), conics from well-conditioned to near-degenerate
    (a c - b^2 down to ~1e-7 a c, a few indefinite or singular ones),
    log-opacities near log(0.99), near log(1/255) and near the pre-test's
    -5.6 itself."""
    edges = np.array([-1.0, 7.0, 8.0, 15.0, 16.0, 23.0, 24.0, 31.0, 32.0])
    mx = rng.choice(edges, n) + rng.uniform(-3.0, 3.0, n)
    my = rng.choice(edges, n) + rng.uniform(-3.0, 3.0, n)
    theta = rng.uniform(0.0, math.pi, n)
    big = np.exp(rng.uniform(math.log(0.3), math.log(2e3), n))
    ratio = np.exp(rng.uniform(0.0, math.log(1e7), n))
    l1, l2 = 1.0 / big, ratio / big            # conic eigenvalues
    cs, sn = np.cos(theta), np.sin(theta)
    a = l1 * cs * cs + l2 * sn * sn
    c = l1 * sn * sn + l2 * cs * cs
    b = (l2 - l1) * cs * sn
    odd = rng.random(n) < 0.03                 # singular or indefinite
    b[odd] = np.sqrt(a[odd] * c[odd]) * rng.choice([1.0, 1.01], odd.sum())
    lo = rng.choice([math.log(0.99), math.log(1 / 255), -5.6, -2.0], n)
    lo = lo + rng.normal(0.0, 0.02, n)
    # a tenth on the box's edge: axis-aligned dyadic conics at integer
    # centres, log-opacity -5.6 + a k^2 / 2, so the pixels k off the
    # centre along an axis sit on the level set of the pre-test
    edge = rng.random(n) < 0.1
    k = rng.integers(1, 12, n)
    a[edge] = rng.choice([0.25, 0.5, 1.0, 2.0], edge.sum())
    c[edge] = a[edge]
    b[edge] = 0.0
    mx[edge] = np.round(mx[edge])
    my[edge] = np.round(my[edge])
    lo[edge] = -5.6 + a[edge] * k[edge] ** 2 / 2.0
    g = np.stack([mx, my, a, b, c, lo], -1).astype(np.float32)
    packed = torch.zeros((n, 16), dtype=torch.float32)
    packed[:, :6] = torch.as_tensor(g)
    packed[:, 8:12] = torch.as_tensor(rng.uniform(size=(n, 4))
                                      .astype(np.float32))
    T = grid_x * grid_y
    gauss_id = torch.arange(n, dtype=torch.int32).repeat(T)
    tile_count = torch.full((T,), n, dtype=torch.int32)
    tile_start = torch.arange(T, dtype=torch.int32) * n
    return packed, 16, gauss_id, tile_start, tile_count, grid_x


@pytest.mark.parametrize("kind", ["ch4", "saturated", "saturated_ch8",
                                  "random_splats"])
def test_culling_keeps_every_gated_in_pair(rng, kind):
    packed, F, gauss_id, tile_start, tile_count, grid_x = _scene(rng, kind)
    masks = trender.quarter_masks_torch(packed, gauss_id, tile_start,
                                        tile_count, grid_x)
    pix = torch.arange(TILE_PIX)
    quarter = (pix % TILE_X >= 8).long() + 2 * (pix // TILE_X >= 8).long()
    culled = evaluated = 0
    for lo, hi in trender._tile_batches(tile_count, 1 << 22):
        m = int(tile_count[lo:hi].max())
        if m == 0:
            continue
        tb = trender._tile_alpha(packed, F, gauss_id, tile_start, tile_count,
                                 lo, hi, m, grid_x, "gather")
        bits = masks[tb.idx].long()                      # [G, M]
        reach = (bits[:, None, :] >> quarter[None, :, None]) & 1
        passes = tb.alpha > 0.0                          # [G, P, M]
        bad = passes & (reach == 0)
        assert not bool(bad.any()), (
            f"{int(bad.sum())} pairs that pass the gates were culled")
        # what the culling promises, stronger: no culled pair passes even
        # the kernel's pre-test (lo + power >= kLogAlphaMinSafe)
        r = tb.rows[:, None, :, :]
        dx, dy = tb.dx, tb.dy
        power = (-0.5 * (r[..., 2] * dx * dx + r[..., 4] * dy * dy)
                 - r[..., 3] * dx * dy)
        pre = ((power <= 0.0)
               & (r[..., 5] + power >= trender.LOG_ALPHA_MIN_SAFE)
               & tb.in_range[:, None, :])
        bad = pre & (reach == 0)
        assert not bool(bad.any()), (
            f"{int(bad.sum())} pairs that pass the pre-test were culled")
        in_q = tb.in_range[:, None, :].expand(-1, 4, -1)
        qbits = (bits[:, None, :] >> torch.arange(4)[None, :, None]) & 1
        culled += int((in_q & (qbits == 0)).sum())
        evaluated += int(in_q.sum())
    # the test has teeth: the culling does rule out (instance, quarter)s
    assert 0 < culled < evaluated
    # the twin counts the gated pairs in them, which B3's bound leaves out
    _, _, pairs = trender.composite_fwd_torch(
        packed, F - 8, gauss_id, tile_start, tile_count, grid_x,
        count_pairs=True, masks=masks)
    assert 0 < int(pairs.culled) <= int(pairs.gated)
    _, _, plain = trender.composite_fwd_torch(
        packed, F - 8, gauss_id, tile_start, tile_count, grid_x,
        count_pairs=True)
    assert int(plain.culled) == 0 and int(plain.gated) == int(pairs.gated)


@pytest.mark.parametrize("kind", ["ch4", "saturated", "random_splats"])
def test_serial_final_t_matches_twin(rng, kind):
    """The serial replay that the card holds B3's final T to bitwise
    agrees with the twin's log-space final T (test_torch_composite.py's
    tolerance)."""
    packed, F, gauss_id, tile_start, tile_count, grid_x = _scene(rng, kind)
    args = (packed, F - 8, gauss_id, tile_start, tile_count, grid_x)
    serial = trender.composite_final_t_serial(*args)
    _, final_t = trender.composite_fwd_torch(*args)
    np.testing.assert_allclose(serial.numpy(), final_t.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert float(serial.min()) >= 1e-4 and float(serial.max()) <= 1.0
    assert float(serial.min()) < 0.5


def test_serial_final_t_sees_a_pair_at_small_t():
    """One pair of alpha just over 1/255 where T is 2e-4 to 4e-4, near the
    stop: dropping it (as a wrong culling would) moves final T by under
    2e-6, within a 1e-4 tolerance, but never leaves it bitwise equal."""
    rows = torch.zeros((4, 16), dtype=torch.float32)
    # wide splats centred on the tile: power within 1e-2 of 0 everywhere
    rows[:, 0:2] = 7.5
    rows[:, 2] = rows[:, 4] = 1e-4
    rows[:, 5] = torch.log(torch.tensor([0.98, 0.98, 0.5, 1.3 / 255.0]))
    one = torch.zeros(1, dtype=torch.int32)
    count = torch.full((1,), 4, dtype=torch.int32)
    gid = torch.arange(4, dtype=torch.int32)
    full = trender.composite_final_t_serial(rows, 8, gid, one, count, 1)
    dropped = rows.clone()
    dropped[3, 5] = -30.0
    less = trender.composite_final_t_serial(dropped, 8, gid, one, count, 1)
    assert float(full.max()) < 5e-4 and float(full.min()) >= 1e-4
    assert torch.allclose(full, less, rtol=1e-4, atol=1e-4)
    assert bool((full != less).all())


def test_culling_keeps_non_finite_and_huge_splats():
    """Non-finite values, a conic that is not positive definite, or
    values large enough for the float power to overflow (NaN, which the
    gates let through) are never culled; t < 0 culls the instance."""
    rows = torch.zeros((6, 16), dtype=torch.float32)
    rows[:, :6] = torch.tensor([
        [8.0, 8.0, 1.0, 0.0, 1.0, float("nan")],
        [float("inf"), 8.0, 1.0, 0.0, 1.0, 0.0],
        [100.0, 100.0, -1.0, 0.0, 1.0, 0.0],      # indefinite
        [100.0, 100.0, 1.0, 1.0, 1.0, 0.0],       # singular
        [1e19, 8.0, 1.0, 0.0, 1.0, 0.0],          # a dx^2 overflows
        [8.0, 8.0, 1.0, 0.0, 1.0, -6.0],          # t < 0: culled whole
    ])
    one = torch.zeros(1, dtype=torch.int32)
    masks = trender.quarter_masks_torch(
        rows, torch.arange(6, dtype=torch.int32), one,
        torch.full((1,), 6, dtype=torch.int32), 1)
    assert masks.tolist() == [0xF] * 5 + [0]
