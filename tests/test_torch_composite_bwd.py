"""The compositing backward of the port (CompositePacked: the plain twins of
kernels B4 and B5 on CPU tensors) against the JAX package's
composite_packed VJP (Pallas, interpret mode) and against torch.autograd
through the plain forward twin, on the scenes of test_torch_composite.py:
ch=4, ch=8, a saturated scene and one whose capacity is below
num_rendered. Tolerance rtol 5e-3, atol 2e-5, tests/test_pallas.py's bars
for the JAX backward (the sum orders differ), with the cotangents of a
mean loss over the frame as there: N(0,1) / (pixels of the frame). The
conic gradients are sums of d_power * dx^2 over 256 pixels with dx up to
~60 px, so their float32 error scales with the cotangents. Rows of
instances that no pixel reached, and Gaussians past the capacity, get
exact zeros."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.raster.pallas import render as jpal
from adgs_tpu_torch.raster import binning as tbin
from adgs_tpu_torch.raster import render as trender
from tests.test_torch_composite import _case
from tests.test_torch_preprocess import port_settings

BARS = dict(rtol=5e-3, atol=2e-5)


def _features(rng, tprep, ch):
    feats = [tprep.rgb, tprep.depth[:, None]]
    n = tprep.depth.shape[0]
    if ch == 8:
        feats += [torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32)),
                  torch.as_tensor(rng.uniform(size=(n, 1)).astype(np.float32))]
    return torch.cat(feats, -1)


def _packed(tprep, feats):
    op = torch.where(tprep.visible, tprep.opacity,
                     torch.zeros_like(tprep.opacity))
    rows, _ = trender.pack_gaussian_rows(
        tprep.mean2d, tprep.conic,
        torch.log(torch.clamp(op, min=trender.OP_FLOOR)), feats)
    return rows.detach()


def _scene(rng, kind):
    js, jp, jb, tprep, tb = _case(rng, saturated=kind == "saturated")
    ch = 8 if kind in ("ch8", "overflow") else 4
    feats = _features(rng, tprep, ch)
    if kind == "overflow":
        nr = int(tb.num_rendered)
        tb = tbin.bin_gaussians(tprep, port_settings(js), nr // 2)
        assert bool(tb.overflow) and tb.gauss_id.shape[0] < nr
    return js, jb, tprep, tb, _packed(tprep, feats), ch


def _cotangents(rng, T, ch):
    """The cotangents of a mean loss over the frame's tile pixels."""
    scale = 1.0 / (T * 256)
    gb = (rng.normal(size=(T, ch, 256)) * scale).astype(np.float32)
    gt = (rng.normal(size=(T, 256)) * scale).astype(np.float32)
    return gb, gt


def _port_grad(packed, tb, ch, grid_x, gb, gt):
    p = packed.clone().requires_grad_(True)
    blended, final_t = trender.CompositePacked.apply(p, tb, ch, grid_x)
    (d,) = torch.autograd.grad(
        (blended * torch.as_tensor(gb)).sum()
        + (final_t * torch.as_tensor(gt)).sum(), p)
    return d


@pytest.mark.parametrize("kind", ["ch4", "ch8", "saturated", "overflow"])
def test_bwd_matches_autograd_of_plain_forward(rng, kind):
    js, _, _, tb, packed, ch = _scene(rng, kind)
    gb, gt = _cotangents(rng, js.num_tiles, ch)
    got = _port_grad(packed, tb, ch, js.grid_x, gb, gt)

    p = packed.clone().requires_grad_(True)
    blended, final_t = trender.composite_fwd_torch(
        p, ch, tb.gauss_id, tb.tile_start, tb.tile_count, js.grid_x)
    (want,) = torch.autograd.grad(
        (blended * torch.as_tensor(gb)).sum()
        + (final_t * torch.as_tensor(gt)).sum(), p)
    assert float(want.abs().max()) > 1e-3      # the gradient is not trivial
    np.testing.assert_allclose(got.numpy(), want.numpy(), **BARS)
    # the geometry pad columns and the feature padding get no gradient
    assert torch.all(got[:, 6:8] == 0)
    assert torch.all(got[:, 8 + ch:] == 0)


def test_bwd_matches_jax_vjp(rng):
    js, jb, _, tb, packed, ch = _scene(rng, "ch8")
    gb, gt = _cotangents(rng, js.num_tiles, ch)
    got = _port_grad(packed, tb, ch, js.grid_x, gb, gt)

    bin_info = (jb.gauss_id, jb.slot_sorted, jb.tile_start, jb.tile_count,
                jb.gauss_start, jb.num_rendered)
    _, vjp = jax.vjp(lambda p: jpal.composite_packed(
        p, bin_info, ch, js.num_tiles, js.grid_x), jnp.asarray(packed.numpy()))
    (want,) = vjp(jpal._CompositeOut(blended=jnp.asarray(gb),
                                     final_t=jnp.asarray(gt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BARS)


def _reached(tb, packed, ch, grid_x):
    """[R] bool: sorted instances that some pixel of their tile evaluated
    before its stop (the sequential loop, walked in lockstep with numpy)."""
    rows = packed.numpy().astype(np.float64)
    gid = tb.gauss_id.numpy()
    out = np.zeros(gid.shape[0], bool)
    p = np.arange(256)
    for tile in range(tb.tile_start.shape[0]):
        s, c = int(tb.tile_start[tile]), int(tb.tile_count[tile])
        px = (tile % grid_x) * 16 + p % 16
        py = (tile // grid_x) * 16 + p // 16
        T = np.ones(256)
        live = np.ones(256, bool)
        for k in range(c):
            if not live.any():
                break
            out[s + k] = True
            r = rows[gid[s + k]]
            dx, dy = r[0] - px, r[1] - py
            power = -0.5 * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
            a = np.minimum(0.99, np.exp(np.minimum(r[5] + power, 0.0)))
            hit = live & (power <= 0) & (a >= 1 / 255)
            stop = hit & (T * (1 - a) < 1e-4)
            live &= ~stop
            T = np.where(hit & ~stop, T * (1 - a), T)
    return out


@pytest.mark.parametrize("kind", ["saturated", "overflow"])
def test_unreached_rows_are_exact_zeros(rng, kind):
    js, _, _, tb, packed, ch = _scene(rng, kind)
    gb, gt = _cotangents(rng, js.num_tiles, ch)
    fwd = trender.composite_fwd_torch(packed, ch, tb.gauss_id, tb.tile_start,
                                      tb.tile_count, js.grid_x)
    fwd_out = torch.cat([fwd[0], fwd[1][:, None]], 1)
    g_out = torch.cat([torch.as_tensor(gb), torch.as_tensor(gt)[:, None]], 1)
    rows = trender.composite_bwd_torch(
        packed, ch, tb.gauss_id, tb.slot_sorted, tb.tile_start, tb.tile_count,
        js.grid_x, fwd_out, g_out)
    R = tb.gauss_id.shape[0]
    reached = _reached(tb, packed, ch, js.grid_x)
    valid = tb.valid.numpy()
    unreached_slots = tb.slot_sorted.numpy()[valid & ~reached]
    rows_np = rows.numpy()
    if kind == "saturated":
        assert unreached_slots.size > 0            # the stop really fired
    assert np.all(rows_np[unreached_slots] == 0)
    assert np.abs(rows_np).sum() > 0
    # Gaussians whose every instance lies past the capacity: zero gradient
    d = _port_grad(packed, tb, ch, js.grid_x, gb, gt).numpy()
    start = tb.gauss_start.numpy()
    past = start >= R
    if kind == "overflow":
        assert past.any()
    assert np.all(d[past] == 0)


def test_segment_reduce_contiguous_clips_at_capacity(rng):
    R, n = 20, 12
    tiles = rng.integers(0, 6, size=n).astype(np.int32)
    start = (np.cumsum(tiles) - tiles).astype(np.int32)
    nr = int(tiles.sum())
    assert nr > R
    rows = rng.normal(size=(R, 16)).astype(np.float32)
    got = trender.segment_sum(torch.as_tensor(rows), trender.contiguous_bounds(
        torch.as_tensor(start), torch.tensor(nr, dtype=torch.int32),
        R)).numpy()
    want = np.zeros((n, 16), np.float64)
    for i in range(n):
        lo, hi = min(start[i], R), min(start[i] + tiles[i], R)
        want[i] = rows[lo:hi].astype(np.float64).sum(0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bwd_matches_jax_vjp_long_tiles(rng):
    """ch=8 on the saturated scene: tiles of more than 256 instances (B4
    stages several batches of instances, and exits a whole tile at a batch
    boundary once every pixel has stopped), against the JAX VJP."""
    js, jp, jb, tprep, tb = _case(rng, saturated=True)
    ch = 8
    packed = _packed(tprep, _features(rng, tprep, ch))
    counts = tb.tile_count.numpy()
    assert counts.max() > 256
    # the stop fires inside the long tiles: some of their instances are
    # never reached, so their rows are exact zeros
    reached = _reached(tb, packed, ch, js.grid_x)
    start = tb.tile_start.numpy()
    long_tiles = np.flatnonzero(counts > 256)
    assert any(not reached[start[t]:start[t] + counts[t]].all()
               for t in long_tiles)
    gb, gt = _cotangents(rng, js.num_tiles, ch)
    got = _port_grad(packed, tb, ch, js.grid_x, gb, gt)

    bin_info = (jb.gauss_id, jb.slot_sorted, jb.tile_start, jb.tile_count,
                jb.gauss_start, jb.num_rendered)
    _, vjp = jax.vjp(lambda p: jpal.composite_packed(
        p, bin_info, ch, js.num_tiles, js.grid_x), jnp.asarray(packed.numpy()))
    (want,) = vjp(jpal._CompositeOut(blended=jnp.asarray(gb),
                                     final_t=jnp.asarray(gt)))
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BARS)
