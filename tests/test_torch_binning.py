"""adgs_tpu_torch.raster.binning against adgs_tpu.raster.binning
(expander="xla"), both fed the SAME (JAX) Preprocessed arrays: every field
bitwise, on a normal scene, a ~50% dead one and an overflowing one. The
plain twins of kernels B2 (live-first compaction) and B1 (expansion) are
held bitwise to the JAX compaction kernel's table and the JAX expansion's
key/gid."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.raster import binning as jbin
from adgs_tpu.raster.pallas import expand as jexpand
from adgs_tpu_torch.raster import binning as tbin
from adgs_tpu_torch.raster.preprocess import Preprocessed
from tests.test_torch_preprocess import make_case, port_settings, run_both

FIELDS = ("gauss_id", "tile_id", "valid", "tile_start", "tile_count",
          "slot_sorted", "gauss_start", "num_rendered", "overflow")


def _port_prep(jp) -> Preprocessed:
    return Preprocessed(*(torch.as_tensor(np.array(a)) for a in jp))


def _scene(rng, kind):
    js, g, active = make_case(rng, n=1500, w=128, h=96,
                              dead_frac=0.5 if kind == "dead" else 0.0)
    jp, _ = run_both(js, g, active, with_sh=False)
    nr = int(jnp.sum(jp.tiles_touched))
    capacity = nr // 2 if kind == "overflow" else nr + 1000
    return js, jp, capacity


def _presort_expansion(jb, dq, capacity, num_tiles, d_bits):
    """The JAX expansion's presort (key, gid), recovered from its Binning:
    sorted instance i came from presort slot slot_sorted[i]; every other
    slot is padding (key num_tiles << d_bits, gid 0)."""
    key = np.full(capacity, num_tiles << d_bits, np.int64)
    gid = np.zeros(capacity, np.int32)
    valid = np.asarray(jb.valid)
    slots = np.asarray(jb.slot_sorted)[valid]
    g = np.asarray(jb.gauss_id)[valid]
    key[slots] = ((np.asarray(jb.tile_id)[valid].astype(np.int64) << d_bits)
                  | np.asarray(dq).astype(np.int64)[g])
    gid[slots] = g
    return key, gid


@pytest.mark.parametrize("kind", ["normal", "dead", "overflow"])
def test_bin_gaussians_bitwise(rng, kind):
    js, jp, capacity = _scene(rng, kind)
    jb = jbin.bin_gaussians(jp, js, capacity=capacity, expander="xla")
    tb = tbin.bin_gaussians(_port_prep(jp), port_settings(js), capacity)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert bool(tb.overflow) == (kind == "overflow")
    if kind == "dead":
        live = np.asarray(jp.tiles_touched) > 0
        assert 0.3 < 1.0 - live.mean() < 0.8


@pytest.mark.parametrize("kind", ["normal", "dead", "overflow"])
def test_valid_instances_own_first_slots(rng, kind):
    """The rule B4 writes its gradient rows by: the valid instances are the
    first tile_start[T-1] + tile_count[T-1] sorted ones, and their presort
    slots are exactly 0 .. that total - 1; padding holds slot R."""
    js, jp, capacity = _scene(rng, kind)
    tb = tbin.bin_gaussians(_port_prep(jp), port_settings(js), capacity)
    R = tb.slot_sorted.shape[0]
    total = int(tb.tile_start[-1] + tb.tile_count[-1])
    assert total == min(int(tb.num_rendered), R)
    valid = tb.valid.numpy()
    assert valid[:total].all() and not valid[total:].any()
    slots = tb.slot_sorted.numpy()
    np.testing.assert_array_equal(np.sort(slots[:total]), np.arange(total))
    assert (slots[total:] == R).all()


def _port_table(jp, dq):
    tiles = torch.as_tensor(np.array(jp.tiles_touched))
    offsets = torch.cumsum(tiles, 0, dtype=torch.int32)
    table, n_live = tbin.compact_live(
        offsets - tiles, tiles, torch.as_tensor(np.array(jp.rect_min)),
        torch.as_tensor(np.array(jp.rect_max)),
        torch.as_tensor(np.asarray(dq).astype(np.int32)), offsets[-1])
    return table, n_live, offsets[-1]


@pytest.mark.parametrize("kind", ["normal", "dead"])
def test_compact_live_plain_matches_jax(rng, kind):
    js, jp, capacity = _scene(rng, kind)
    capacity = -(-capacity // 256) * 256
    dq = jbin.quantize_depth(jp.depth, js.num_tiles).astype(jnp.int32)
    table, n_live, total = _port_table(jp, dq)
    live = np.asarray(jp.tiles_touched) > 0
    assert int(n_live[0]) == int(live.sum())
    k = int(live.sum())

    # the JAX compaction kernel (interpret mode): rows excl, incl, rmin_x,
    # rmin_y, rect_w, dq_hi, dq_lo, gid of the live prefix
    offs = jbin.cumsum_mxu(jp.tiles_touched)
    tbl, _, ok = jexpand.compact_live_table_kernel(
        offs - jp.tiles_touched, offs, jp.rect_min, jp.rect_max, dq,
        capacity)
    assert bool(ok)
    ref = np.asarray(tbl)[:, :k].astype(np.int64)
    got = table.numpy()
    np.testing.assert_array_equal(got[:k, :5].T, ref[:5])
    np.testing.assert_array_equal(got[:k, 5], ref[5] * 16384 + ref[6])
    np.testing.assert_array_equal(got[:k, 6], ref[7])
    # dead rows are empty spans at num_rendered: incl stays non-decreasing
    np.testing.assert_array_equal(got[k:, :2], int(total))
    np.testing.assert_array_equal(got[k:, 2:], 0)
    assert np.all(np.diff(got[:, 1]) >= 0)
    if kind == "dead":
        assert 0 < k < live.size


@pytest.mark.parametrize("kind", ["normal", "overflow"])
def test_expand_plain_matches_jax(rng, kind):
    js, jp, capacity = _scene(rng, kind)
    capacity = -(-capacity // 256) * 256
    num_tiles = js.num_tiles
    d_bits = jbin.depth_bits_for(num_tiles)
    dq = jbin.quantize_depth(jp.depth, num_tiles)
    np.testing.assert_array_equal(
        tbin.quantize_depth(torch.as_tensor(np.array(jp.depth)),
                            num_tiles).numpy(),
        np.asarray(dq).astype(np.int32))
    jb = jbin.bin_gaussians(jp, js, capacity=capacity, expander="xla")
    ref_key, ref_gid = _presort_expansion(jb, dq, capacity, num_tiles, d_bits)

    table, n_live, num_rendered = _port_table(jp, dq)
    key, gid = tbin.expand(table, n_live, num_rendered, capacity, js.grid_x,
                           d_bits, num_tiles)
    np.testing.assert_array_equal(key.numpy(), ref_key)
    np.testing.assert_array_equal(gid.numpy(), ref_gid)

    # and against the Pallas expansion kernel itself (interpret mode)
    offs = jbin.cumsum_mxu(jp.tiles_touched)
    starts = offs - jp.tiles_touched
    tbl = jexpand.build_table(starts, offs, jp.rect_min, jp.rect_max,
                              dq.astype(jnp.int32))
    g_base, ok = jexpand.window_starts(offs, starts, capacity)
    assert bool(ok)
    pk, pg = jexpand.expand_pallas(tbl, g_base, capacity, js.grid_x, d_bits,
                                   num_tiles)
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(pk).reshape(-1).astype(np.int64))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(pg).reshape(-1))


def test_depth_bits_kitti():
    # KITTI 1242x375: 78 x 24 = 1872 tiles -> 11 tile bits, 21 depth bits
    assert tbin.depth_bits_for(1872) == 21 == jbin.depth_bits_for(1872)
