"""The plain compositing twin of kernel B3 against the JAX Pallas
compositor (interpret mode) and the naive reference oracle, on the same
Preprocessed and Binning: ch=4 (rgb+depth), ch=8 (+flow+semantic) and a
saturated scene that exercises early termination. Tolerance 1e-4 (as
tests/test_pallas.py: the exp/log order differs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.raster import binning as jbin
from adgs_tpu.raster import reference as jref
from adgs_tpu.raster.pallas import render as jpal
from adgs_tpu_torch.raster import render as trender
from adgs_tpu_torch.raster.binning import Binning
from adgs_tpu_torch.raster.preprocess import Preprocessed
from tests.test_torch_preprocess import make_case, port_settings, run_both

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.as_tensor(np.array(a))


def _case(rng, saturated=False, n=512, w=64, h=48):
    js, g, active = make_case(rng, n=n, w=w, h=h, op_low=0.05)
    if saturated:
        g["opacities"][:] = 0.99
        g["scales"] *= 4.0        # overlapping splats: most pixels saturate
    jp, _ = run_both(js, g, active)
    jb = jbin.bin_gaussians(jp, js, capacity=int(jnp.sum(jp.tiles_touched))
                            + 512, expander="xla")
    tprep = Preprocessed(*(_t(a) for a in jp))
    tb = Binning(*(_t(getattr(jb, f)) for f in Binning._fields))
    return js, jp, jb, tprep, tb


def _packed(tprep):
    """Packed rows of rgb + depth, as raster/render.py builds them."""
    op = torch.where(tprep.visible, tprep.opacity,
                     torch.zeros_like(tprep.opacity))
    rows, _ = trender.pack_gaussian_rows(
        tprep.mean2d, tprep.conic,
        torch.log(torch.clamp(op, min=trender.OP_FLOOR)),
        torch.cat([tprep.rgb, tprep.depth[:, None]], -1))
    return rows


def _compare(port, ref, names):
    for name in names:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("extra", ["none", "flow_semantic"])
def test_plain_matches_pallas_and_reference(rng, extra):
    js, jp, jb, tprep, tb = _case(rng)
    n = jp.depth.shape[0]
    flow = sem = None
    names = ["color", "depth", "opacity"]
    if extra == "flow_semantic":
        flow = rng.normal(size=(n, 3)).astype(np.float32)
        sem = rng.uniform(size=(n, 1)).astype(np.float32)
        names += ["flow", "semantic"]
    jflow = None if flow is None else jnp.asarray(flow)
    jsem = None if sem is None else jnp.asarray(sem)
    pal = jpal.render_pallas(jp, jb, js, flow_points=jflow, semantic=jsem)
    ref = jref.composite_reference(jp, js, flow_points=jflow, semantic=jsem)
    ps = port_settings(js)
    tflow = None if flow is None else _t(flow)
    tsem = None if sem is None else _t(sem)
    out = trender.render(tprep, tb, ps, flow_points=tflow, semantic=tsem)
    _compare(out, pal, names)
    _compare(out, ref, names)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(pal.radii))


def test_saturated_early_exit(rng):
    js, jp, jb, tprep, tb = _case(rng, saturated=True)
    pal = jpal.render_pallas(jp, jb, js)
    out = trender.render(tprep, tb, port_settings(js))
    _compare(out, pal, ["color", "opacity", "depth"])
    # the termination gate really fired: the loop skipped instances
    _, _, pairs = trender.composite_fwd_torch(
        _packed(tprep), 4, tb.gauss_id, tb.tile_start, tb.tile_count,
        js.grid_x, count_pairs=True)
    assert int(pairs.hit + pairs.gated) < 0.9 * 256 * int(tb.tile_count.sum())
    # and some tile's pixels all stopped before its last instance
    assert bool((pairs.reach < tb.tile_count).any())


def test_pair_count_and_batching(rng, monkeypatch):
    """Tile batching does not change the result; the pair counts (all
    evaluated, composited, and each tile's reach) equal a direct per-pixel
    walk of the sequential loop."""
    js, jp, jb, tprep, tb = _case(rng)
    F_rows = _packed(tprep)
    args = (F_rows, 4, tb.gauss_id, tb.tile_start, tb.tile_count, js.grid_x)
    b1, t1, pairs = trender.composite_fwd_torch(*args, count_pairs=True)
    monkeypatch.setattr(trender, "PLAIN_BATCH_ELEMS", 256)
    b2, t2 = trender.composite_fwd_torch(*args)
    np.testing.assert_allclose(b2.numpy(), b1.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t2.numpy(), t1.numpy(), rtol=1e-6, atol=1e-7)

    # the sequential loop of every pixel of a tile, in lockstep: a pixel
    # counts each instance it evaluates until its T would fall below 1e-4
    rows = F_rows.numpy().astype(np.float64)
    gid = tb.gauss_id.numpy()
    p = np.arange(256)
    want = want_hit = 0
    want_reach = np.zeros(js.num_tiles, np.int64)
    for tile in range(js.num_tiles):
        s, c = int(tb.tile_start[tile]), int(tb.tile_count[tile])
        px = (tile % js.grid_x) * 16 + p % 16
        py = (tile // js.grid_x) * 16 + p // 16
        T = np.ones(256)
        live = np.ones(256, bool)
        for k in range(c):
            want += int(live.sum())
            if live.any():
                want_reach[tile] = k + 1
            r = rows[gid[s + k]]
            dx, dy = r[0] - px, r[1] - py
            power = -0.5 * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
            # log-opacity <= 0, so the clamp only touches power > 0 (skipped)
            a = np.minimum(0.99, np.exp(np.minimum(r[5] + power, 0.0)))
            hit = live & (power <= 0) & (a >= 1 / 255)
            stop = hit & (T * (1 - a) < 1e-4)
            want_hit += int((hit & ~stop).sum())
            live &= ~stop
            T = np.where(hit & ~stop, T * (1 - a), T)
    assert int(pairs.hit + pairs.gated) == want
    assert int(pairs.hit) == want_hit
    np.testing.assert_array_equal(pairs.reach.numpy(), want_reach)
    assert 0 < want_hit < want
