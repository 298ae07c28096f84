"""The rows instance layout of the port (B6 lane pad, build_instances_rows,
CompositePacked under layout "rows") against the JAX package with
ADGS_RM=1 (adgs_tpu.raster.pallas.render.RM set for the test, Pallas in
interpret mode), and the port of exp/lab_rowmajor.py (the plain twins of
kernels E1 and E2) against a float64 numpy transcription of the lab
kernels' bodies.

Bars: B6 bitwise; the rows layout's forward 1e-4 (test_torch_composite.py)
and its d_packed rtol 5e-3, atol 2e-5 (test_torch_composite_bwd.py), each
also bitwise equal to the port's own gather layout; E1/E2 rtol 1e-5 with
atol 1e-5 of max|reference| (sums of 256 per products of N(0,1) values,
some of them near 0)."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.raster.pallas import render as jpal
from adgs_tpu_torch.exp import lab_rowmajor as lab
from adgs_tpu_torch.raster import render as trender
from tests.test_torch_composite import TOL, _case
from tests.test_torch_composite_bwd import BARS, _cotangents, _scene
from tests.test_torch_preprocess import port_settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(16, 1500), (8, 1024)])
def test_pad_to_lanes_matches_jax(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jpal.pad_to_lanes(jnp.asarray(x)))
    got = trender.pad_to_lanes(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    # the [N, F] packed rows taken as their transpose, with no copy
    rows = torch.as_tensor(np.ascontiguousarray(x.T))
    np.testing.assert_array_equal(trender.pad_to_lanes(rows.t()).numpy(),
                                  want)
    assert got.shape == (-(-shape[1] // 1024) * 1024, 128)


def test_build_instances_rows(rng):
    _, _, jb, tprep, tb = _case(rng)
    packed = torch.as_tensor(rng.normal(size=(tprep.depth.shape[0], 16))
                             .astype(np.float32))
    inst = trender.build_instances_rows(tb.gauss_id, packed)
    assert inst.shape == (tb.gauss_id.shape[0], 128)
    np.testing.assert_array_equal(inst[:, :16].numpy(),
                                  packed[tb.gauss_id.long()].numpy())
    assert torch.all(inst[:, 16:] == 0)
    # the JAX rows are the same, plus 256 trailing rows of Gaussian 0
    want = np.asarray(jpal.build_instances_rm(jb.gauss_id,
                                              jnp.asarray(packed.numpy()), 16))
    np.testing.assert_array_equal(inst.numpy(), want[:inst.shape[0]])


@pytest.mark.parametrize("extra", ["none", "flow_semantic"])
def test_rows_render_matches_jax_rm(rng, monkeypatch, extra):
    js, jp, jb, tprep, tb = _case(rng)
    n = jp.depth.shape[0]
    flow = sem = None
    names = ["color", "depth", "opacity"]
    if extra == "flow_semantic":
        flow = rng.normal(size=(n, 3)).astype(np.float32)
        sem = rng.uniform(size=(n, 1)).astype(np.float32)
        names += ["flow", "semantic"]
    monkeypatch.setattr(jpal, "RM", 1)
    pal = jpal.render_pallas(
        jp, jb, js, flow_points=None if flow is None else jnp.asarray(flow),
        semantic=None if sem is None else jnp.asarray(sem))
    ps = port_settings(js)
    kw = dict(flow_points=None if flow is None else torch.as_tensor(flow),
              semantic=None if sem is None else torch.as_tensor(sem))
    rows = trender.render(tprep, tb, ps, layout="rows", **kw)
    gather = trender.render(tprep, tb, ps, **kw)
    for name in names:
        got = getattr(rows, name).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(pal, name)),
                                   err_msg=name, **TOL)
        np.testing.assert_array_equal(got, getattr(gather, name).numpy(),
                                      err_msg=name)


def _d_packed(packed, tb, ch, grid_x, gb, gt, layout):
    p = packed.clone().requires_grad_(True)
    blended, final_t = trender.CompositePacked.apply(p, tb, ch, grid_x,
                                                     layout)
    (d,) = torch.autograd.grad(
        (blended * torch.as_tensor(gb)).sum()
        + (final_t * torch.as_tensor(gt)).sum(), p)
    return d


def test_rows_backward_matches_jax_rm(rng, monkeypatch):
    js, jb, _, tb, packed, ch = _scene(rng, "ch8")
    gb, gt = _cotangents(rng, js.num_tiles, ch)
    got = _d_packed(packed, tb, ch, js.grid_x, gb, gt, "rows")
    monkeypatch.setattr(jpal, "RM", 1)
    bin_info = (jb.gauss_id, jb.slot_sorted, jb.tile_start, jb.tile_count,
                jb.gauss_start, jb.num_rendered)
    _, vjp = jax.vjp(lambda p: jpal.composite_packed(
        p, bin_info, ch, js.num_tiles, js.grid_x), jnp.asarray(packed.numpy()))
    (want,) = vjp(jpal._CompositeOut(blended=jnp.asarray(gb),
                                     final_t=jnp.asarray(gt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BARS)
    gather = _d_packed(packed, tb, ch, js.grid_x, gb, gt, "gather")
    np.testing.assert_array_equal(got.numpy(), gather.numpy())


def test_unknown_layout_refused(rng):
    js, _, _, tprep, tb = _case(rng)
    with pytest.raises(ValueError, match="layout"):
        trender.render(tprep, tb, port_settings(js), layout="columns")


def _lab_reference(x: np.ndarray, p: lab.Programs) -> np.ndarray:
    """The lab kernels' bodies in float64: per program, over its chunks,
    acc += geom[:8] @ geom[8:].T with geom the chunk's [16, CHUNK]
    component-major block."""
    out = np.zeros((p.nprog, 8, 8))
    for i in range(p.nprog):
        acc = np.zeros((8, 8))
        for c in range(p.per):
            base = (i * p.per + c) * lab.CHUNK
            geom = x[base:base + lab.CHUNK].T
            acc += geom[:8] @ geom[8:].T
        out[i] = acc
    return out


@pytest.mark.parametrize("n,r,per", [(3000, 8192, 1), (20000, 1_000_000, 2)])
def test_lab_block_sums_match_lab_kernels(rng, n, r, per):
    p = lab.programs(r)
    assert p.per == per
    inp = lab.make_inputs(n, r, rng, "cpu")
    ref = _lab_reference(inp.packed.numpy().astype(np.float64)[
        inp.gid.numpy()], p)
    atol = 1e-5 * np.abs(ref).max()
    if r == 1_000_000:
        assert r // lab.CHUNK - p.nprog * p.per == 162   # chunks never read
    for v in lab.VARIANTS:
        got = lab.run_variant(v, inp, p)
        assert got.shape == (p.nprog, 8, 8)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=atol,
                                   err_msg=v.label)
    blk = lab.rm_blocks(inp.inst_rm, p)
    np.testing.assert_allclose(lab.library_block_sums(blk).numpy(), ref,
                               rtol=1e-5, atol=atol)
    # the layouts the build functions produce hold the same instance values
    np.testing.assert_array_equal(lab.build_wide_cm(inp.packed, inp.gid),
                                  inp.inst_cm)


def test_lab_runs_to_its_end():
    r = subprocess.run(
        [sys.executable, "-m", "adgs_tpu_torch.exp.lab_rowmajor",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "LAB_N": "2000", "LAB_R": "9000"})
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 8
    assert all(" ms" in line for line in lines[1:])
    assert lines[4].startswith("kernel read component-major")
