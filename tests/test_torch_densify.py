"""The port's densification (adgs_tpu_torch/train/densify.py) against the
JAX package's on the tiny model of tests/test_train.py::TestDensify (40
Gaussians, capacities in quanta of 64), with seeded non-zero Adam moments
so that their surgery shows. The split's normal draws are JAX's
(jax.random.split(key), then jax.random.normal(k, (2, C, 3))), fed to
densify_and_prune_eps. Bars: alive masks, report counts and every fill
bitwise; values (parameters, moments, gs_time, statistics) at 1e-6,
relative and absolute: the split's rotation product sums its three terms
in another order than XLA's dot, one ulp apart on the overflow case's
large positions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adgs_tpu.models.env_map import EnvironmentMap as JEnv
from adgs_tpu.train import densify as jdensify
from adgs_tpu.train.optim import AdamState as JAdam
from adgs_tpu.train.optim import TrainableState as JTrainable
from adgs_tpu_torch import convert
from adgs_tpu_torch.train import densify as tdensify
from tests.test_models_ops import tiny_model

ATOL = 1e-6
KW = dict(min_opacity=0.005, percent_dense=0.01)
# one compiled program per capacity (the scalars traced): eager JAX
# compiles each op anew for every capacity, several times slower here
_jdensify_and_prune = jax.jit(jdensify.densify_and_prune)


def _np_leaves(obj):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _setup(seed, n=40, quantum=64):
    """JAX (trainables, opt_state, state) with N(0, 1e-3) moments, and the
    port's copies of them on the CPU."""
    rng = np.random.default_rng(seed)
    params, state, _, _ = tiny_model(rng, n=n, quantum=quantum)
    env = JEnv.create(16)

    def moments():
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-3
             for k, v in _np_leaves(params).items()}
        return g, rng.normal(size=env.grid.shape).astype(np.float32) * 1e-3

    (mg, mgrid), (vg, vgrid) = moments(), moments()
    vg = {k: np.abs(v) for k, v in vg.items()}
    j_tr = JTrainable(gaussians=params, env=env)

    def jparams(d):
        return dataclasses.replace(params, **{k: jnp.asarray(v)
                                              for k, v in d.items()})

    j_opt = JAdam(m=JTrainable(jparams(mg), JEnv(jnp.asarray(mgrid))),
                  v=JTrainable(jparams(vg), JEnv(jnp.asarray(np.abs(vgrid)))),
                  count=jnp.asarray(7, jnp.int32))
    t_tr = convert.trainables_from_numpy(_np_leaves(params),
                                         np.asarray(env.grid), "cpu")
    t_opt = convert.adam_from_numpy(mg, mgrid, vg, np.abs(vgrid), 7, "cpu")
    t_state = convert.state_from_numpy(_np_leaves(state), "cpu")
    return (j_tr, j_opt, state), (t_tr, t_opt, t_state), rng


def _with_state(j, t, **arrays):
    """Replace state fields (numpy arrays) in both packages."""
    j_tr, j_opt, j_st = j
    t_tr, t_opt, t_st = t
    j_st = dataclasses.replace(j_st, **{k: jnp.asarray(v)
                                        for k, v in arrays.items()})
    t_st = dataclasses.replace(t_st, **{k: torch.as_tensor(v)
                                        for k, v in arrays.items()})
    return (j_tr, j_opt, j_st), (t_tr, t_opt, t_st)


def _with_params(j, t, **arrays):
    j_tr, j_opt, j_st = j
    t_tr, t_opt, t_st = t
    j_tr = j_tr._replace(gaussians=dataclasses.replace(
        j_tr.gaussians, **{k: jnp.asarray(v) for k, v in arrays.items()}))
    t_tr = t_tr._replace(gaussians=dataclasses.replace(
        t_tr.gaussians, **{k: torch.as_tensor(v) for k, v in arrays.items()}))
    return (j_tr, j_opt, j_st), (t_tr, t_opt, t_st)


def _assert_state(j_st, t_st):
    jn, tn = _np_leaves(j_st), convert.to_numpy(t_st)
    for name in ("scene_alive", "obj_alive", "obj_near_idx",
                 "obj_near_valid"):
        np.testing.assert_array_equal(tn[name], jn[name], err_msg=name)
    for name in ("gs_time", "max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_allclose(tn[name], jn[name], rtol=ATOL, atol=ATOL,
                                   err_msg=name)


def _assert_trainables(j_tr, j_opt, t_tr, t_opt):
    for what, jg, tg in (("params", j_tr.gaussians, t_tr.gaussians),
                         ("m", j_opt.m.gaussians, t_opt.m.gaussians),
                         ("v", j_opt.v.gaussians, t_opt.v.gaussians)):
        jn, tn = _np_leaves(jg), convert.to_numpy(tg)
        for name in jn:
            assert tn[name].shape == jn[name].shape, (what, name)
            np.testing.assert_allclose(tn[name], jn[name], rtol=ATOL,
                                       atol=ATOL, err_msg=f"{what}.{name}")
    # the sky and its moments are carried, not copied
    assert t_tr.env.grid.shape == tuple(j_tr.env.grid.shape)
    np.testing.assert_array_equal(t_opt.m.env.grid.numpy(),
                                  np.asarray(j_opt.m.env.grid))
    assert int(t_opt.count) == int(j_opt.count)


# (name, state/param edits, densify arguments). Thresholds and extents
# select the path as TestDensify's cases do.
def _case(name, j, t, rng):
    j_st = j[2]
    Ns = j[0].gaussians.scene_capacity
    ns, no = int(j_st.num_scene), int(j_st.num_obj)
    C = j_st.xyz_grad_accum.shape[0]
    ones = np.ones(C, np.float32)
    base = dict(max_scene_grad=0.5, max_obj_grad=1e9, prune_big=False,
                scene_extent=1000.0, object_extent=1000.0)
    if name == "clone":          # all alive scene slots, tiny scales
        accum = np.zeros(C, np.float32)
        accum[:ns] = 1.0
        j, t = _with_state(j, t, xyz_grad_accum=accum, denom=ones)
        return j, t, base
    if name == "split":          # slot 0 only, everything "big"
        accum = np.zeros(C, np.float32)
        accum[:1] = 1.0
        j, t = _with_state(j, t, xyz_grad_accum=accum, denom=ones)
        return j, t, dict(base, scene_extent=1e-6)
    if name == "prune":          # three scene opacities killed
        op = np.array(j[0].gaussians.scene_opacity)
        op[:3] = -20.0
        j, t = _with_params(j, t, scene_opacity=op)
        return j, t, dict(base, max_scene_grad=1e9)
    if name == "mixed":          # both blocks: clones, splits and prunes
        accum = rng.uniform(size=C).astype(np.float32)
        denom = rng.integers(0, 3, size=C).astype(np.float32)
        op = np.array(j[0].gaussians.obj_opacity)
        op[rng.random(op.shape[0]) < 0.2] = -20.0
        sc = np.array(j[0].gaussians.scene_scaling)
        sc[:ns // 2] += 3.0
        j, t = _with_state(j, t, xyz_grad_accum=accum, denom=denom)
        j, t = _with_params(j, t, obj_opacity=op, scene_scaling=sc)
        return j, t, dict(max_scene_grad=0.3, max_obj_grad=0.3,
                          prune_big=True, scene_extent=60.0,
                          object_extent=60.0)
    if name == "overflow":       # more copies wanted than dead slots
        accum = np.ones(C, np.float32)
        sc = np.array(j[0].gaussians.scene_scaling)
        sc[::2] += 8.0
        j, t = _with_state(j, t, xyz_grad_accum=accum, denom=ones)
        j, t = _with_params(j, t, scene_scaling=sc)
        return j, t, dict(base, max_obj_grad=0.5, scene_extent=10.0,
                          object_extent=10.0)
    raise ValueError(name)


@pytest.mark.parametrize("name,n,quantum", [
    ("clone", 40, 64), ("split", 40, 64), ("prune", 40, 64),
    ("mixed", 120, 256), ("overflow", 56, 32)])
def test_densify_and_prune_matches_jax(name, n, quantum):
    j, t, rng = _setup(seed=3, n=n, quantum=quantum)
    j, t, kw = _case(name, j, t, rng)
    kw.update(KW)
    key = jax.random.PRNGKey(11)
    j_tr, j_opt, j_st, j_rep = _jdensify_and_prune(
        *j, key, **dict(kw, prune_big=jnp.asarray(kw["prune_big"])))
    k_scene, k_obj = jax.random.split(key)
    g = j[0].gaussians
    eps = [torch.as_tensor(np.array(jax.random.normal(
        k, (2,) + tuple(s.shape), dtype=s.dtype)))
        for k, s in ((k_scene, g.scene_scaling), (k_obj, g.obj_scaling))]
    before = [convert.to_numpy(x) for x in (t[0].gaussians, t[2])]
    t_tr, t_opt, t_st, t_rep = tdensify.densify_and_prune_eps(*t, *eps, **kw)

    rep = convert.to_numpy(t_rep)
    assert list(rep) == list(j_rep._fields)
    for f in j_rep._fields:
        assert int(rep[f]) == int(getattr(j_rep, f)), f
    _assert_state(j_st, t_st)
    _assert_trainables(j_tr, j_opt, t_tr, t_opt)
    # the inputs are left as they were
    for old, new in zip(before, (t[0].gaussians, t[2])):
        for k, v in convert.to_numpy(new).items():
            np.testing.assert_array_equal(v, old[k], err_msg=k)
    # the case exercised what it names
    if name == "clone":
        assert int(rep["scene_cloned"]) > 0 == int(rep["scene_split"])
    elif name == "split":
        assert int(rep["scene_split"]) == 2
    elif name == "prune":
        assert int(rep["scene_pruned"]) == 3
    elif name == "mixed":
        assert min(int(rep[f]) for f in rep if "dropped" not in f) > 0
    elif name == "overflow":
        assert int(rep["scene_dropped"]) > 0 and int(rep["obj_dropped"]) > 0


def test_densify_and_prune_draws_from_generator():
    """The public entry point draws the split from its generator: the same
    seed gives the same result, and it equals densify_and_prune_eps on
    split_draws of that seed."""
    _, t, rng = _setup(seed=5)
    C = t[2].xyz_grad_accum.shape[0]
    t_st = dataclasses.replace(
        t[2], xyz_grad_accum=torch.ones(C), denom=torch.ones(C))
    kw = dict(KW, max_scene_grad=0.5, max_obj_grad=0.5, prune_big=False,
              scene_extent=1e-6, object_extent=1e-6)
    outs = [tdensify.densify_and_prune(t[0], t[1], t_st,
                                       torch.Generator().manual_seed(9), **kw)
            for _ in range(2)]
    eps = tdensify.split_draws(t[0], torch.Generator().manual_seed(9))
    outs.append(tdensify.densify_and_prune_eps(t[0], t[1], t_st, *eps, **kw))
    assert int(outs[0][3].scene_split) > 0
    for other in outs[1:]:
        for a, b in ((outs[0][0].gaussians, other[0].gaussians),
                     (outs[0][2], other[2])):
            for k, v in convert.to_numpy(a).items():
                np.testing.assert_array_equal(convert.to_numpy(b)[k], v)


def test_reset_opacity_matches_jax():
    j, t, _ = _setup(seed=7)
    j_tr, j_opt = jdensify.reset_opacity(j[0], j[1])
    t_tr, t_opt = tdensify.reset_opacity(t[0], t[1])
    _assert_trainables(j_tr, j_opt, t_tr, t_opt)
    for blk in (t_opt.m.gaussians, t_opt.v.gaussians):
        for f in ("scene_opacity", "obj_opacity"):
            assert not getattr(blk, f).any()
    act = torch.sigmoid(torch.cat([t_tr.gaussians.scene_opacity,
                                   t_tr.gaussians.obj_opacity]))
    assert float(act.max()) <= 0.01 + 1e-6


@pytest.mark.parametrize("ds,do", [(64, 64), (0, 128), (192, 0)])
def test_grow_capacity_matches_jax(ds, do):
    j, t, _ = _setup(seed=9)
    Ns, No = t[0].gaussians.scene_capacity, t[0].gaussians.obj_capacity
    j_tr, j_opt, j_st = jdensify.grow_capacity(*j, Ns + ds, No + do)
    t_tr, t_opt, t_st = tdensify.grow_capacity(*t, Ns + ds, No + do)
    _assert_trainables(j_tr, j_opt, t_tr, t_opt)
    _assert_state(j_st, t_st)
    assert t_tr.env is t[0].env and t_opt.m.env is t[1].m.env
    g = t_tr.gaussians
    # the fills, bitwise
    for f, cap, extra in (("scene", Ns, ds), ("obj", No, do)):
        rot = getattr(g, f + "_rotation")[cap:]
        assert (rot == torch.tensor([1.0, 0, 0, 0])).all()
        assert (getattr(g, f + "_opacity")[cap:] == -15.0).all()
        assert (getattr(g, f + "_scaling")[cap:] == -10.0).all()
        assert not getattr(g, f + "_xyz")[cap:].any()
        assert not getattr(t_st, f + "_alive")[cap:].any()
        assert rot.shape[0] == extra
    for blk in (t_opt.m.gaussians, t_opt.v.gaussians):
        assert not blk.scene_xyz[Ns:].any() and not blk.obj_xyz[No:].any()
    with pytest.raises(ValueError, match="shrink"):
        tdensify.grow_capacity(*t, Ns - 1, No)
