"""Checkpoint files of the port (train/checkpoint.py) against the JAX
package's, both ways, on tests/test_checkpoint.py's fixtures: a PLY +
deform.npz written by one package loads in the other into bitwise equal
parameters, state and config (compared through adgs_tpu_torch.convert),
also after densify punched holes in the alive masks; a full training
snapshot (save_state/load_state) likewise."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from adgs_tpu.models.env_map import EnvironmentMap as JEnv
from adgs_tpu.train import checkpoint as jckpt
from adgs_tpu.train.optim import TrainableState as JTrainable
from adgs_tpu.train.optim import init_adam as jinit_adam
from adgs_tpu_torch import convert
from adgs_tpu_torch.core.splines import BasisConfig
from adgs_tpu_torch.models import gaussians as tgm
from adgs_tpu_torch.train import checkpoint as tckpt
from adgs_tpu_torch.train.optim import init_adam as tinit_adam
from adgs_tpu_torch.train.optim import leaves
from tests.test_models_ops import tiny_model


def _leaves(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _port_config(cfg_j) -> tgm.GaussianConfig:
    return tgm.GaussianConfig(cfg_j.sh_degree, *(BasisConfig(*c)
                                                 for c in cfg_j[1:5]),
                              use_time_mask=cfg_j.use_time_mask)


def _assert_same(port_params, port_state, jparams, jstate):
    for got, want in ((convert.to_numpy(port_params), _leaves(jparams)),
                      (convert.to_numpy(port_state), _leaves(jstate))):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _model(rng, holes: bool):
    params, state, cfg, _ = tiny_model(rng, n=60)
    if holes:
        sa = np.array(state.scene_alive)
        sa[np.nonzero(sa)[0][::3]] = False      # punch holes (post-prune)
        state = dataclasses.replace(state, scene_alive=jnp.asarray(sa))
    return params, state, cfg


@pytest.mark.parametrize("holes", [False, True])
def test_jax_ply_loads_in_port(rng, tmp_path, holes):
    params, state, cfg = _model(rng, holes)
    path = str(tmp_path / "point_cloud.ply")
    jckpt.save_ply(path, params, state, cfg)
    jp, js, jcfg = jckpt.load_ply(path, cfg, capacity_quantum=32)
    tp, ts, tcfg = tckpt.load_ply(path, _port_config(cfg),
                                  capacity_quantum=32, device="cpu")
    _assert_same(tp, ts, jp, js)
    assert tuple(map(tuple, tcfg[1:5])) == tuple(map(tuple, jcfg[1:5]))
    assert tcfg.use_time_mask == jcfg.use_time_mask
    assert tcfg.sh_degree == jcfg.sh_degree


@pytest.mark.parametrize("holes", [False, True])
def test_port_ply_loads_in_jax(rng, tmp_path, holes):
    params, state, cfg = _model(rng, holes)
    tp = convert.params_from_numpy(_leaves(params), device="cpu")
    ts = convert.state_from_numpy(_leaves(state), device="cpu")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.save_ply(str(jdir / "point_cloud.ply"), params, state, cfg)
    tckpt.save_ply(str(tdir / "point_cloud.ply"), tp, ts, _port_config(cfg))
    # the same bytes as the JAX writer's
    assert ((tdir / "point_cloud.ply").read_bytes()
            == (jdir / "point_cloud.ply").read_bytes())
    jz, tz = (np.load(str(d / "deform.npz")) for d in (jdir, tdir))
    assert jz.files == tz.files
    for k in jz.files:
        np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    back_p, back_s, _ = jckpt.load_ply(str(tdir / "point_cloud.ply"), cfg,
                                       capacity_quantum=32)
    want_p, want_s, _ = jckpt.load_ply(str(jdir / "point_cloud.ply"), cfg,
                                       capacity_quantum=32)
    for got, want in ((_leaves(back_p), _leaves(want_p)),
                      (_leaves(back_s), _leaves(want_s))):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_snapshot(rng):
    params, state, cfg, _ = tiny_model(rng, n=40)
    env = JEnv.create(16)
    tr = JTrainable(gaussians=params, env=env)
    opt = jinit_adam(tr)
    noisy = {f.name: getattr(opt.m.gaussians, f.name)
             + jnp.asarray(rng.normal(size=getattr(opt.m.gaussians,
                                                  f.name).shape)
                           .astype(np.float32))
             for f in dataclasses.fields(opt.m.gaussians)}
    opt = opt._replace(m=opt.m._replace(gaussians=dataclasses.replace(
        opt.m.gaussians, **noisy)), count=jnp.int32(1234))
    return tr, opt, state


def _port_snapshot(tr, opt, state):
    ttr = convert.trainables_from_numpy(_leaves(tr.gaussians),
                                        np.asarray(tr.env.grid), device="cpu")
    topt = convert.adam_from_numpy(_leaves(opt.m.gaussians),
                                   np.asarray(opt.m.env.grid),
                                   _leaves(opt.v.gaussians),
                                   np.asarray(opt.v.env.grid),
                                   int(opt.count), device="cpu")
    return ttr, topt, convert.state_from_numpy(_leaves(state), device="cpu")


def _assert_snapshot(ttr, topt, ts, tr, opt, state):
    for got, want in ((leaves(ttr), jax.tree.leaves(tr)),
                      (leaves(topt.m), jax.tree.leaves(opt.m)),
                      (leaves(topt.v), jax.tree.leaves(opt.v))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(topt.count) == int(opt.count)
    _assert_same(ttr.gaussians, ts, tr.gaussians, state)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_snapshot_both_ways(rng, tmp_path, writer):
    tr, opt, state = _jax_snapshot(rng)
    ttr, topt, ts = _port_snapshot(tr, opt, state)
    path = str(tmp_path / "train_state.npz")
    if writer == "jax":
        jckpt.save_state(path, tr, opt, state, iteration=777)
    else:
        tckpt.save_state(path, ttr, topt, ts, iteration=777)
    # the port reads it into tensors of its templates' structure
    tmpl = _port_snapshot(*_jax_snapshot(np.random.default_rng(1)))
    ttr2, topt2, ts2, it = tckpt.load_state(path, *tmpl)
    assert it == 777
    _assert_snapshot(ttr2, topt2, ts2, tr, opt, state)
    # and the JAX package reads it into its own
    jtr2, jopt2, js2, jit = jckpt.load_state(path, tr, opt, state)
    assert jit == 777
    _assert_snapshot(ttr, topt, ts, jtr2, jopt2, js2)


def test_state_shape_mismatch_refused(rng, tmp_path):
    tr, opt, state = _jax_snapshot(rng)
    path = str(tmp_path / "train_state.npz")
    jckpt.save_state(path, tr, opt, state, iteration=3)
    big, _, _, _ = tiny_model(np.random.default_rng(2), n=40, quantum=64)
    ttr = convert.trainables_from_numpy(_leaves(big), np.zeros((3, 16, 16),
                                                               np.float32),
                                        device="cpu")
    with pytest.raises(ValueError, match="template"):
        tckpt.load_state(path, ttr, tinit_adam(ttr),
                         convert.state_from_numpy(_leaves(state),
                                                  device="cpu"))
