"""The port's per-group Adam (adgs_tpu_torch.train.optim) against the JAX
package's on identical numpy inputs: the learning-rate schedule, the
per-leaf rate table and three Adam steps, at rtol 1e-6."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from adgs_tpu.models.env_map import EnvironmentMap as JEnv
from adgs_tpu.train import optim as jopt
from adgs_tpu.train.config import OptimizationConfig as JOpt
from adgs_tpu_torch import convert
from adgs_tpu_torch.train import optim as topt
from tests.test_models_ops import tiny_model

TOL = dict(rtol=1e-6, atol=0)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01,
         max_steps=60_000),
    dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=500, lr_delay_mult=0.1,
         max_steps=30_000)])
def test_expon_lr(kw):
    for step in (-1, 0, 1, 250, 1000, 29_999, 60_000, 90_000):
        np.testing.assert_allclose(
            float(topt.expon_lr(step, **kw)),
            float(jopt.expon_lr(jnp.float32(step), **kw)), err_msg=str(step),
            **TOL)
    assert float(topt.expon_lr(5, 0.0, 0.0)) == 0.0


def test_lr_tree():
    opt = JOpt(object_extent=7.0)
    port_opt = convert.opt_config_from_dict(dataclasses.asdict(opt))
    for step in (0, 1000, 45_000):
        want = jopt.lr_tree(opt, 20.0, 3.0, jnp.float32(step))
        got = topt.lr_tree(port_opt, 20.0, 3.0, step)
        names = [f.name for f in dataclasses.fields(got.gaussians)]
        assert len(names) == 18
        for name in names:
            np.testing.assert_allclose(
                float(getattr(got.gaussians, name)),
                float(getattr(want.gaussians, name)), err_msg=name, **TOL)
        np.testing.assert_allclose(float(got.env.grid), float(want.env.grid),
                                   **TOL)


def _leaves(obj):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_adam_update(rng):
    params, _, _, _ = tiny_model(rng, n=40, quantum=32)
    env = JEnv.create(resolution=8)
    jtr = jopt.TrainableState(gaussians=params, env=env)
    ttr = convert.trainables_from_numpy(_leaves(params), np.asarray(env.grid),
                                        device="cpu")
    jstate, tstate = jopt.init_adam(jtr), topt.init_adam(ttr)
    opt = JOpt()
    port_opt = convert.opt_config_from_dict(dataclasses.asdict(opt))
    for it in (1, 2, 3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in _leaves(params).items()}
        g_env = rng.normal(size=env.grid.shape).astype(np.float32)
        jg = jopt.TrainableState(
            gaussians=dataclasses.replace(
                params, **{k: jnp.asarray(v) for k, v in grads.items()}),
            env=JEnv(grid=jnp.asarray(g_env)))
        tg = convert.trainables_from_numpy(grads, g_env, device="cpu")
        jtr, jstate = jopt.adam_update(
            jtr, jg, jstate, jopt.lr_tree(opt, 20.0, 10.0, jnp.float32(it)))
        ttr, tstate = topt.adam_update(
            ttr, tg, tstate, topt.lr_tree(port_opt, 20.0, 10.0, it))
    assert int(tstate.count) == int(jstate.count) == 3
    for name, want, got in zip(
            [f.name for f in dataclasses.fields(params)] + ["env"],
            [getattr(jtr.gaussians, f.name)
             for f in dataclasses.fields(params)] + [jtr.env.grid],
            topt.leaves(ttr)):
        # atol, 1e-6 of the leaf's largest value: an element that lands
        # near zero keeps the last-bit rounding of the larger values it
        # was computed from
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, err_msg=name,
                                   rtol=1e-6, atol=1e-6 * np.abs(want).max())
    for jt, tt in ((jstate.m, tstate.m), (jstate.v, tstate.v)):
        for want, got in zip(jax.tree.leaves(jt), topt.leaves(tt)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # carried across from numpy, an Adam state round-trips
    back = convert.adam_from_numpy(
        _leaves(jstate.m.gaussians), np.asarray(jstate.m.env.grid),
        _leaves(jstate.v.gaussians), np.asarray(jstate.v.env.grid),
        int(jstate.count), device="cpu")
    for a, b in zip(topt.leaves(back.v), topt.leaves(tstate.v)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
