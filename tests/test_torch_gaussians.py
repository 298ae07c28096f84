"""adgs_tpu_torch.models.gaussians and convert against adgs_tpu.models:
weights carried across, create_from_pcd padding, and the deformation
(`deform`, the plain version on CPU tensors) of the KITTI-75 model at
three times (1e-5)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.models import gaussians as jgm
from adgs_tpu_torch import convert
from adgs_tpu_torch.models import gaussians as tgm

KITTI_75 = dict(xyz=[None, 5, 0, 6, 0, 0], rotation=[0, 0, 0, 0, None, 5],
                shs=[0, 0, 0, 6, 0, 0], background=[None, 5, 0, 6, 0, 0])
TOL = dict(rtol=1e-5, atol=1e-5)


def _cloud(rng, n):
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    obj = (rng.random(n) < 0.3).astype(np.float32)
    times = rng.uniform(size=n).astype(np.float32)
    d2 = rng.uniform(0.001, 0.05, size=n).astype(np.float32)
    return pts, cols, obj, times, d2


def _jax_model(rng, n=600, quantum=256):
    """A KITTI-75 JAX model whose deformation and time sigmas are large
    enough to move things (the 1e-5 init would hide the splines)."""
    cfg = jgm.GaussianConfig.from_order_args(KITTI_75, frame_num=60)
    pts, cols, obj, times, d2 = _cloud(rng, n)
    params, state = jgm.create_from_pcd(pts, cols, obj, times, cfg, d2,
                                        capacity_quantum=quantum)
    params = jgm.set_init_time_sigma(params, 0.2)

    def noisy(a, s):
        return a + jnp.asarray(rng.normal(size=a.shape).astype(np.float32)) * s

    params = dataclasses.replace(
        params,
        xyz_deform=noisy(params.xyz_deform, 0.1),
        rotation_deform=noisy(params.rotation_deform, 0.1),
        scene_shs_deform=noisy(params.scene_shs_deform, 0.1),
        obj_shs_deform=noisy(params.obj_shs_deform, 0.1),
        background_deform=noisy(params.background_deform, 0.1),
        scene_shs_rest=noisy(params.scene_shs_rest, 0.1),
        obj_shs_rest=noisy(params.obj_shs_rest, 0.1))
    return cfg, params, state


def _leaves(obj):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _port_model(cfg_j, params, state):
    cfg = tgm.GaussianConfig.from_order_args(KITTI_75, frame_num=60)
    assert tuple(map(tuple, cfg[1:5])) == tuple(map(tuple, cfg_j[1:5]))
    return (cfg, convert.params_from_numpy(_leaves(params), device="cpu"),
            convert.state_from_numpy(_leaves(state), device="cpu"))


def test_convert_round_trip(rng):
    _, params, state = _jax_model(rng)
    for obj, build in ((params, convert.params_from_numpy),
                       (state, convert.state_from_numpy)):
        leaves = _leaves(obj)
        back = convert.to_numpy(build(leaves, device="cpu"))
        assert back.keys() == leaves.keys()
        for k in leaves:
            np.testing.assert_array_equal(back[k], leaves[k], err_msg=k)
    with pytest.raises(KeyError):
        convert.params_from_numpy({"scene_xyz": np.zeros((1, 3))},
                                  device="cpu")


def test_create_from_pcd_matches(rng):
    pts, cols, obj, times, d2 = _cloud(rng, 500)
    cfg_j = jgm.GaussianConfig.from_order_args(KITTI_75, frame_num=60)
    cfg_t = tgm.GaussianConfig.from_order_args(KITTI_75, frame_num=60)
    pj, sj = jgm.create_from_pcd(pts, cols, obj, times, cfg_j, d2,
                                 capacity_quantum=256, seed=3)
    pt, st = tgm.create_from_pcd(pts, cols, obj, times, cfg_t, d2,
                                 capacity_quantum=256, seed=3, device="cpu")
    for a, b in ((pj, pt), (sj, st)):
        ref, port = _leaves(a), convert.to_numpy(b)
        for k in ref:
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=0,
                                       err_msg=k)
    # padding: dead slots hold zeros, identity quats, -15 logit, -10 log-scale
    ns = int((obj <= 0.5).sum())
    assert pt.scene_xyz.shape[0] % 256 == 0 and pt.scene_xyz.shape[0] > ns
    dead = slice(ns, None)
    assert torch.all(pt.scene_xyz[dead] == 0)
    assert torch.all(pt.scene_rotation[dead] == torch.tensor([1.0, 0, 0, 0]))
    assert torch.all(pt.scene_opacity[dead] == -15.0)
    assert torch.all(pt.scene_scaling[dead] == -10.0)
    assert not st.scene_alive[dead].any() and st.scene_alive[:ns].all()


@pytest.mark.parametrize("t", [0.0, 0.37, 0.93])
def test_deformed_package(rng, t):
    cfg_j, params, state = _jax_model(rng)
    cfg, tp, ts = _port_model(cfg_j, params, state)
    ref = jgm.deformed_package(params, state, cfg_j, jnp.float32(t))
    port, _ = tgm.deform(tp, ts, cfg, torch.tensor(t))
    for k in ("xyz", "rotation", "shs", "opacity"):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(tgm.activated_scaling(tp).numpy(),
                               np.asarray(jgm.activated_scaling(params)),
                               **TOL)


def test_alive_counts(rng):
    """GaussianState.num_scene / num_obj: 0-d counts, as JAX's."""
    _, _, state_j = _jax_model(rng)
    leaves = _leaves(state_j)
    leaves["obj_alive"][::3] = False
    state_j = dataclasses.replace(state_j,
                                  obj_alive=jnp.asarray(leaves["obj_alive"]))
    state = convert.state_from_numpy(leaves, device="cpu")
    for name in ("num_scene", "num_obj"):
        got = getattr(state, name)
        assert got.dim() == 0
        assert int(got) == int(getattr(state_j, name)) > 0
