"""Camera-batch data parallelism of the port in four gloo CPU ranks
against the JAX package's single-camera steps (tests/test_data_parallel.py's
cases and bars, one spawn):
  - make_dp_train_step on {"data": 4}, a camera a rank: the loss equals
    the mean of the four single-camera losses (rtol 1e-4), the parameters
    move and stay finite, denom counts cameras;
  - the 2-D mesh {"data": 2, "tile": 2} (make_sharded_train_step with
    data_axis): the loss at rtol 1e-4 of the mean, denom the sum (atol
    1e-5), max_radii2d the max (atol 1e-4), xyz_grad_accum the sum (rtol
    2e-3, atol 1e-6) of the single-camera statistics; all four ranks'
    updates bitwise equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import expm

from adgs_tpu.models.env_map import EnvironmentMap, camera_rays
from adgs_tpu.train.config import OptimizationConfig
from adgs_tpu.train.losses import FrameBatch
from adgs_tpu.train.optim import TrainableState, init_adam
from adgs_tpu.train.step import make_train_step
from adgs_tpu_torch.parallel.launch import call_ranks
from tests import scene_fixtures as fx
from tests.test_models_ops import tiny_model
from tests.test_torch_ranks import RANK_ENV
from tests.test_torch_train import TINY_ORDER

KW = dict(frame_gap=0.05, scene_extent=10.0, cameras_extent=10.0)
OPT = dict(lambda_depth=0.1, lambda_flow=0.0, lambda_obj=0.0,
           lambda_sky=0.05, lambda_sigma=0.0, lambda_reg=0.0,
           lambda_sigma_reg=0.0)
SHAPES = {"dp": ({"data": 4}, 32, 32), "2d": ({"data": 2, "tile": 2}, 64, 48)}


def _leaves(obj):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _inputs(B, H, W):
    """tests/test_data_parallel.py's inputs: the JAX side, and the numpy
    model the ranks rebuild."""
    rng = np.random.default_rng(0)
    params, state, cfg, _ = tiny_model(rng, n=80, quantum=128)
    env = EnvironmentMap.create(resolution=16)
    cams, batches, rays, pcams, pbatches = [], [], [], [], []
    for b in range(B):
        cam = fx.make_camera(width=W, height=H, time=0.1 * b,
                             rng=np.random.default_rng(b))
        a = np.random.default_rng(b).normal(size=3) * 0.1
        R = expm(np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                           [-a[1], a[0], 0]]))
        pcams.append(dict(R=R, T=np.array([0.0, 0.0, 4.0]), fovx=1.1,
                          fovy=0.9, width=W, height=H, time=0.1 * b))
        arrays = dict(
            image=rng.uniform(size=(3, H, W)).astype(np.float32),
            depth=rng.uniform(size=(H, W)).astype(np.float32),
            sky=np.zeros((H, W), np.float32),
            semantic=np.zeros((H, W), np.float32))
        pbatches.append(arrays)
        cams.append(cam)
        batches.append(FrameBatch(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}))
        rays.append(camera_rays(cam.focal_x, H, W).astype(np.float32))
    opt = OptimizationConfig(**OPT)
    model = dict(order=TINY_ORDER, frame_num=20, sh_degree=2,
                 params=_leaves(params), state=_leaves(state),
                 env=np.asarray(env.grid), cams=pcams, rays=rays,
                 batches=pbatches, opt=dataclasses.asdict(opt),
                 active_sh_degree=0)
    jax_side = (params, state, cfg, env, opt, cams, batches, rays)
    return jax_side, model


def _singles(jax_side):
    params, state, cfg, env, opt, cams, batches, rays = jax_side
    step = make_train_step(cfg, opt, capacity=1 << 12, max_per_tile=128,
                           **KW)
    opt_state = init_adam(TrainableState(gaussians=params, env=env))
    return [step(params, env, opt_state, state, cam, batch, jnp.asarray(ray),
                 jnp.float32(1), active_sh_degree=0)
            for cam, batch, ray in zip(cams, batches, rays)]


@pytest.fixture(scope="module")
def runs():
    jobs, refs = [], {}
    for name, (shape, H, W) in SHAPES.items():
        B = shape["data"]
        jax_side, model = _inputs(B, H, W)
        refs[name] = (jax_side, _singles(jax_side))
        if name == "dp":
            jobs.append(("dp_ranks", dict(model=model, shape=shape,
                                          capacity=1 << 12, kw=KW,
                                          iteration=1.0)))
        else:
            jobs.append(("step_ranks", dict(
                model=model, shape=shape, capacity=1 << 12, kw=KW,
                iteration=1.0, data_axis="data",
                cases=[dict(loss_mode="slab", exchange=True)])))
    ranks = call_ranks("tests.test_torch_ranks:jobs_ranks", 4,
                       dict(world_shape={"ranks": 4}, jobs=jobs),
                       timeout=240, env=RANK_ENV)
    return refs, ranks


def test_dp_step_matches_mean_of_cameras(runs):
    refs, ranks = runs
    (params, *_), singles = refs["dp"]
    got = ranks[0][0]
    np.testing.assert_allclose(
        float(got["logs"]["total_loss"]),
        np.mean([float(s[4]["total_loss"]) for s in singles]), rtol=1e-4)
    assert not np.allclose(got["params"]["gaussians"]["scene_opacity"],
                           np.asarray(params.scene_opacity))
    assert float(np.max(got["state"]["denom"])) >= 2.0
    assert np.all(np.isfinite(got["params"]["gaussians"]["scene_xyz"]))
    for r in range(1, 4):
        np.testing.assert_array_equal(
            ranks[r][0]["params"]["gaussians"]["scene_xyz"],
            got["params"]["gaussians"]["scene_xyz"])


def test_dp_tile_2d_mesh_matches_single_device(runs):
    refs, ranks = runs
    (params, *_), singles = refs["2d"]
    got = ranks[0][1][0]
    np.testing.assert_allclose(
        float(got["logs"]["total_loss"]),
        np.mean([float(s[4]["total_loss"]) for s in singles]), rtol=1e-4)
    stats = [s[3] for s in singles]
    np.testing.assert_allclose(
        got["state"]["denom"],
        np.sum([np.asarray(s.denom) for s in stats], axis=0), atol=1e-5)
    np.testing.assert_allclose(
        got["state"]["max_radii2d"],
        np.max([np.asarray(s.max_radii2d) for s in stats], axis=0),
        atol=1e-4)
    np.testing.assert_allclose(
        got["state"]["xyz_grad_accum"],
        np.sum([np.asarray(s.xyz_grad_accum) for s in stats], axis=0),
        rtol=2e-3, atol=1e-6)
    assert not np.allclose(got["params"]["gaussians"]["scene_opacity"],
                           np.asarray(params.scene_opacity))
    assert np.all(np.isfinite(got["params"]["gaussians"]["scene_xyz"]))
    for r in range(1, 4):
        other = ranks[r][1][0]
        for part in ("params", "m", "v"):
            for k, v in got[part]["gaussians"].items():
                np.testing.assert_array_equal(other[part]["gaussians"][k], v,
                                              err_msg=f"rank {r} {part}.{k}")
            np.testing.assert_array_equal(other[part]["env"],
                                          got[part]["env"])
