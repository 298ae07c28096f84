"""One training step of the port (adgs_tpu_torch.train.step) against the
JAX package's make_train_step (its XLA tier on the CPU), on the tiny
fixture of tests/test_train.py (120 Gaussians, 48x32 camera, env 32^2,
active_sh_degree 0) with every loss term on and KNN groups set:
  - the loss logs at rtol 1e-4;
  - the gradients before Adam at rtol 5e-3, atol 2e-5 (JAX's are read
    from its first-step first moment, m = 0.1 g);
  - the updated parameters at atol 1e-5, except where JAX's gradient is
    below 2e-5 in magnitude: there Adam's first step lr * g / |g| can
    flip sign with rounding noise, so the bound is 2 lr of the group;
  - the densification statistics: denom and max_radii2d exact,
    xyz_grad_accum at rtol 5e-3, atol 2e-5;
plus a 20-step loss-decrease smoke test of the port alone."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.models import gaussians as jgm
from adgs_tpu.models.env_map import EnvironmentMap as JEnv
from adgs_tpu.models.env_map import camera_rays
from adgs_tpu.ops import knn
from adgs_tpu.ops.flow import FlowPackage as JFlow
from adgs_tpu.train.config import OptimizationConfig as JOpt
from adgs_tpu.train.losses import FrameBatch as JBatch
from adgs_tpu.train.optim import TrainableState as JTrainable
from adgs_tpu.train.optim import init_adam as jinit_adam
from adgs_tpu.train.step import make_train_step as jmake_train_step
from adgs_tpu_torch import convert
from adgs_tpu_torch.core.camera import Camera as TCamera
from adgs_tpu_torch.models import gaussians as tgm
from adgs_tpu_torch.ops.image import psnr
from adgs_tpu_torch.render import render as trender_frame
from adgs_tpu_torch.train import optim as topt
from adgs_tpu_torch.train.step import make_train_step
from tests import scene_fixtures as fx
from tests.test_models_ops import tiny_model

W, H = 48, 32
STEP_KW = dict(frame_gap=0.05, scene_extent=10.0, cameras_extent=10.0)
ITERATION = 1000
GRAD_BARS = dict(rtol=5e-3, atol=2e-5)
TINY_ORDER = dict(xyz=[4, 2, 0, 2, 0, 0], rotation=[0, 0, 0, 0, 4, 2],
                  shs=[0, 0, 0, 2, 0, 0], background=[0, 0, 1, 0, 0, 0])


def _leaves(obj):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _batch_arrays(rng):
    yy, xx = np.mgrid[0:H, 0:W]
    image = np.stack([xx / W, yy / H, 0.5 * np.ones_like(xx)], 0)
    fxl = 0.5 * W / np.tan(0.55)
    K = np.array([[fxl, 0, W / 2], [0, fxl, H / 2], [0, 0, 1]], np.float32)
    sky = np.zeros((H, W), np.float32)
    sky[:4] = 1.0
    return dict(
        image=image.astype(np.float32),
        depth=rng.uniform(0.2, 1.0, size=(H, W)).astype(np.float32),
        sky=sky,
        semantic=(rng.random((H, W)) < 0.3).astype(np.float32),
        flow=dict(time=np.float32(0.35), K=K, R=np.eye(3, dtype=np.float32),
                  T=np.array([0.0, 0.0, 4.0], np.float32),
                  flow=(rng.uniform(size=(2, H, W)) * [[[W]], [[H]]])
                  .astype(np.float32),
                  vis=np.ones((H, W), np.float32)),
        flow_valid=True)


def _jax_batch(a):
    f = a["flow"]
    return JBatch(image=jnp.asarray(a["image"]), depth=jnp.asarray(a["depth"]),
                  sky=jnp.asarray(a["sky"]),
                  semantic=jnp.asarray(a["semantic"]),
                  flow=JFlow(**{k: jnp.asarray(v) for k, v in f.items()}),
                  flow_valid=jnp.asarray(a["flow_valid"]))


def _setup(rng, opt_fields=None):
    """(JAX pieces, port pieces) of the same scene, batch and config."""
    params, state, cfg, _ = tiny_model(rng, n=120, quantum=128)
    params = jgm.set_init_time_sigma(params, 0.05)
    # spread the time sigmas and trajectories so that both KNN variances
    # (and their gradients) are far from zero
    params = dataclasses.replace(
        params,
        gs_time_sigma=params.gs_time_sigma + jnp.asarray(
            rng.normal(size=params.gs_time_sigma.shape).astype(np.float32)
            * 0.2),
        xyz_deform=params.xyz_deform + jnp.asarray(
            rng.normal(size=params.xyz_deform.shape).astype(np.float32)
            * 0.02))
    no = int(state.num_obj)
    pts = np.asarray(params.obj_xyz[:no])
    anchors = pts[:: max(1, no // 8)][:8]
    idx = knn.knn_indices(anchors, pts, k=4)
    state = dataclasses.replace(
        state, obj_near_idx=jnp.asarray(idx),
        obj_near_valid=jnp.asarray(np.arange(idx.shape[0]) < 7))
    jcam = fx.make_camera(width=W, height=H, time=0.3)
    env = JEnv.create(resolution=32)
    rays = camera_rays(jcam.focal_x, H, W)
    arrays = _batch_arrays(rng)
    jopt = JOpt(**(opt_fields or {}))

    tcfg = tgm.GaussianConfig.from_order_args(TINY_ORDER, frame_num=20,
                                              sh_degree=2)
    assert tuple(map(tuple, tcfg[1:5])) == tuple(map(tuple, cfg[1:5]))
    port = dict(
        cfg=tcfg,
        params=convert.params_from_numpy(_leaves(params), device="cpu"),
        state=convert.state_from_numpy(_leaves(state), device="cpu"),
        env=convert.env_from_numpy(np.asarray(env.grid), device="cpu"),
        cam=TCamera.create(R=np.eye(3), T=np.array([0.0, 0.0, 4.0]),
                           fovx=1.1, fovy=0.9, width=W, height=H, time=0.3,
                           device="cpu"),
        rays=torch.as_tensor(rays),
        batch=convert.batch_from_numpy(arrays, device="cpu"),
        opt=convert.opt_config_from_dict(dataclasses.asdict(jopt)))
    jax_side = dict(cfg=cfg, params=params, state=state, env=env, cam=jcam,
                    rays=jnp.asarray(rays), batch=_jax_batch(arrays),
                    opt=jopt)
    return jax_side, port


def _jax_step(j):
    step = jmake_train_step(j["cfg"], j["opt"], capacity=1 << 13,
                            max_per_tile=256, **STEP_KW)
    opt_state = jinit_adam(JTrainable(gaussians=j["params"], env=j["env"]))
    return step(j["params"], j["env"], opt_state, j["state"], j["cam"],
                j["batch"], j["rays"], jnp.float32(ITERATION),
                active_sh_degree=0)


def _port_step(p):
    step = make_train_step(p["cfg"], p["opt"], capacity=1 << 13, **STEP_KW)
    opt_state = topt.init_adam(topt.TrainableState(gaussians=p["params"],
                                                   env=p["env"]))
    args = (p["params"], p["env"], p["state"], p["cam"], p["batch"],
            p["rays"])
    lg = step.loss_and_grads(*args, active_sh_degree=0)
    out = step(p["params"], p["env"], opt_state, p["state"], p["cam"],
               p["batch"], p["rays"], ITERATION, active_sh_degree=0)
    return lg, out


@pytest.fixture(scope="module")
def one_step():
    jax_side, port = _setup(np.random.default_rng(0))
    return jax_side, port, _jax_step(jax_side), _port_step(port)


def test_loss_logs_match(one_step):
    _, _, jout, (_, pout) = one_step
    jlogs, plogs = jout[4], pout[4]
    assert set(plogs) == set(jlogs)
    for k in ("l1_loss", "dssim_loss", "depth_loss", "flow_loss", "obj_loss",
              "sky_loss", "reg_loss", "sigma_loss", "sigma_reg_loss"):
        assert float(jlogs[k]) != 0.0, k            # every term is on
    for k in jlogs:
        np.testing.assert_allclose(float(plogs[k]), float(jlogs[k]),
                                   rtol=1e-4, err_msg=k)


def _pairs(j_tree, p_tree):
    """(name, JAX array, port tensor) per trainable leaf."""
    names = [f.name for f in dataclasses.fields(p_tree.gaussians)]
    jl = [getattr(j_tree.gaussians, n) for n in names] + [j_tree.env.grid]
    return zip(names + ["env"], jl, topt.leaves(p_tree))


def test_gradients_before_adam_match(one_step):
    _, _, jout, (lg, _) = one_step
    m = jout[2].m
    nonzero = 0
    for name, jm, pg in _pairs(m, lg.grads):
        jg = np.asarray(jm) / np.float32(1.0 - 0.9)
        np.testing.assert_allclose(pg.numpy(), jg, err_msg=name, **GRAD_BARS)
        nonzero += int(np.abs(jg).max() > 0)
    assert nonzero >= 15        # the loss reaches almost every leaf


def test_updated_parameters_match(one_step):
    _, port, jout, (lg, pout) = one_step
    lrs = topt.lr_tree(port["opt"], STEP_KW["scene_extent"],
                       STEP_KW["cameras_extent"], ITERATION)
    new_p = topt.TrainableState(gaussians=pout[0], env=pout[1])
    j_new = JTrainable(gaussians=jout[0], env=jout[1])
    jm = jout[2].m
    for (name, jp, pp), (_, jmm, _), lr in zip(
            _pairs(j_new, new_p), _pairs(jm, new_p), topt.leaves(lrs)):
        jg = np.abs(np.asarray(jmm) / np.float32(0.1))
        bound = np.where(jg < 2e-5, 2.0 * float(lr) + 1e-5, 1e-5)
        diff = np.abs(pp.numpy() - np.asarray(jp))
        assert np.all(diff <= bound), (name, float(diff.max()))
    assert int(pout[2].count) == 1


def test_densification_statistics_match(one_step):
    _, _, jout, (_, pout) = one_step
    js, ps = jout[3], pout[3]
    np.testing.assert_array_equal(ps.denom.numpy(), np.asarray(js.denom))
    np.testing.assert_array_equal(ps.max_radii2d.numpy(),
                                  np.asarray(js.max_radii2d))
    assert float(ps.denom.sum()) > 0
    np.testing.assert_allclose(ps.xyz_grad_accum.numpy(),
                               np.asarray(js.xyz_grad_accum), **GRAD_BARS)
    assert int(pout[4]["num_rendered"]) == int(jout[4]["num_rendered"])


def test_loss_decreases_and_psnr_rises():
    """20 steps of the port alone, photometric losses and the sky term (the
    smoke test of tests/test_train.py)."""
    _, p = _setup(np.random.default_rng(0), opt_fields=dict(
        lambda_depth=0.0, lambda_flow=0.0, lambda_obj=0.0, lambda_sky=0.05,
        lambda_sigma=0.01, lambda_reg=0.0, lambda_sigma_reg=0.0))
    step = make_train_step(p["cfg"], p["opt"], capacity=1 << 13, **STEP_KW)
    params, env, state = p["params"], p["env"], p["state"]
    opt_state = topt.init_adam(topt.TrainableState(gaussians=params, env=env))

    def frame_psnr():
        with torch.no_grad():
            out = trender_frame(p["cam"], params, state, p["cfg"],
                                env_map=env, cam_rays=p["rays"],
                                active_sh_degree=0, capacity=1 << 13)
        return float(psnr(torch.clamp(out["render"], 0, 1), p["batch"].image))

    psnr0 = frame_psnr()
    losses = []
    for it in range(1, 21):
        params, env, opt_state, state, logs = step(
            params, env, opt_state, state, p["cam"], p["batch"], p["rays"],
            it, active_sh_degree=0)
        losses.append(float(logs["total_loss"]))
    assert losses[-1] < losses[0] * 0.8, losses
    assert frame_psnr() > psnr0 + 1.0
    assert float(state.denom.sum()) > 0
