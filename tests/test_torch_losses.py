"""The port's image metrics, depth and flow losses and the loss assembly
(adgs_tpu_torch.ops.{image,depth,flow}, adgs_tpu_torch.train.losses)
against the JAX package on the same numpy inputs: values and gradients at
rtol 1e-5, atol 1e-6, with every loss term on and KNN groups set."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.ops import depth as jdepth
from adgs_tpu.ops import flow as jflow
from adgs_tpu.ops import image as jimage
from adgs_tpu.ops import knn
from adgs_tpu.train import losses as jlosses
from adgs_tpu.train.config import OptimizationConfig as JOpt
from adgs_tpu_torch import convert
from adgs_tpu_torch.ops import depth as tdepth
from adgs_tpu_torch.ops import flow as tflow
from adgs_tpu_torch.ops import image as timage
from adgs_tpu_torch.train import losses as tlosses
from tests.test_models_ops import tiny_model
from tests.test_torch_train import _batch_arrays, _jax_batch

TOL = dict(rtol=1e-5, atol=1e-6)
H, W = 32, 48


def _value_and_grads(jfn, tfn, *arrays):
    """(JAX value, JAX grads, port value, port grads) of a scalar function
    of the arrays, differentiated with respect to every one of them."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts)
    return jv, jg, tv.detach(), tg


def _check(jv, jg, tv, tg, names, unused=()):
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    for name, a, b in zip(names, tg, jg):
        if name in unused:
            assert a is None and not np.asarray(b).any(), name
            continue
        assert float(np.abs(np.asarray(b)).max()) > 0, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


def test_ssim_and_psnr(rng):
    a = rng.uniform(size=(3, H, W)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    _check(*_value_and_grads(jimage.ssim, timage.ssim, a, b), ["img1", "img2"])
    _check(*_value_and_grads(jimage.psnr, timage.psnr, a, b), ["a", "b"])


def test_depth_loss(rng):
    pred = rng.uniform(0.1, 2.0, size=(H, W)).astype(np.float32)
    target = (0.7 * pred + 0.2 + rng.normal(size=(H, W)) * 0.05
              ).astype(np.float32)
    _check(*_value_and_grads(jdepth.depth_loss, tdepth.depth_loss, pred,
                             target), ["prediction", "target"])


def test_flow_loss(rng):
    a = _batch_arrays(rng)["flow"]
    img_flow = (rng.normal(size=(3, H, W)) * 0.5).astype(np.float32)
    img_opacity = rng.uniform(size=(H, W)).astype(np.float32)
    a["vis"] = (rng.random((H, W)) < 0.8).astype(np.float32)
    jpkg = jflow.FlowPackage(**{k: jnp.asarray(v) for k, v in a.items()})
    tpkg = convert.flow_from_numpy(a, device="cpu")
    _check(*_value_and_grads(
        lambda f, o: jflow.flow_loss(f, jpkg, o, dist=0.01),
        lambda f, o: tflow.flow_loss(f, tpkg, o, dist=0.01),
        img_flow, img_opacity), ["img_flow", "img_opacity"])


def _model(rng):
    """Tiny JAX model with spread KNN targets and groups, and its port."""
    params, state, cfg, _ = tiny_model(rng, n=60, quantum=32)
    params = dataclasses.replace(
        params,
        gs_time_sigma=jnp.asarray(rng.normal(
            size=params.gs_time_sigma.shape).astype(np.float32) * 0.3 - 3.0),
        xyz_deform=jnp.asarray(rng.normal(
            size=params.xyz_deform.shape).astype(np.float32) * 0.05))
    no = int(state.num_obj)
    pts = np.asarray(params.obj_xyz[:no])
    idx = knn.knn_indices(pts[::3][:6], pts, k=4)
    state = dataclasses.replace(
        state, obj_near_idx=jnp.asarray(idx),
        obj_near_valid=jnp.asarray(np.arange(idx.shape[0]) < 5))

    def leaves(obj):
        return {f.name: np.array(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}

    return (cfg, params, state,
            convert.params_from_numpy(leaves(params), device="cpu"),
            convert.state_from_numpy(leaves(state), device="cpu"))


REG_LEAVES = ("xyz_deform", "gs_time_sigma")


@pytest.mark.parametrize("which", ["pair", "reg_only", "sigma_reg_only"])
def test_gaussian_term_losses(rng, which):
    fields = {"pair": {}, "reg_only": dict(lambda_sigma_reg=0.0),
              "sigma_reg_only": dict(lambda_reg=0.0)}[which]
    opt = JOpt(**fields)
    topt = convert.opt_config_from_dict(dataclasses.asdict(opt))
    cfg, jp, js, tp, ts = _model(rng)

    def jfn(xd, sg):
        p = dataclasses.replace(jp, xyz_deform=xd, gs_time_sigma=sg)
        return jlosses.gaussian_term_losses(p, js, opt, 0.05)

    def tfn(xd, sg):
        p = dataclasses.replace(tp, xyz_deform=xd, gs_time_sigma=sg)
        return tlosses.gaussian_term_losses(p, ts, topt, 0.05)

    (jv, jlogs), jg = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jp.xyz_deform, jp.gs_time_sigma)
    args = [getattr(tp, k).clone().requires_grad_(True) for k in REG_LEAVES]
    tv, tlogs = tfn(*args)
    tg = torch.autograd.grad(tv, args, allow_unused=True)
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert float(jlogs[k]) > 0, k
        np.testing.assert_allclose(float(tlogs[k].detach()), float(jlogs[k]),
                                   err_msg=k, **TOL)
    unused = ("xyz_deform",) if which == "sigma_reg_only" else ()
    _check(jv, jg, tv.detach(), tg, REG_LEAVES, unused)


def test_compute_losses_every_term(rng):
    cfg, jp, js, tp, ts = _model(rng)
    arrays = _batch_arrays(rng)
    jbatch = _jax_batch(arrays)
    tbatch = convert.batch_from_numpy(arrays, device="cpu")
    opt = JOpt()
    topt = convert.opt_config_from_dict(dataclasses.asdict(opt))
    images = [rng.uniform(size=(3, H, W)).astype(np.float32),       # render
              rng.uniform(0.1, 1.0, size=(H, W)).astype(np.float32),  # depth
              (rng.normal(size=(3, H, W)) * 0.5).astype(np.float32),  # flow
              rng.uniform(size=(H, W)).astype(np.float32),          # opacity
              rng.uniform(size=(1, H, W)).astype(np.float32)]       # semantic
    keys = ["render", "depth", "img_flow", "img_opacity", "img_semantic"]

    def jfn(*a):
        pkg = dict(zip(keys, a[:5]))
        p = dataclasses.replace(jp, xyz_deform=a[5], gs_time_sigma=a[6])
        return jlosses.compute_losses(pkg, jbatch, p, js, cfg, opt, 0.05,
                                      10.0)

    def tfn(*a):
        pkg = dict(zip(keys, a[:5]))
        p = dataclasses.replace(tp, xyz_deform=a[5], gs_time_sigma=a[6])
        return tlosses.compute_losses(pkg, tbatch, p, ts, None, topt, 0.05,
                                      10.0)

    inputs = images + [np.array(jp.xyz_deform), np.array(jp.gs_time_sigma)]
    (jv, jlogs), jg = jax.value_and_grad(
        jfn, argnums=tuple(range(7)), has_aux=True)(
        *(jnp.asarray(a) for a in inputs))
    ts_in = [torch.as_tensor(a).requires_grad_(True) for a in inputs]
    tv, tlogs = tfn(*ts_in)
    tg = torch.autograd.grad(tv, ts_in)
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert float(jlogs[k]) != 0.0, k
        np.testing.assert_allclose(float(tlogs[k].detach()), float(jlogs[k]),
                                   err_msg=k, **TOL)
    _check(jv, jg, tv.detach(), tg, keys + list(REG_LEAVES))
