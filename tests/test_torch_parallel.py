"""The port's tile-sharded path (adgs_tpu_torch.parallel.shard) in two
gloo CPU ranks against the JAX package's single-device render and step
(tests/test_parallel.py's cases and bars, the JAX side run here, the
port's in the ranks of one spawn):
  - the sharded render, exchange off and on, and with capacities that
    D = 2 does not divide: render, depth and opacity at 1e-4, radii equal;
    a too small exchange capacity raises the overflow flag;
  - the sharded step, slab and gathered loss modes, exchange off and on,
    on tests/test_torch_train.py's scene (every loss term on, KNN groups
    set): the loss logs at rtol 1e-4 against JAX and slab against
    gathered at rtol 2e-5, atol 1e-7; the all-reduced gradients against
    the port's single-device step at test_parallel.py's 5e-3 / 1e-6 (a
    gradient D times too large fails here) and against JAX at
    tests/test_torch_train.py's bars; the updated scene_xyz at rtol 1e-3,
    atol 1e-7 and denom exactly; both ranks' updates bitwise equal;
  - the halo SSIM against the full-image SSIM, value and gradient;
  - sharded_adam_update bitwise adam_update.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu import render as jrender
from adgs_tpu_torch import convert
from adgs_tpu_torch.ops.image import ssim_map
from adgs_tpu_torch.parallel.launch import call_ranks
from tests import scene_fixtures as fx
from tests.test_models_ops import tiny_model
from tests.test_torch_ranks import RANK_ENV
from tests.test_torch_train import (H, ITERATION, STEP_KW, TINY_ORDER, W,
                                    _jax_step, _port_step, _setup)

D = 2
RENDER_HW = (64, 80)
GRAD_BARS = dict(rtol=5e-3, atol=2e-5)        # test_torch_train.py's
SHARD_GRAD_BARS = dict(rtol=5e-3, atol=1e-6)  # test_parallel.py's
STEP_CASES = [dict(loss_mode=m, exchange=e)
              for m in ("slab", "gathered") for e in (False, True)]


def _leaves(obj):
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _cam(width, height, time):
    return dict(R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=1.1,
                fovy=0.9, width=width, height=height, time=time)


def _model(params, state, **extra):
    return dict(order=TINY_ORDER, frame_num=20, sh_degree=2,
                params=_leaves(params), state=_leaves(state), **extra)


def _batch_numpy(b):
    return dict(image=b.image.numpy(), depth=b.depth.numpy(),
                sky=b.sky.numpy(), semantic=b.semantic.numpy(),
                flow=None if b.flow is None else convert.to_numpy(b.flow),
                flow_valid=None if b.flow_valid is None
                else bool(b.flow_valid))


def _odd_model(params, state):
    """The model with its last (dead) scene slot dropped: 127 scene slots,
    which D = 2 does not divide."""
    ns = params.scene_capacity

    def cut(x):
        x = np.asarray(x)
        if x.shape and x.shape[0] == ns:
            return x[:-1]
        if x.shape and x.shape[0] == params.capacity:
            return np.delete(x, ns - 1, axis=0)
        return x
    p = dataclasses.replace(params, **{k: jnp.asarray(cut(v)) for k, v in
                                       _leaves(params).items()})
    s = dataclasses.replace(state, **{k: jnp.asarray(cut(v)) for k, v in
                                      _leaves(state).items()})
    assert p.scene_capacity % D and not np.asarray(state.scene_alive)[-1]
    return p, s


@pytest.fixture(scope="module")
def runs():
    """The JAX references, the port's single-device step, and one spawn of
    two ranks running every port case."""
    rng = np.random.default_rng(0)
    params, state, cfg, _ = tiny_model(rng, n=150, quantum=128)
    w, h = RENDER_HW
    jcam = fx.make_camera(width=w, height=h, time=0.3)
    odd_p, odd_s = _odd_model(params, state)
    render_ref = [jrender.render(jcam, p, s, cfg, capacity=1 << 14,
                                 max_per_tile=256)
                  for p, s in ((params, state), (odd_p, odd_s))]
    rmodel = _model(params, state, cams=[_cam(w, h, 0.3)])
    odd = _model(odd_p, odd_s, cams=[_cam(w, h, 0.3)])

    jax_side, port = _setup(np.random.default_rng(0))
    jout = _jax_step(jax_side)
    single = _port_step(port)
    smodel = _model(
        jax_side["params"], jax_side["state"],
        env=np.asarray(jax_side["env"].grid), cams=[_cam(W, H, 0.3)],
        rays=[port["rays"].numpy()],
        batches=[_batch_numpy(port["batch"])],
        opt=dataclasses.asdict(jax_side["opt"]), active_sh_degree=0)

    img_rng = np.random.default_rng(1)
    image = img_rng.uniform(size=(3, 48, 40)).astype(np.float32)
    gt = img_rng.uniform(size=(3, 48, 40)).astype(np.float32)
    jobs = [
        ("render_ranks", dict(model=rmodel, shape={"tile": D}, capacity=1 << 13,
                              cases=[dict(exchange=False),
                                     dict(exchange=True),
                                     dict(exchange=True, exchange_capacity=8),
                                     dict(exchange=False, model=odd)])),
        ("step_ranks", dict(model=smodel, shape={"tile": D},
                            cases=STEP_CASES, capacity=1 << 13,
                            kw=STEP_KW, iteration=ITERATION)),
        ("ssim_ranks", dict(shape={"tile": D}, image=image, gt=gt)),
        ("adam_ranks", dict(model=smodel, shape={"tile": D}, seed=5)),
    ]
    ranks = call_ranks("tests.test_torch_ranks:jobs_ranks", D,
                       dict(world_shape={"tile": D}, jobs=jobs), timeout=240,
                       env=RANK_ENV)
    return dict(render_ref=render_ref, jout=jout, single=single, port=port,
                ranks=ranks, image=image, gt=gt)


@pytest.mark.parametrize("case", ["gather", "exchange", "indivisible"])
def test_sharded_render_matches_single_device(runs, case):
    i, ref = {"gather": (0, 0), "exchange": (1, 0),
              "indivisible": (3, 1)}[case]
    want = runs["render_ref"][ref]
    for r in range(D):
        got = runs["ranks"][r][0][i]
        for k in ("render", "depth", "img_opacity"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        np.testing.assert_array_equal(got["radii"], np.asarray(want["radii"]))
        assert not got["exchange_overflow"]


def test_exchange_overflow_flag(runs):
    """An exchange capacity of 8 rows per pair drops rows: every rank
    raises the flag (and without it, neither does)."""
    for r in range(D):
        assert bool(runs["ranks"][r][0][2]["exchange_overflow"])
        assert not bool(runs["ranks"][r][0][1]["exchange_overflow"])


def _flat(tree):
    """{leaf name: array} of a TrainableState's numpy form."""
    return dict(tree["gaussians"], env=tree["env"])


@pytest.mark.parametrize("ci", range(len(STEP_CASES)),
                         ids=[f"{c['loss_mode']}-"
                              f"{'exchange' if c['exchange'] else 'gather'}"
                              for c in STEP_CASES])
def test_sharded_step_matches_single_device(runs, ci):
    jout, (lg, pout) = runs["jout"], runs["single"]
    got = runs["ranks"][0][1][ci]
    # logs against JAX (num_rendered is the largest slab's here); the slab
    # path adds the step's splat instances, every slab's
    extra = {"exchange_overflow"} | (
        {"splat_instances"} if STEP_CASES[ci]["loss_mode"] == "slab"
        else set())
    assert set(got["logs"]) == set(jout[4]) | extra
    if "splat_instances" in got["logs"]:
        assert int(got["logs"]["num_rendered"]) <= \
            int(got["logs"]["splat_instances"]) <= \
            D * int(got["logs"]["num_rendered"])
    for k, v in jout[4].items():
        if k == "num_rendered":
            continue
        np.testing.assert_allclose(float(got["logs"][k]), float(v),
                                   rtol=1e-4, err_msg=k)
    # the all-reduced gradients: against the port's single-device step at
    # test_parallel.py's bars, against JAX at test_torch_train.py's
    single = dict(convert.to_numpy(lg.grads.gaussians),
                  env=lg.grads.env.grid.numpy())
    jm = jout[2].m
    jg = dict(_leaves(jm.gaussians), env=np.asarray(jm.env.grid))
    nonzero = 0
    for name, g in _flat(got["grads"]).items():
        np.testing.assert_allclose(g, single[name], err_msg=name,
                                   **SHARD_GRAD_BARS)
        np.testing.assert_allclose(g, jg[name] / np.float32(0.1),
                                   err_msg=name, **GRAD_BARS)
        nonzero += int(np.abs(g).max() > 0)
    assert nonzero >= 15
    np.testing.assert_allclose(got["params"]["gaussians"]["scene_xyz"],
                               np.asarray(jout[0].scene_xyz),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_array_equal(got["state"]["denom"],
                                  np.asarray(jout[3].denom))
    np.testing.assert_array_equal(got["state"]["max_radii2d"],
                                  pout[3].max_radii2d.numpy())
    np.testing.assert_allclose(got["state"]["xyz_grad_accum"],
                               pout[3].xyz_grad_accum.numpy(),
                               **SHARD_GRAD_BARS)
    # both ranks hold the same update, bit for bit
    other = runs["ranks"][1][1][ci]
    for part in ("params", "m", "v", "state"):
        a, b = got[part], other[part]
        if part != "state":
            a, b = _flat(a), _flat(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{part}.{k}")


@pytest.mark.parametrize("exchange", [False, True])
def test_slab_losses_match_gathered(runs, exchange):
    """Slab-local losses (halo SSIM, psum'd statistics) against the
    gathered full-frame loss stack: every term at rtol 2e-5, atol 1e-7,
    the updated scene_xyz and denom."""
    cases = runs["ranks"][0][1]
    slab = cases[STEP_CASES.index(dict(loss_mode="slab", exchange=exchange))]
    gath = cases[STEP_CASES.index(dict(loss_mode="gathered",
                                       exchange=exchange))]
    for k in ("total_loss", "l1_loss", "dssim_loss", "depth_loss",
              "flow_loss", "obj_loss", "sky_loss"):
        np.testing.assert_allclose(float(slab["logs"][k]),
                                   float(gath["logs"][k]), rtol=2e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(slab["params"]["gaussians"]["scene_xyz"],
                               gath["params"]["gaussians"]["scene_xyz"],
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_array_equal(slab["state"]["denom"],
                                  gath["state"]["denom"])


def test_halo_ssim_matches_full_image(runs):
    img = torch.as_tensor(runs["image"]).requires_grad_(True)
    total = torch.sum(ssim_map(img, torch.as_tensor(runs["gt"]))[0])
    grad = torch.autograd.grad(total, img)[0].numpy()
    rows = img.shape[1] // D
    for r in range(D):
        value, g = runs["ranks"][r][2]
        np.testing.assert_allclose(value, float(total.detach()), rtol=1e-5)
        np.testing.assert_allclose(g, grad[:, r * rows:(r + 1) * rows],
                                   rtol=1e-4, atol=1e-6)


def test_sharded_adam_update_bitwise(runs):
    for r in range(D):
        sharded, plain = runs["ranks"][r][3]
        assert sharded[3] == plain[3] == 4
        for a, b in zip(sharded[:3], plain[:3]):
            a, b = _flat(a), _flat(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
