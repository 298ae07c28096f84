"""Rank bodies of the port's multi-device tests, and the collectives' own
tests.

The functions without a test_ prefix run inside gloo CPU ranks started by
adgs_tpu_torch.parallel.launch.call_ranks (tests/test_torch_parallel.py,
tests/test_torch_data_parallel.py): they rebuild the model from numpy
arrays, run the port's sharded render and steps and return numpy results
for the parent to hold to the JAX package. This module imports neither
jax nor adgs_tpu, so the ranks do not either.

The tests here hold the differentiable collectives to plain autograd of
the same function on one process (D = 2 and 4 ranks, one spawn each).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from adgs_tpu_torch import convert
from adgs_tpu_torch.core.camera import Camera
from adgs_tpu_torch.models import gaussians as tgm
from adgs_tpu_torch.ops.image import ssim_map
from adgs_tpu_torch.parallel import collectives as cc
from adgs_tpu_torch.parallel.launch import call_ranks
from adgs_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
from adgs_tpu_torch.train import optim as topt

RANK_ENV = {"OMP_NUM_THREADS": "1"}


def join(shape: dict):
    """Join the launcher's gloo group (once) and build a CPU mesh."""
    torch.set_num_threads(1)
    initialize_multihost("gloo")
    return make_mesh(shape, device="cpu")


def port_model(m: dict):
    """(config, params, state, env, cameras, rays, batches, opt) from the
    numpy description the parent sends (any of the last five may be
    absent: None / [])."""
    cfg = tgm.GaussianConfig.from_order_args(
        m["order"], frame_num=m["frame_num"], sh_degree=m["sh_degree"])
    params = convert.params_from_numpy(m["params"], device="cpu")
    state = convert.state_from_numpy(m["state"], device="cpu")
    env = (convert.env_from_numpy(m["env"], device="cpu")
           if m.get("env") is not None else None)
    cams = [Camera.create(device="cpu", **c) for c in m.get("cams", [])]
    rays = [torch.as_tensor(r) for r in m.get("rays", [])]
    batches = [convert.batch_from_numpy(b, device="cpu")
               for b in m.get("batches", [])]
    opt = (convert.opt_config_from_dict(m["opt"]) if m.get("opt") else None)
    return cfg, params, state, env, cams, rays, batches, opt


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: _np(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, topt.TrainableState):
        return {"gaussians": _np(x.gaussians), "env": _np(x.env.grid)}
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def render_ranks(model: dict, shape: dict, cases: list, capacity: int):
    """sharded_render_images per case: {"exchange": bool, "model":
    optional other model}; returns its render, depth, opacity and radii."""
    from adgs_tpu_torch.parallel.shard import sharded_render_images
    mesh = join(shape)
    out = []
    for case in cases:
        cfg, params, state, _, cams, _, _, _ = port_model(
            case.get("model") or model)
        with torch.no_grad():
            r = sharded_render_images(
                params, state, cfg, cams[0], mesh, capacity=capacity,
                primitive_exchange=case["exchange"],
                exchange_capacity=case.get("exchange_capacity"))
        out.append({k: _np(r[k]) for k in
                    ("render", "depth", "img_opacity", "radii",
                     "exchange_overflow", "num_rendered")})
    return out


def step_ranks(model: dict, shape: dict, cases: list, capacity: int,
               kw: dict, iteration: float, data_axis=None):
    """One sharded step per case ({"loss_mode", "exchange"}): the
    all-reduced gradients before Adam, the updated parameters and
    moments, the statistics and the logs."""
    from adgs_tpu_torch.parallel.data_parallel import (stack_batches,
                                                       stack_cameras)
    from adgs_tpu_torch.parallel.shard import make_sharded_train_step
    mesh = join(shape)
    cfg, params, state, env, cams, rays, batches, opt = port_model(model)
    if data_axis is not None:
        cam, batch, ray = (stack_cameras(cams), stack_batches(batches),
                           torch.stack(rays))
    else:
        cam, batch, ray = cams[0], batches[0], rays[0]
    opt_state = topt.init_adam(topt.TrainableState(params, env))
    out = []
    for case in cases:
        step = make_sharded_train_step(
            cfg, opt, mesh=mesh, capacity=capacity,
            loss_mode=case["loss_mode"],
            primitive_exchange=case["exchange"], data_axis=data_axis, **kw)
        lg = step.loss_and_grads(params, env, state, cam, batch, ray,
                                 active_sh_degree=model["active_sh_degree"])
        p, e, o, s, logs = step(params, env, opt_state, state, cam, batch,
                                ray, iteration,
                                active_sh_degree=model["active_sh_degree"])
        out.append(dict(grads=_np(lg.grads), logs=_np(logs),
                        params=_np(topt.TrainableState(p, e)),
                        m=_np(o.m), v=_np(o.v), state=_np(s)))
    return out


def adam_ranks(model: dict, shape: dict, seed: int):
    """sharded_adam_update and adam_update on the same random gradients
    and moments: (sharded, plain) updated leaves."""
    from adgs_tpu_torch.parallel.shard import sharded_adam_update
    mesh = join(shape)
    _, params, _, env, _, _, _, opt = port_model(model)
    tr = topt.TrainableState(params, env)
    gen = torch.Generator().manual_seed(seed)

    def rand_like(t):
        return topt.from_leaves(t, [torch.randn(x.shape, generator=gen)
                                    for x in topt.leaves(t)])

    grads = rand_like(tr)
    st = topt.AdamState(m=rand_like(tr),
                        v=topt.from_leaves(tr, [x * x for x in topt.leaves(
                            rand_like(tr))]),
                        count=torch.tensor(3, dtype=torch.int32))
    lrs = topt.lr_tree(opt, 10.0, 10.0, 700)
    outs = [sharded_adam_update(tr, grads, st, lrs, mesh),
            topt.adam_update(tr, grads, st, lrs)]
    return [[_np(t), _np(s.m), _np(s.v), int(s.count)] for t, s in outs]


def collective_ranks(shape: dict, seed: int):
    """The differentiable collectives on each rank's block of one global
    input, and the gradients of a loss that every rank computes."""
    mesh = join(shape)
    group = mesh.group("tile")
    D, d = mesh.shape["tile"], mesh.coords["tile"]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((D, 6, 3), generator=gen)
    w = torch.randn((D * 6, 3), generator=gen)
    mine = x[d].clone().requires_grad_(True)
    out = {}
    # all_gather, then a loss every rank computes (seeded 1 / D)
    g = cc.all_gather(mine, group).reshape(-1, 3)
    loss = torch.sum(torch.sin(g) * w)
    out["all_gather"] = torch.autograd.grad(loss / D, mine)[0].numpy()
    # psum feeding a second, rank-local round of sums (the depth
    # alignment's pattern), then psum'd again
    s = cc.psum(torch.sum(mine * mine, dim=0), group)
    r = cc.psum(torch.sum(torch.abs(mine * s - w[d * 6:(d + 1) * 6])), group)
    loss = r * torch.sum(s)
    out["psum"] = torch.autograd.grad(loss / D, mine)[0].numpy()
    # all_to_all: block e goes to rank e
    a = cc.all_to_all(torch.cat([mine] * D), group)
    loss = cc.psum(torch.sum(torch.cos(a) * w[:a.shape[0]]), group)
    out["all_to_all"] = torch.autograd.grad(loss / D, mine)[0].numpy()
    # the halo: two rows from each neighbour
    h = cc.halo_rows(mine, 2, group, row_axis=0)
    loss = cc.psum(torch.sum(h[1:-1] * w[:h.shape[0] - 2]), group)
    out["halo"] = torch.autograd.grad(loss / D, mine)[0].numpy()
    out["halo_value"] = h.detach().numpy()
    return out


def ssim_ranks(shape: dict, image: np.ndarray, gt: np.ndarray):
    """sum of the SSIM map by halo exchange on each rank's rows, and its
    gradient with respect to this rank's rows of `image`."""
    from adgs_tpu_torch.parallel.shard import _SSIM_HALO
    mesh = join(shape)
    group = mesh.group("tile")
    D, d = mesh.shape["tile"], mesh.coords["tile"]
    rows = image.shape[1] // D
    sl = slice(d * rows, (d + 1) * rows)
    img = torch.as_tensor(image[:, sl]).requires_grad_(True)
    both = cc.halo_rows(torch.cat([img, torch.as_tensor(gt[:, sl])]),
                        _SSIM_HALO, group, row_axis=1)
    smap = ssim_map(both[:3], both[3:])[0][:, _SSIM_HALO:-_SSIM_HALO]
    total = cc.psum(torch.sum(smap), group)
    grad = torch.autograd.grad(total / D, img)[0]
    return float(total), grad.numpy()


def _plain_collectives(D: int, seed: int) -> dict:
    """collective_ranks' function on one process."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((D, 6, 3), generator=gen).requires_grad_(True)
    w = torch.randn((D * 6, 3), generator=gen)
    out = {}
    loss = torch.sum(torch.sin(x.reshape(-1, 3)) * w)
    out["all_gather"] = torch.autograd.grad(loss, x)[0].numpy()
    s = torch.sum(x * x, dim=(0, 1))
    r = sum(torch.sum(torch.abs(x[d] * s - w[d * 6:(d + 1) * 6]))
            for d in range(D))
    out["psum"] = torch.autograd.grad(r * torch.sum(s), x)[0].numpy()
    loss = sum(torch.sum(torch.cos(torch.cat([x[e]] * D)[d * 6:(d + 1) * 6])
                         * w[e * 6:(e + 1) * 6])
               for d in range(D) for e in range(D))
    out["all_to_all"] = torch.autograd.grad(loss, x)[0].numpy()
    halos, loss = [], 0.0
    for d in range(D):
        prev = x[d - 1][-2:] if d > 0 else torch.zeros(2, 3)
        nxt = x[d + 1][:2] if d + 1 < D else torch.zeros(2, 3)
        h = torch.cat([prev, x[d], nxt])
        halos.append(h.detach().numpy())
        loss = loss + torch.sum(h[1:-1] * w[:h.shape[0] - 2])
    out["halo"] = torch.autograd.grad(loss, x)[0].numpy()
    out["halo_value"] = halos
    return out


@pytest.mark.parametrize("D", [2, 4])
def test_collectives_transposes(D):
    """Each collective's backward is the transpose JAX derives: gradients
    of the spread function equal plain autograd of the same function on
    one process, per rank's block (all_gather's reduce-scatter, psum's
    all-reduce with a replicated loss seeded 1 / D, the depth alignment's
    two rounds of sums, all_to_all, the halo's reverse permute)."""
    got = call_ranks("tests.test_torch_ranks:collective_ranks", D,
                     dict(shape={"tile": D}, seed=D), timeout=120,
                     env=RANK_ENV)
    want = _plain_collectives(D, D)
    for name in ("all_gather", "psum", "all_to_all", "halo"):
        for d in range(D):
            np.testing.assert_allclose(got[d][name], want[name][d],
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}, rank {d}")
    for d in range(D):
        np.testing.assert_array_equal(got[d]["halo_value"],
                                      want["halo_value"][d])


def jobs_ranks(world_shape: dict, jobs: list):
    """Several rank bodies in one spawn: [(function name, kwargs), ...] ->
    their results in order."""
    del world_shape   # each job builds its own mesh over the same ranks
    return [globals()[name](**kw) for name, kw in jobs]


def dp_ranks(model: dict, shape: dict, capacity: int, kw: dict,
             iteration: float):
    """One data-parallel step (parallel/data_parallel.py), a camera a
    rank: its logs, updated parameters and statistics."""
    from adgs_tpu_torch.parallel.data_parallel import (make_dp_train_step,
                                                       stack_batches,
                                                       stack_cameras)
    mesh = join(shape)
    cfg, params, state, env, cams, rays, batches, opt = port_model(model)
    step = make_dp_train_step(cfg, opt, mesh=mesh, capacity=capacity, **kw)
    p, e, o, s, logs = step(
        params, env, topt.init_adam(topt.TrainableState(params, env)), state,
        stack_cameras(cams), stack_batches(batches), torch.stack(rays),
        iteration, active_sh_degree=model["active_sh_degree"])
    return dict(logs=_np(logs), params=_np(topt.TrainableState(p, e)),
                state=_np(s))
