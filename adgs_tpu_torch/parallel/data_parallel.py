"""Data-parallel multi-camera training: a batch of frames per step, one
camera per rank of the mesh's "data" axis (counterpart of
adgs_tpu/parallel/data_parallel.py).

The JAX step vmaps the per-camera render + loss over a stacked camera
batch and lets GSPMD shard it; here each rank renders and differentiates
its own camera on the single-device path (the kernels, unbatched), and the
gradients of the camera-mean loss cross the ranks as one flat all-reduce.
Densification statistics accumulate the whole batch: B cameras per step
behave like B reference iterations of statistics. Combine with
parallel/shard.py (its data_axis) for batch x tile parallelism of large
frames.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.camera import Camera
from ..models.gaussians import GaussianConfig
from ..render import render
from ..train.config import OptimizationConfig
from ..train.losses import FrameBatch, compute_losses
from ..train.optim import (TrainableState, adam_update, from_leaves,
                           leaves, lr_tree)
from . import collectives as cc
from .mesh import Mesh
from .shard import allreduce_flat, select_camera


def _stack(xs):
    if xs[0] is None:
        return None
    if torch.is_tensor(xs[0]):
        return torch.stack(xs)
    return type(xs[0])(*[_stack(list(f)) for f in zip(*xs)])


def stack_cameras(cams: list) -> Camera:
    """Stack the per-frame tensor fields; the static fields must match."""
    first = cams[0]
    fields = dataclasses.fields(first)
    static = [f.name for f in fields
              if not torch.is_tensor(getattr(first, f.name))]
    assert all(getattr(c, n) == getattr(first, n)
               for c in cams for n in static), "static camera fields differ"
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(c, f.name) for c in cams])
        for f in fields if f.name not in static})


def stack_batches(batches: list) -> FrameBatch:
    return _stack(batches)


def make_dp_train_step(config: GaussianConfig, opt: OptimizationConfig,
                       frame_gap: float, scene_extent: float,
                       cameras_extent: float, mesh: Mesh,
                       axis: str = "data", capacity: int = 1 << 18,
                       inv_depth: bool = True, layout: str = "gather"):
    """step(params, env, opt_state, state, cameras[B], batches[B], rays[B],
    iteration, active_sh_degree) with B == mesh.shape[axis] == the number
    of ranks: rank b trains camera b. The loss is the camera mean."""
    if mesh.shape[axis] != mesh.size:
        raise ValueError(f"the {axis!r} axis must span every rank "
                         f"(mesh {mesh.shape})")
    render_objmask = opt.lambda_obj > 0.0
    B = mesh.size
    b = mesh.coords[axis]
    group = mesh.group(axis)

    def step(params, env, opt_state, state, cameras, batches, rays,
             iteration, active_sh_degree: int = 3):
        dev = params.scene_xyz.device
        cam, batch, ray = (select_camera(x, b)
                           for x in (cameras, batches, rays))
        trainables = TrainableState(gaussians=params, env=env)
        inputs = [x.detach().requires_grad_(True) for x in leaves(trainables)]
        tr = from_leaves(trainables, inputs)
        so = torch.zeros((params.capacity, 2), dtype=torch.float32,
                         device=dev, requires_grad=True)
        flow_time = batch.flow.time if batch.flow is not None else None
        pkg = render(cam, tr.gaussians, state, config, env_map=tr.env,
                     cam_rays=ray, flow_time=flow_time,
                     render_objmask=render_objmask, screen_offset=so,
                     active_sh_degree=active_sh_degree, inv_depth=inv_depth,
                     capacity=capacity, layout=layout)
        total, logs = compute_losses(pkg, batch, tr.gaussians, state, config,
                                     opt, frame_gap, scene_extent)
        # the camera mean: each rank differentiates its camera's share
        grads = torch.autograd.grad(total * (1.0 / B), inputs + [so],
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs + [so], grads)]
        so_grad = grads.pop()
        grads = allreduce_flat(grads, group)
        names = sorted(logs)
        means = torch.stack([logs[k].detach() for k in names])
        dist.all_reduce(means, group=group)
        logs = {k: means[i] / B for i, k in enumerate(names)}

        with torch.no_grad():
            lrs = lr_tree(opt, scene_extent, cameras_extent, iteration)
            new_tr, new_opt_state = adam_update(
                trainables, from_leaves(trainables, grads), opt_state, lrs)
            # dL/dso scales with 1/B through the mean; undo it so that the
            # densify thresholds keep their single-camera meaning, then
            # accumulate the batch like B reference iterations
            vis = pkg["visibility_filter"]
            visf = vis.to(torch.float32)
            snorm = torch.linalg.vector_norm(so_grad * B, dim=-1)
            sums = torch.stack([snorm * visf, visf])
            dist.all_reduce(sums, group=group)
            radii_max = cc.pmax(torch.where(vis, pkg["radii"].to(
                torch.float32), torch.zeros_like(visf)), group)
            new_state = dataclasses.replace(
                state,
                max_radii2d=torch.maximum(state.max_radii2d, radii_max),
                xyz_grad_accum=state.xyz_grad_accum + sums[0],
                denom=state.denom + sums[1])
        logs["num_rendered"] = cc.pmax(
            pkg["num_rendered"].reshape(1).to(torch.int32), group)[0]
        return (new_tr.gaussians, new_tr.env, new_opt_state, new_state,
                logs)

    return step
