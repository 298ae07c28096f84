"""The training step: render -> losses -> gradients -> Adam -> densification
statistics (counterpart of adgs_tpu/train/step.py).

One call is one iteration of the reference loop minus the host-side
concerns (camera sampling, densify scheduling, logging), which belong to
the trainer. The JAX step runs preprocess twice (a binning program and a
gradient program) only to keep its two compiles bounded; run eagerly, one
preprocess feeds both the binning (under torch.no_grad()) and the
gradient pass, with the same values.

Densification statistics: the reference reads screenspace_points.grad;
here a zero `screen_offset` [N, 2] is differentiated alongside the
parameters and its gradient norm accumulates into GaussianState.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .._stages import mark
from ..core.camera import Camera
from ..models.env_map import EnvironmentMap
from ..models.gaussians import GaussianConfig, GaussianParams, GaussianState
from ..profiling import span
from ..render import render
from .config import OptimizationConfig
from .losses import FrameBatch, compute_losses
from .optim import TrainableState, adam_update, from_leaves, leaves, lr_tree


class LossAndGrads(NamedTuple):
    logs: dict                   # {term: 0-d tensor}, total_loss among them
    grads: TrainableState        # dL/d every trainable leaf
    screen_grad: torch.Tensor    # [N, 2] dL/dmean2d
    radii: torch.Tensor          # [N] int32
    visibility: torch.Tensor     # [N] bool
    num_rendered: torch.Tensor   # 0-d int32


def make_train_step(config: GaussianConfig, opt: OptimizationConfig,
                    frame_gap: float, scene_extent: float,
                    cameras_extent: float, capacity: int = 1 << 18,
                    inv_depth: bool = True, layout: str = "gather"):
    """Returns step(params, env, opt_state, state, camera, batch, cam_rays,
    iteration, active_sh_degree=3, stage_marks=None) -> (params, env,
    opt_state, state, logs). The step also carries `loss_and_grads`, its
    differentiable half (the JAX step's loss_fn under value_and_grad).

    layout: the compositor's instance layout, "gather" or "rows" (the JAX
    package's ADGS_RM=0/1); both give the same gradients bit for bit.
    stage_marks: a list to receive CUDA-event marks (adgs_tpu_torch._stages):
    render()'s "start" .. "sky", then "losses", "backward", "adam", "stats".
    """
    render_objmask = opt.lambda_obj > 0.0

    def loss_and_grads(params: GaussianParams, env: EnvironmentMap,
                       state: GaussianState, camera: Camera,
                       batch: FrameBatch, cam_rays: torch.Tensor,
                       active_sh_degree: int = 3,
                       stage_marks: Optional[list] = None) -> LossAndGrads:
        dev = params.scene_xyz.device
        trainables = TrainableState(gaussians=params, env=env)
        inputs = [x.detach().requires_grad_(True) for x in leaves(trainables)]
        tr = from_leaves(trainables, inputs)
        so = torch.zeros((params.capacity, 2), dtype=torch.float32,
                         device=dev, requires_grad=True)
        flow_time = batch.flow.time if batch.flow is not None else None
        pkg = render(camera, tr.gaussians, state, config, env_map=tr.env,
                     cam_rays=cam_rays, flow_time=flow_time,
                     render_objmask=render_objmask, screen_offset=so,
                     active_sh_degree=active_sh_degree, inv_depth=inv_depth,
                     capacity=capacity, stage_marks=stage_marks,
                     layout=layout)
        with span("step.losses"):
            total, logs = compute_losses(pkg, batch, tr.gaussians, state,
                                         config, opt, frame_gap, scene_extent)
        mark(stage_marks, "losses")
        with span("step.backward"):
            # into each leaf's .grad, in the leaf's own (contiguous) layout,
            # as Adam's kernel takes it: the engine copies a strided
            # gradient (the SH leaves' views of their concatenation's
            # gradient, screen_offset's view of the packed rows' gradient)
            # inside the backward, so no view outlives it holding its base.
            # autograd.grad returned the views, and the engine released
            # its own references to them at no fixed time, now and then
            # only after Adam's allocations (+0.48 GiB at Waymo's peak).
            total.backward(inputs=inputs + [so])
        mark(stage_marks, "backward")
        grads = [torch.zeros_like(x) if x.grad is None else x.grad
                 for x in inputs + [so]]
        return LossAndGrads(
            logs={k: v.detach() for k, v in logs.items()},
            grads=from_leaves(trainables, grads[:-1]), screen_grad=grads[-1],
            radii=pkg["radii"], visibility=pkg["visibility_filter"],
            num_rendered=pkg["num_rendered"])

    @torch.no_grad()
    def update(params, env, opt_state, state, out: LossAndGrads, iteration,
               stage_marks=None):
        with span("step.adam"):
            lrs = lr_tree(opt, scene_extent, cameras_extent, iteration)
            new_tr, new_opt_state = adam_update(
                TrainableState(gaussians=params, env=env), out.grads,
                opt_state, lrs)
        mark(stage_marks, "adam")
        with span("step.stats"):
            vis = out.visibility
            visf = vis.to(torch.float32)
            snorm = torch.linalg.vector_norm(out.screen_grad, dim=-1)
            new_state = dataclasses.replace(
                state,
                max_radii2d=torch.maximum(
                    state.max_radii2d,
                    torch.where(vis, out.radii.to(torch.float32),
                                torch.zeros_like(visf))),
                xyz_grad_accum=state.xyz_grad_accum + snorm * visf,
                denom=state.denom + visf)
        mark(stage_marks, "stats")
        return new_tr.gaussians, new_tr.env, new_opt_state, new_state

    def step(params, env, opt_state, state, camera, batch, cam_rays,
             iteration, active_sh_degree: int = 3,
             stage_marks: Optional[list] = None):
        out = loss_and_grads(params, env, state, camera, batch, cam_rays,
                             active_sh_degree, stage_marks)
        params, env, opt_state, state = update(
            params, env, opt_state, state, out, iteration, stage_marks)
        # surfaced for the trainer's instance-capacity sizing
        logs = dict(out.logs, num_rendered=out.num_rendered)
        return params, env, opt_state, state, logs

    step.loss_and_grads = loss_and_grads
    return step
