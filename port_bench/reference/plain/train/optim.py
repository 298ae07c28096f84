"""Per-group Adam with exponential LR schedules on the padded parameter
dataclasses (counterpart of adgs_tpu/train/optim.py).

The reference's 18 Gaussian parameter groups plus the environment map
become one Adam over TrainableState with a learning rate per leaf, so the
moments live in the same padded layout as the parameters and
densification can edit (params, m, v) together. Plain functions, not
torch.optim.Adam: the update is the JAX package's formula, b1=0.9,
b2=0.999, eps=1e-15 added OUTSIDE the sqrt, bias corrections computed in
float32 from the step count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..models.env_map import EnvironmentMap
from ..models.gaussians import GaussianParams
from .config import OptimizationConfig

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def expon_lr(step, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> torch.Tensor:
    """Log-linear decay from lr_init to lr_final over max_steps, with an
    optional sine warm-up; a 0-d float32 CPU tensor (computed in float32
    as the JAX package computes it)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return _f32(0.0)
    step = _f32(step)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(torch.log(_f32(lr_init)) * (1 - t)
                         + torch.log(_f32(lr_final)) * t)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay = 1.0
    return torch.where(step < 0, _f32(0.0), delay * log_lerp)


class TrainableState(NamedTuple):
    """Everything Adam updates together."""

    gaussians: GaussianParams
    env: EnvironmentMap


class AdamState(NamedTuple):
    m: TrainableState
    v: TrainableState
    count: torch.Tensor  # 0-d int32


def leaves(tree: TrainableState) -> list:
    """The leaves in a fixed order: the Gaussian fields, then the grid."""
    return ([getattr(tree.gaussians, f.name)
             for f in dataclasses.fields(tree.gaussians)]
            + [tree.env.grid])


def from_leaves(like: TrainableState, values) -> TrainableState:
    """A TrainableState of `like`'s structure holding `values`
    (leaves() order)."""
    names = [f.name for f in dataclasses.fields(like.gaussians)]
    values = list(values)
    return TrainableState(
        gaussians=dataclasses.replace(like.gaussians,
                                      **dict(zip(names, values))),
        env=EnvironmentMap(grid=values[len(names)]))


def init_adam(trainables: TrainableState) -> AdamState:
    def zeros():
        return from_leaves(trainables,
                           [torch.zeros_like(x) for x in leaves(trainables)])

    return AdamState(m=zeros(), v=zeros(),
                     count=torch.zeros((), dtype=torch.int32))


def lr_tree(opt: OptimizationConfig, scene_extent: float,
            cameras_extent: float, step) -> TrainableState:
    """Per-leaf learning rates: the group table of the reference's
    training_setup. Scheduled groups: scene_xyz and background_deform
    (cameras extent), obj_xyz (object extent), xyz_deform (scene
    extent)."""
    obj_extent = opt.object_extent
    cam_ext = max(cameras_extent, opt.min_camera_extent)

    def sched(scale):
        return expon_lr(step,
                        opt.position_lr_init * scale,
                        opt.position_lr_final * scale,
                        lr_delay_mult=opt.position_lr_delay_mult,
                        max_steps=opt.position_lr_max_steps)

    scene_xyz_lr = sched(cam_ext * opt.scene_position_lr_scale)
    obj_xyz_lr = sched(obj_extent * opt.obj_position_lr_scale)
    deform_xyz_lr = sched(scene_extent * opt.position_deform_lr_scale)

    f = _f32
    g = GaussianParams(
        scene_xyz=scene_xyz_lr,
        scene_shs_dc=f(opt.feature_lr),
        scene_shs_rest=f(opt.feature_lr / 20.0),
        scene_scaling=f(opt.scaling_lr),
        scene_rotation=f(opt.rotation_lr),
        scene_opacity=f(opt.opacity_lr),
        scene_shs_deform=f(opt.shs_deform_lr),
        obj_xyz=obj_xyz_lr,
        obj_shs_dc=f(opt.feature_lr),
        obj_shs_rest=f(opt.feature_lr / 20.0),
        obj_scaling=f(opt.scaling_lr),
        obj_rotation=f(opt.rotation_lr),
        obj_opacity=f(opt.opacity_lr),
        obj_shs_deform=f(opt.shs_deform_lr),
        xyz_deform=deform_xyz_lr,
        rotation_deform=f(opt.rotation_deform_lr),
        gs_time_sigma=f(opt.gs_time_sigma_lr),
        background_deform=scene_xyz_lr,
    )
    return TrainableState(gaussians=g, env=EnvironmentMap(grid=f(opt.env_lr)))


def adam_update(trainables: TrainableState, grads: TrainableState,
                opt_state: AdamState, lrs: TrainableState
                ) -> tuple[TrainableState, AdamState]:
    """One Adam step of every leaf with its own learning rate. The learning
    rates and bias corrections are 0-d float32 CPU tensors, which PyTorch
    applies to CUDA tensors as scalars (no transfer, no wait)."""
    count = opt_state.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(ADAM_B1), c)
    bc2 = 1.0 - torch.pow(_f32(ADAM_B2), c)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(leaves(trainables), leaves(grads),
                              leaves(opt_state.m), leaves(opt_state.v),
                              leaves(lrs)):
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * (g * g)
        step = lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        new_p.append(p - step)
        new_m.append(m)
        new_v.append(v)
    return (from_leaves(trainables, new_p),
            AdamState(m=from_leaves(trainables, new_m),
                      v=from_leaves(trainables, new_v), count=count))
