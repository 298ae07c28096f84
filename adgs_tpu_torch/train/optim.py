"""Per-group Adam with exponential LR schedules on the padded parameter
dataclasses (counterpart of adgs_tpu/train/optim.py).

The reference's 18 Gaussian parameter groups plus the environment map
become one Adam over TrainableState with a learning rate per leaf, so the
moments live in the same padded layout as the parameters and
densification can edit (params, m, v) together. Plain functions, not
torch.optim.Adam: the update is the JAX package's formula, b1=0.9,
b2=0.999, eps=1e-15 added OUTSIDE the sqrt, bias corrections computed in
float32 from the step count.

On CUDA tensors `adam_update` is one launch of csrc/adam.cu's
`adam_update_kernel` over every leaf (`adam_table` is its leaf table),
bitwise `adam_leaves_torch`, the plain twin that CPU tensors take.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
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


def next_count(count: torch.Tensor):
    """The step count after `count` (0-d int32, on the CPU) and its bias
    corrections 1 - b1^c, 1 - b2^c, 0-d float32 CPU tensors."""
    count = count + 1
    c = count.to(torch.float32)
    return (count, 1.0 - torch.pow(_f32(ADAM_B1), c),
            1.0 - torch.pow(_f32(ADAM_B2), c))


def adam_leaves_torch(ps, gs, ms, vs, lrs, bc1, bc2):
    """Plain twin of `adam_update_kernel`: one Adam step of each leaf p
    (gradient g, moments m, v) with its own learning rate lr, bias
    corrections bc1, bc2; returns the lists (p', m', v'). The learning
    rates and bias corrections are 0-d float32 CPU tensors, which PyTorch
    applies to CUDA tensors as scalars (no transfer, no wait)."""
    new_p, new_m, new_v = [], [], []
    for p, g, m, v, lr in zip(ps, gs, ms, vs, lrs):
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * (g * g)
        step = lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        new_p.append(p - step)
        new_m.append(m)
        new_v.append(v)
    return new_p, new_m, new_v


ADAM_CHUNK = 4096       # floats a block of adam_update_kernel takes (kChunk)
ADAM_MAX_LEAVES = 32    # leaves a launch takes (kMaxLeaves)


class AdamTable(NamedTuple):
    """The leaf table of one adam_update_kernel launch, as the host arrays
    its C entry point copies into the launch's parameters."""

    ptrs: np.ndarray    # [L, 7] int64: p, g, m, v, p', m', v'
    sizes: np.ndarray   # [L, 3] int64: floats, float4 body vectors, chunk0
    lr: np.ndarray      # [L] float32
    chunks: int         # the launch's blocks


def adam_table(groups, lrs) -> AdamTable:
    """The table of leaves `groups`, each (p, g, m, v, p', m', v') float32
    contiguous tensors of one shape, with learning rates `lrs`. A leaf of
    n floats takes ceil(n / ADAM_CHUNK) blocks from the running prefix
    sum; its first n // 4 * 4 floats go as float4s when all seven pointers
    are 16-byte aligned (else every float goes alone), the rest one at a
    time."""
    if len(groups) > ADAM_MAX_LEAVES:
        raise ValueError(f"adam_update: {len(groups)} leaves, at most "
                         f"{ADAM_MAX_LEAVES}")
    ptrs = np.zeros((len(groups), 7), np.int64)
    sizes = np.zeros((len(groups), 3), np.int64)
    chunks = 0
    for i, grp in enumerate(groups):
        shape = grp[0].shape
        for t in grp:
            if t.dtype != torch.float32:
                raise ValueError(f"adam_update: leaf {i}: expected "
                                 f"torch.float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"adam_update: leaf {i}: expected "
                                 "contiguous tensors")
            if t.shape != shape:
                raise ValueError(f"adam_update: leaf {i}: shape "
                                 f"{tuple(t.shape)} against {tuple(shape)}")
        ptrs[i] = [t.data_ptr() for t in grp]
        n = grp[0].numel()
        aligned = all(int(q) % 16 == 0 for q in ptrs[i])
        sizes[i] = (n, n // 4 if aligned else 0, chunks)
        chunks += -(-n // ADAM_CHUNK)
    return AdamTable(ptrs=ptrs, sizes=sizes,
                     lr=np.array([float(x) for x in lrs], np.float32),
                     chunks=chunks)


def adam_scalars(bc1, bc2) -> np.ndarray:
    """adam_update_kernel's constants as the eager path rounds them on the
    card: the Python floats as float32, and m / bc1, v / bc2 as products
    with the float32 reciprocals (PyTorch's division of a CUDA tensor by a
    CPU scalar)."""
    one = np.float32(1.0)
    return np.array([ADAM_B1, 1 - ADAM_B1, ADAM_B2, 1 - ADAM_B2,
                     one / np.float32(float(bc1)),
                     one / np.float32(float(bc2)), ADAM_EPS], np.float32)


def adam_leaves(ps, gs, ms, vs, lrs, bc1, bc2):
    """One launch of adam_update_kernel over every leaf (each tensor
    float32, contiguous, on one card), bitwise the twin, or
    `adam_leaves_torch` where `_kernels.use` says so. Fresh outputs: the
    callers keep the old leaves."""
    if not _kernels.use(ps[0]):
        return adam_leaves_torch(ps, gs, ms, vs, lrs, bc1, bc2)
    dev = ps[0].device
    groups = list(zip(ps, gs, ms, vs))
    for i, grp in enumerate(groups):
        if any(t.device != dev for t in grp):
            raise ValueError(f"adam_update: leaf {i}: expected tensors on "
                             f"{dev}, got {[str(t.device) for t in grp]}")
    outs = [[torch.empty_like(p) for p in ps] for _ in range(3)]
    table = adam_table([grp + tuple(o) for grp, *o in zip(groups, *outs)],
                       lrs)
    if table.chunks:
        scalars = adam_scalars(bc1, bc2)
        fn = _kernels.entry("adam", "adgs_adam_update", "ppppiqp")
        err = fn(table.ptrs.ctypes.data, table.sizes.ctypes.data,
                 table.lr.ctypes.data, scalars.ctypes.data, len(groups),
                 table.chunks, _kernels.stream(ps[0]))
        _kernels.check(err, "adam")
        _kernels.launches["adam"] += 1
    return outs


def adam_update(trainables: TrainableState, grads: TrainableState,
                opt_state: AdamState, lrs: TrainableState
                ) -> tuple[TrainableState, AdamState]:
    """One Adam step of every leaf with its own learning rate
    (`adam_leaves`: one kernel launch, or the plain twin). The step count
    stays on the CPU, so the bias corrections reach the card as scalars."""
    count, bc1, bc2 = next_count(opt_state.count)
    new_p, new_m, new_v = adam_leaves(
        leaves(trainables), leaves(grads), leaves(opt_state.m),
        leaves(opt_state.v), leaves(lrs), bc1, bc2)
    return (from_leaves(trainables, new_p),
            AdamState(m=from_leaves(trainables, new_m),
                      v=from_leaves(trainables, new_v), count=count))
