"""Object-aware dynamic Gaussian model as capacity-padded tensor dataclasses
(counterpart of adgs_tpu/models/gaussians.py).

GaussianParams holds the trainable leaves, GaussianState the bookkeeping.
Each block is padded to a capacity with an alive mask; dead slots hold
zeros, identity quaternions, a -15 opacity logit and a -10 log-scale.

`deform` evaluates the temporal deformation: kernel T1 (csrc/deform.cu)
where `_kernels.use` says kernel, inside an autograd Function whose
backward is kernel T2; elsewhere `deformed_package_torch`, the plain
version, and `deformed_xyz` at the flow time. `deform_fwd_torch` and
`deform_bwd_torch` are T1's and T2's plain twins in the kernels' calling
convention.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _kernels
from .._device import resolve_device
from ..core import quaternion as quat
from ..core import splines
from ..core.sh import rgb_to_sh
from ..profiling import copied_in


class GaussianConfig(NamedTuple):
    sh_degree: int
    xyz: splines.BasisConfig
    rotation: splines.BasisConfig
    shs: splines.BasisConfig
    background: splines.BasisConfig
    use_time_mask: bool = True

    @classmethod
    def from_order_args(cls, order_args: dict, frame_num: int,
                        downsample_ratio: int = 3, sh_degree: int = 3,
                        use_time_mask: bool = True) -> "GaussianConfig":
        def basis(key):
            return splines.default_basis_config(order_args.get(key),
                                                frame_num, downsample_ratio)

        return cls(sh_degree=sh_degree, xyz=basis("xyz"),
                   rotation=basis("rotation"), shs=basis("shs"),
                   background=basis("background"),
                   use_time_mask=use_time_mask)


@dataclasses.dataclass(frozen=True)
class GaussianParams:
    """Raw (pre-activation) trainable parameters; scene_* have capacity Ns,
    obj_* capacity No."""

    scene_xyz: torch.Tensor         # [Ns,3]
    scene_shs_dc: torch.Tensor      # [Ns,1,3]
    scene_shs_rest: torch.Tensor    # [Ns,K-1,3]
    scene_scaling: torch.Tensor     # [Ns,3]
    scene_rotation: torch.Tensor    # [Ns,4]
    scene_opacity: torch.Tensor     # [Ns,1]
    scene_shs_deform: torch.Tensor  # [Ns,3,Cs]

    obj_xyz: torch.Tensor           # [No,3]
    obj_shs_dc: torch.Tensor        # [No,1,3]
    obj_shs_rest: torch.Tensor      # [No,K-1,3]
    obj_scaling: torch.Tensor       # [No,3]
    obj_rotation: torch.Tensor      # [No,4]
    obj_opacity: torch.Tensor       # [No,1]
    obj_shs_deform: torch.Tensor    # [No,3,Cs]
    xyz_deform: torch.Tensor        # [No,3,Cx]
    rotation_deform: torch.Tensor   # [No,4,Cr]
    gs_time_sigma: torch.Tensor     # [No,2] log-sigmas

    background_deform: torch.Tensor  # [1,3,Cb]

    @property
    def scene_capacity(self) -> int:
        return self.scene_xyz.shape[0]

    @property
    def obj_capacity(self) -> int:
        return self.obj_xyz.shape[0]

    @property
    def capacity(self) -> int:
        return self.scene_capacity + self.obj_capacity


@dataclasses.dataclass(frozen=True)
class GaussianState:
    scene_alive: torch.Tensor     # [Ns] bool
    obj_alive: torch.Tensor       # [No] bool
    gs_time: torch.Tensor         # [No] birth times of object Gaussians
    max_radii2d: torch.Tensor     # [Ns+No]
    xyz_grad_accum: torch.Tensor  # [Ns+No]
    denom: torch.Tensor           # [Ns+No]
    obj_near_idx: torch.Tensor    # [A,Knn] int32
    obj_near_valid: torch.Tensor  # [A] bool

    @property
    def alive(self) -> torch.Tensor:
        return torch.cat([self.scene_alive, self.obj_alive], dim=0)

    @property
    def num_scene(self) -> torch.Tensor:
        """0-d count of alive scene Gaussians."""
        return torch.sum(self.scene_alive)

    @property
    def num_obj(self) -> torch.Tensor:
        """0-d count of alive object Gaussians."""
        return torch.sum(self.obj_alive)


def _pad(a: np.ndarray, cap: int, fill: float = 0.0) -> np.ndarray:
    out = np.full((cap,) + a.shape[1:], fill, dtype=np.float32)
    out[: a.shape[0]] = a
    return out


def round_capacity(n: int, quantum: int = 4096) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def create_from_pcd(points: np.ndarray, colors: np.ndarray,
                    obj_id: np.ndarray, times: np.ndarray,
                    config: GaussianConfig, knn_mean_sq_dist: np.ndarray,
                    capacity_quantum: int = 4096, seed: int = 0,
                    device=None) -> tuple[GaussianParams, GaussianState]:
    """Initialize from a fused point cloud: SH DC from the colours, rest
    zero; isotropic log-scale log(sqrt(max(3-NN mean sq dist, 1e-7)));
    identity rotations; opacity logit(0.1); deformation U(-1,1)*1e-5 drawn
    in the same order as the JAX package, so one seed gives the same
    values in both."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    obj = np.asarray(obj_id).reshape(-1) > 0.5
    scene = ~obj
    n = points.shape[0]
    K = (config.sh_degree + 1) ** 2

    shs_dc = rgb_to_sh(colors.astype(np.float32))[:, None, :]
    shs_rest = np.zeros((n, K - 1, 3), dtype=np.float32)
    dist2 = np.maximum(knn_mean_sq_dist, 1e-7)
    log_scales = np.repeat(np.log(np.sqrt(dist2))[:, None], 3, axis=1)
    rots = np.zeros((n, 4), dtype=np.float32)
    rots[:, 0] = 1.0
    opac = np.full((n, 1), np.log(0.1 / 0.9), dtype=np.float32)

    ns, no = int(scene.sum()), int(obj.sum())
    Ns = round_capacity(ns, capacity_quantum)
    No = round_capacity(no, capacity_quantum)

    def u(shape):
        return (rng.random(shape, dtype=np.float32) * 2.0 - 1.0) * 1e-5

    scene_shs_deform = u((ns, 3, config.shs.param_count))
    obj_shs_deform = u((no, 3, config.shs.param_count))
    xyz_deform = u((no, 3, config.xyz.param_count))
    rotation_deform = u((no, 4, config.rotation.param_count))
    background_deform = u((1, 3, config.background.param_count))

    scene_rot = _pad(rots[scene], Ns)
    scene_rot[ns:, 0] = 1.0
    obj_rot = _pad(rots[obj], No)
    obj_rot[no:, 0] = 1.0

    def t(a):
        return torch.as_tensor(a, device=dev)

    params = GaussianParams(
        scene_xyz=t(_pad(points[scene].astype(np.float32), Ns)),
        scene_shs_dc=t(_pad(shs_dc[scene], Ns)),
        scene_shs_rest=t(_pad(shs_rest[scene], Ns)),
        scene_scaling=t(_pad(log_scales[scene], Ns, fill=-10.0)),
        scene_rotation=t(scene_rot),
        scene_opacity=t(_pad(opac[scene], Ns, fill=-15.0)),
        scene_shs_deform=t(_pad(scene_shs_deform, Ns)),
        obj_xyz=t(_pad(points[obj].astype(np.float32), No)),
        obj_shs_dc=t(_pad(shs_dc[obj], No)),
        obj_shs_rest=t(_pad(shs_rest[obj], No)),
        obj_scaling=t(_pad(log_scales[obj], No, fill=-10.0)),
        obj_rotation=t(obj_rot),
        obj_opacity=t(_pad(opac[obj], No, fill=-15.0)),
        obj_shs_deform=t(_pad(obj_shs_deform, No)),
        xyz_deform=t(_pad(xyz_deform, No)),
        rotation_deform=t(_pad(rotation_deform, No)),
        gs_time_sigma=t(_pad(np.zeros((no, 2), np.float32), No)),
        background_deform=t(background_deform),
    )
    scene_alive = np.zeros(Ns, dtype=bool)
    scene_alive[:ns] = True
    obj_alive = np.zeros(No, dtype=bool)
    obj_alive[:no] = True
    zeros = torch.zeros(Ns + No, dtype=torch.float32, device=dev)
    state = GaussianState(
        scene_alive=t(scene_alive), obj_alive=t(obj_alive),
        gs_time=t(_pad(np.asarray(times).reshape(-1)[obj]
                       .astype(np.float32), No)),
        max_radii2d=zeros, xyz_grad_accum=zeros.clone(), denom=zeros.clone(),
        obj_near_idx=torch.zeros((1, 1), dtype=torch.int32, device=dev),
        obj_near_valid=torch.zeros((1,), dtype=torch.bool, device=dev),
    )
    return params, state


def set_init_time_sigma(params: GaussianParams,
                        frame_gap: float) -> GaussianParams:
    """gs_time_sigma init = log(frame_gap)."""
    return dataclasses.replace(
        params, gs_time_sigma=torch.full_like(params.gs_time_sigma,
                                              float(np.log(frame_gap))))


def deformed_xyz(params: GaussianParams, config: GaussianConfig,
                 t: torch.Tensor) -> torch.Tensor:
    """Per-object trajectory plus the global background trajectory on all
    Gaussians. [Ns+No, 3]."""
    obj_xyz = params.obj_xyz
    if config.xyz.param_count > 0:
        obj_xyz = obj_xyz + splines.eval_trajectory(t, params.xyz_deform,
                                                    config.xyz)
    xyz = torch.cat([params.scene_xyz, obj_xyz], dim=0)
    if config.background.param_count > 0:
        xyz = xyz + splines.eval_trajectory(t, params.background_deform,
                                            config.background)
    return xyz


def deformed_rotation(params: GaussianParams, config: GaussianConfig,
                      t: torch.Tensor) -> torch.Tensor:
    """A quaternion spline REPLACES the base rotation; a vector trajectory
    is added to it. Normalized [Ns+No, 4]."""
    cfg = config.rotation
    if cfg.quat_ctrl != 0:
        obj_rot = splines.eval_quat_trajectory(t, params.rotation_deform, cfg)
        if cfg.bspline_ctrl or cfg.poly_order or cfg.fft_order:
            obj_rot = obj_rot + splines.eval_trajectory(
                t, params.rotation_deform, cfg)
    elif cfg.param_count > 0:
        obj_rot = params.obj_rotation + splines.eval_trajectory(
            t, params.rotation_deform, cfg)
    else:
        obj_rot = params.obj_rotation
    return quat.normalize(torch.cat([params.scene_rotation, obj_rot], dim=0))


def deformed_shs(params: GaussianParams, config: GaussianConfig,
                 t: torch.Tensor) -> torch.Tensor:
    """Fourier colour deformation on the DC term of all Gaussians.
    [Ns+No, K, 3]."""
    shs_dc = torch.cat([params.scene_shs_dc, params.obj_shs_dc], dim=0)
    if config.shs.param_count > 0:
        deform = torch.cat([params.scene_shs_deform, params.obj_shs_deform],
                           dim=0)
        shs_dc = (shs_dc[:, 0] + splines.eval_trajectory(t, deform,
                                                         config.shs))[:, None]
    shs_rest = torch.cat([params.scene_shs_rest, params.obj_shs_rest], dim=0)
    return torch.cat([shs_dc, shs_rest], dim=1)


def time_masked_opacity(params: GaussianParams, state: GaussianState,
                        t: torch.Tensor) -> torch.Tensor:
    """Asymmetric Gaussian falloff around each object Gaussian's birth
    time. Activated [Ns+No, 1]."""
    delta = t - state.gs_time
    sigma = torch.exp(params.gs_time_sigma)
    sigma = torch.where(delta < 0.0, sigma[:, 0], sigma[:, 1])
    mask = torch.exp(-0.5 * (delta / sigma) ** 2)
    obj_op = torch.sigmoid(params.obj_opacity) * mask[:, None]
    return torch.cat([torch.sigmoid(params.scene_opacity), obj_op], dim=0)


def activated_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(torch.cat([params.scene_opacity,
                                    params.obj_opacity], dim=0))


def activated_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(torch.cat([params.scene_scaling, params.obj_scaling],
                               dim=0))


def obj_mask(params: GaussianParams) -> torch.Tensor:
    """False for scene slots, True for object slots."""
    dev = params.obj_xyz.device
    return torch.cat([
        torch.zeros(params.scene_capacity, dtype=torch.bool, device=dev),
        torch.ones(params.obj_capacity, dtype=torch.bool, device=dev)])


def deformed_package_torch(params: GaussianParams, state: GaussianState,
                           config: GaussianConfig, t: torch.Tensor) -> dict:
    """Time-evaluated render inputs: the plain version of `deform`."""
    if config.use_time_mask:
        opacity = time_masked_opacity(params, state, t)
    else:
        opacity = activated_opacity(params)
    return {
        "xyz": deformed_xyz(params, config, t),
        "rotation": deformed_rotation(params, config, t),
        "shs": deformed_shs(params, config, t),
        "opacity": opacity,
    }


# the leaves the deformation reads, in csrc/deform.cu's order
DEFORM_LEAVES = ("scene_xyz", "scene_shs_dc", "scene_shs_rest",
                 "scene_rotation", "scene_opacity", "scene_shs_deform",
                 "obj_xyz", "obj_shs_dc", "obj_shs_rest", "obj_rotation",
                 "obj_opacity", "obj_shs_deform", "xyz_deform",
                 "rotation_deform", "gs_time_sigma", "background_deform")
# T1's and T2's largest B-spline and quaternion order, and largest number
# of polynomial or Fourier (2 x order) terms of one basis
MAX_ORDER = 5
MAX_TERMS = 128
_BLOCK = 256        # csrc/deform.cu kThreads
_MAT = (MAX_ORDER + 1) ** 2


def deform(params: GaussianParams, state: GaussianState,
           config: GaussianConfig, t: torch.Tensor,
           flow_time: Optional[torch.Tensor] = None
           ) -> tuple[dict, Optional[torch.Tensor]]:
    """The render inputs at time t (`deformed_package_torch`'s dict: xyz,
    rotation, shs, opacity, each a fresh contiguous tensor) and, with
    flow_time, the xyz at the flow time (else None). One launch of T1 for
    both, and T2 for the gradient, or the plain version, as
    `_kernels.use` says for params.scene_xyz."""
    if not _kernels.use(params.scene_xyz):
        pkg = deformed_package_torch(params, state, config, t)
        flow = (None if flow_time is None
                else deformed_xyz(params, config, flow_time))
        return pkg, flow
    dev = params.scene_xyz.device
    leaves = tuple(getattr(params, name).contiguous()
                   for name in DEFORM_LEAVES)
    gs_time = state.gs_time.contiguous()
    t = _time(t, dev)
    flow_time = None if flow_time is None else _time(flow_time, dev)
    if torch.is_grad_enabled() and any(x.requires_grad for x in leaves):
        out = _Deform.apply(config, gs_time, t, flow_time, *leaves)
    else:
        out = _deform_fwd(config, gs_time, t, flow_time, leaves)
    xyz, rotation, shs, opacity = out[:4]
    return ({"xyz": xyz, "rotation": rotation, "shs": shs,
             "opacity": opacity},
            out[4] if flow_time is not None else None)


def _time(t, dev) -> torch.Tensor:
    """t as a 0-d float32 tensor on dev (the kernels read it there)."""
    if (isinstance(t, torch.Tensor) and t.device == dev
            and t.dtype == torch.float32 and t.numel() == 1):
        return t.reshape(())
    out = torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(())
    if not (isinstance(t, torch.Tensor) and t.device == dev):
        copied_in(out)
    return out


def _reached(config: GaussianConfig) -> tuple[bool, ...]:
    """Per DEFORM_LEAVES: whether the plain version's autograd graph gives
    the leaf a gradient (the base object rotation not under a quaternion
    spline, the time sigmas only under the time mask, a trajectory only
    with columns)."""
    shs = config.shs.param_count > 0
    return (True, True, True, True, True, shs,
            True, True, True, config.rotation.quat_ctrl == 0, True, shs,
            config.xyz.param_count > 0, config.rotation.param_count > 0,
            config.use_time_mask, config.background.param_count > 0)


@functools.lru_cache(maxsize=None)
def _basis_args(config: GaussianConfig):
    """The kernels' per-basis integers and de Boor-Cox matrices (xyz,
    rotation, shs, background); raises above the orders and term counts
    they are built for."""
    ints, mats = [], np.zeros(8 * _MAT, np.float32)
    for b, cfg in enumerate((config.xyz, config.rotation, config.shs,
                             config.background)):
        for name, v, top in (("B-spline order", cfg.bspline_order,
                              MAX_ORDER),
                             ("quaternion order", cfg.quat_order, MAX_ORDER),
                             ("polynomial order", cfg.poly_order, MAX_TERMS),
                             ("Fourier terms", 2 * cfg.fft_order,
                              MAX_TERMS)):
            if v > top:
                raise ValueError(f"deform: a {name} of {v} is above the "
                                 f"kernels' {top}")
        ints += [cfg.bspline_ctrl, cfg.bspline_order, cfg.poly_order,
                 cfg.fft_order, cfg.quat_ctrl, cfg.quat_order]
        for j, order in enumerate((cfg.bspline_order, cfg.quat_order)):
            m = splines.deboor_cox_matrix(order).reshape(-1)
            mats[(2 * b + j) * _MAT:(2 * b + j) * _MAT + m.size] = m
    return ints, mats


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(dev: torch.device, n: int) -> int:
    """T1's and T2's grid: each block builds its time tables once, then
    strides over tiles of _BLOCK slots."""
    return max(1, min(-(-n // _BLOCK), 8 * _sm_count(dev.index or 0)))


def _check_leaves(leaves, gs_time, t, flow_time):
    """Validate the operands of T1 and T2; returns (ns, no, K)."""
    ns, no = leaves[0].shape[0], leaves[6].shape[0]
    k = leaves[2].shape[1] + 1
    shapes = {"scene_xyz": (ns, 3), "scene_shs_dc": (ns, 1, 3),
              "scene_shs_rest": (ns, k - 1, 3), "scene_rotation": (ns, 4),
              "scene_opacity": (ns, 1), "obj_xyz": (no, 3),
              "obj_shs_dc": (no, 1, 3), "obj_shs_rest": (no, k - 1, 3),
              "obj_rotation": (no, 4), "obj_opacity": (no, 1),
              "gs_time_sigma": (no, 2)}
    for name, x in zip(DEFORM_LEAVES, leaves):
        _kernels.require(x, name, torch.float32, shapes.get(name))
    for name, x, lead in (("scene_shs_deform", leaves[5], (ns, 3)),
                          ("obj_shs_deform", leaves[11], (no, 3)),
                          ("xyz_deform", leaves[12], (no, 3)),
                          ("rotation_deform", leaves[13], (no, 4)),
                          ("background_deform", leaves[15], (1, 3))):
        if x.dim() != 3 or tuple(x.shape[:2]) != lead:
            raise ValueError(f"{name}: expected shape {lead} + (C,), got "
                             f"{tuple(x.shape)}")
    _kernels.require(gs_time, "gs_time", torch.float32, (no,))
    _kernels.require(t, "t", torch.float32, ())
    if flow_time is not None:
        _kernels.require(flow_time, "flow_time", torch.float32, ())
    return ns, no, k


def _ints(config, ns, no, k, blocks):
    basis, mats = _basis_args(config)
    return (np.array([ns, no, k, int(config.use_time_mask), blocks] + basis,
                     np.int64), mats)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _deform_fwd(config, gs_time, t, flow_time, leaves):
    """One launch of T1: (xyz, rotation, shs, opacity, the xyz at
    flow_time or None)."""
    ns, no, k = _check_leaves(leaves, gs_time, t, flow_time)
    for cfg, x in ((config.xyz, leaves[12]), (config.rotation, leaves[13]),
                   (config.shs, leaves[5]), (config.background,
                                             leaves[15])):
        if x.shape[2] != cfg.param_count:
            raise ValueError(f"deform: {cfg} has {cfg.param_count} "
                             f"columns, the rows {x.shape[2]}")
    n = ns + no
    f32 = dict(dtype=torch.float32, device=t.device)
    out = (torch.empty((n, 3), **f32), torch.empty((n, 4), **f32),
           torch.empty((n, k, 3), **f32), torch.empty((n, 1), **f32),
           None if flow_time is None else torch.empty((n, 3), **f32))
    blocks = _blocks(t.device, n)
    ints, mats = _ints(config, ns, no, k, blocks)
    ptrs = np.array([x.data_ptr() for x in leaves]
                    + [_ptr(x) for x in (gs_time, t, flow_time) + out],
                    np.int64)
    err = _kernels.entry("deform", "adgs_deform_fwd", "pppp")(
        ptrs.ctypes.data, ints.ctypes.data, mats.ctypes.data,
        _kernels.stream(t))
    _kernels.check(err, "deform")
    _kernels.launches["deform"] += 1
    return out


def _deform_bwd(config, gs_time, t, flow_time, leaves, grads, needs):
    """One call of T2 (its per-slot kernel and, for the background
    trajectory, its one-block sum): the gradient of each leaf (None where
    not `needs` or where the plain graph gives none) from grads, the
    gradients of (xyz, flow xyz or None, rotation, shs, opacity)."""
    ns, no, k = _check_leaves(leaves, gs_time, t, flow_time)
    n = ns + no
    grads = [None if g is None else g.contiguous() for g in grads]
    for g, name, shape in zip(grads, ("xyz", "flow xyz", "rotation", "shs",
                                      "opacity"),
                              ((n, 3), (n, 3), (n, 4), (n, k, 3), (n, 1))):
        if g is not None or name != "flow xyz":
            _kernels.require(g, f"dL/d{name}", torch.float32, shape)
    reached = _reached(config)
    out = [torch.empty_like(x) if need and go else None
           for x, need, go in zip(leaves, needs, reached)]
    blocks = _blocks(t.device, n)
    partials = (None if out[15] is None else torch.empty(
        (blocks, 6), dtype=torch.float32, device=t.device))
    ints, mats = _ints(config, ns, no, k, blocks)
    ptrs = np.array([x.data_ptr() for x in leaves]
                    + [_ptr(x) for x in (gs_time, t, flow_time)]
                    + [0] * 5 + [_ptr(g) for g in grads]
                    + [_ptr(x) for x in out] + [_ptr(partials)], np.int64)
    err = _kernels.entry("deform_bwd", "adgs_deform_bwd", "pppp")(
        ptrs.ctypes.data, ints.ctypes.data, mats.ctypes.data,
        _kernels.stream(t))
    _kernels.check(err, "deform_bwd")
    _kernels.launches["deform_bwd"] += 1
    return out


class _Deform(torch.autograd.Function):
    """T1 forward, T2 backward. T2 recomputes the forward from the inputs,
    so only the inputs and the times are saved."""

    @staticmethod
    def forward(ctx, config, gs_time, t, flow_time, *leaves):
        out = _deform_fwd(config, gs_time, t, flow_time, leaves)
        ctx.config = config
        ctx.save_for_backward(gs_time, t, flow_time, *leaves)
        return out if flow_time is not None else out[:4]

    @staticmethod
    def backward(ctx, g_xyz, g_rot, g_shs, g_op, g_flow=None):
        gs_time, t, flow_time, *leaves = ctx.saved_tensors
        out = _deform_bwd(ctx.config, gs_time, t, flow_time, leaves,
                          (g_xyz, g_flow, g_rot, g_shs, g_op),
                          ctx.needs_input_grad[4:])
        return (None, None, None, None, *out)


def _plain_inputs(leaves, gs_time):
    """GaussianParams and a stand-in state from T1's operands (the
    scalings, which the deformation does not read, empty)."""
    fields = dict(zip(DEFORM_LEAVES, leaves))
    empty = leaves[0].new_zeros((0, 3))
    params = GaussianParams(scene_scaling=empty, obj_scaling=empty, **fields)
    return params, types.SimpleNamespace(gs_time=gs_time)


def deform_fwd_torch(config, gs_time, t, flow_time, leaves):
    """Plain twin of T1 in `_deform_fwd`'s convention, on any device."""
    params, state = _plain_inputs(leaves, gs_time)
    pkg = deformed_package_torch(params, state, config, t)
    flow = (None if flow_time is None
            else deformed_xyz(params, config, flow_time))
    return pkg["xyz"], pkg["rotation"], pkg["shs"], pkg["opacity"], flow


def deform_bwd_torch(config, gs_time, t, flow_time, leaves, grads, needs):
    """Plain twin of T2 in `_deform_bwd`'s convention, on any device:
    autograd through the plain version, None where it gives no gradient
    or none is needed."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in leaves]
        out = deform_fwd_torch(config, gs_time, t, flow_time, xs)
        pairs = [(o, g) for o, g in zip(
            out, (grads[0], grads[2], grads[3], grads[4], grads[1]))
            if o is not None]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  xs, [g for _, g in pairs],
                                  allow_unused=True)
    return [g if need else None for g, need in zip(got, needs)]
