"""Object-aware dynamic Gaussian model as capacity-padded tensor dataclasses
(counterpart of adgs_tpu/models/gaussians.py).

GaussianParams holds the trainable leaves, GaussianState the bookkeeping.
Each block is padded to a capacity with an alive mask; dead slots hold
zeros, identity quaternions, a -15 opacity logit and a -10 log-scale.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import quaternion as quat
from ..core import splines
from ..core.sh import rgb_to_sh


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


def deformed_package(params: GaussianParams, state: GaussianState,
                     config: GaussianConfig, t: torch.Tensor) -> dict:
    """Time-evaluated render inputs."""
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
