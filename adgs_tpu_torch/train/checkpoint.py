"""Checkpointing: reference-format PLY + deform export, and full train-state
snapshots (counterpart of adgs_tpu/train/checkpoint.py; the files are
interchangeable with the JAX package's in both directions).

Two tiers:
  1. `save_ply` / `load_ply`: the reference's point_cloud.ply layout
     (property names shs_dc_i / shs_rest_i / opacity / scale_i / rot_i /
     obj) plus a `deform.npz` holding the deformation parameters.
  2. `save_state` / `load_state`: a full training snapshot (params, Adam
     moments + count, alive masks, stats, env map, iteration) in one npz,
     keyed "<part>.<i>" by the leaves' order (the dataclasses' field
     order, which is also the JAX package's pytree order).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import splines
from ..data.ply import read_ply, write_ply
from ..models.env_map import EnvironmentMap
from ..models.gaussians import (GaussianConfig, GaussianParams, GaussianState,
                                _pad, round_capacity)
from .optim import AdamState, TrainableState, from_leaves, leaves


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_ply(path: str, params: GaussianParams, state: GaussianState,
             config: GaussianConfig) -> None:
    """Write alive Gaussians in the reference PLY layout + deform.npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sa, oa = _np(state.scene_alive), _np(state.obj_alive)

    def cat(scene_f, obj_f):
        return np.concatenate([_np(scene_f)[sa], _np(obj_f)[oa]], axis=0)

    xyz = cat(params.scene_xyz, params.obj_xyz)
    shs_dc = cat(params.scene_shs_dc, params.obj_shs_dc)      # [N,1,3]
    shs_rest = cat(params.scene_shs_rest, params.obj_shs_rest)  # [N,K-1,3]
    opac = cat(params.scene_opacity, params.obj_opacity)
    scale = cat(params.scene_scaling, params.obj_scaling)
    rot = cat(params.scene_rotation, params.obj_rotation)
    n_scene = int(sa.sum())
    obj_flag = np.concatenate([np.zeros(n_scene, np.float32),
                               np.ones(int(oa.sum()), np.float32)])

    fields = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
              "nx": np.zeros(len(xyz), np.float32),
              "ny": np.zeros(len(xyz), np.float32),
              "nz": np.zeros(len(xyz), np.float32)}
    # reference layout: torch [N,1,3].transpose(1,2).flatten -> [N, 3*1]
    dc = shs_dc.transpose(0, 2, 1).reshape(len(xyz), -1)
    for i in range(dc.shape[1]):
        fields[f"shs_dc_{i}"] = dc[:, i].astype(np.float32)
    rest = shs_rest.transpose(0, 2, 1).reshape(len(xyz), -1)
    for i in range(rest.shape[1]):
        fields[f"shs_rest_{i}"] = rest[:, i].astype(np.float32)
    fields["opacity"] = opac[:, 0].astype(np.float32)
    for i in range(3):
        fields[f"scale_{i}"] = scale[:, i].astype(np.float32)
    for i in range(4):
        fields[f"rot_{i}"] = rot[:, i].astype(np.float32)
    fields["obj"] = obj_flag
    fields = {k: np.ascontiguousarray(v, dtype=np.float32)
              for k, v in fields.items()}
    write_ply(path, fields)

    np.savez(
        os.path.join(os.path.dirname(path), "deform.npz"),
        xyz_deform=_np(params.xyz_deform)[oa],
        rotation_deform=_np(params.rotation_deform)[oa],
        shs_deform_scene=_np(params.scene_shs_deform)[sa],
        shs_deform_obj=_np(params.obj_shs_deform)[oa],
        background_deform=_np(params.background_deform),
        gs_time=_np(state.gs_time)[oa],
        gs_time_sigma=_np(params.gs_time_sigma)[oa],
        use_time_mask=np.asarray(config.use_time_mask),
        order_args=np.asarray(json.dumps({
            "xyz": list(config.xyz), "rotation": list(config.rotation),
            "shs": list(config.shs), "background": list(config.background),
        })),
    )


def load_ply(path: str, config: GaussianConfig, capacity_quantum: int = 4096,
             device=None
             ) -> tuple[GaussianParams, GaussianState, GaussianConfig]:
    """Load a reference-layout PLY + deform.npz into capacity-padded
    tensors on `device` (the card unless given); the deformation orders
    and the time mask come from deform.npz."""
    dev = resolve_device(device)
    v = read_ply(path)
    n = len(v["x"])
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    obj_mask = v["obj"] > 0.5
    scene_mask = ~obj_mask
    K = (config.sh_degree + 1) ** 2

    dc = np.stack([v[f"shs_dc_{i}"] for i in range(3)], 1)  # [N,3]
    shs_dc = dc.reshape(n, 3, 1).transpose(0, 2, 1)          # [N,1,3]
    n_rest = 3 * (K - 1)
    rest = np.stack([v[f"shs_rest_{i}"] for i in range(n_rest)], 1)
    shs_rest = rest.reshape(n, 3, K - 1).transpose(0, 2, 1)
    opac = v["opacity"][:, None].astype(np.float32)
    scale = np.stack([v[f"scale_{i}"] for i in range(3)], 1).astype(np.float32)
    rot = np.stack([v[f"rot_{i}"] for i in range(4)], 1).astype(np.float32)

    d = np.load(os.path.join(os.path.dirname(path), "deform.npz"),
                allow_pickle=True)
    order = json.loads(str(d["order_args"]))
    config = config._replace(
        xyz=splines.BasisConfig(*order["xyz"]),
        rotation=splines.BasisConfig(*order["rotation"]),
        shs=splines.BasisConfig(*order["shs"]),
        background=splines.BasisConfig(*order["background"]),
        use_time_mask=bool(d["use_time_mask"]))

    ns, no = int(scene_mask.sum()), int(obj_mask.sum())
    Ns = round_capacity(ns, capacity_quantum)
    No = round_capacity(no, capacity_quantum)
    if d["xyz_deform"].shape[0] != no:
        raise ValueError(f"{path}: {no} object Gaussians, deform.npz has "
                         f"{d['xyz_deform'].shape[0]}")
    if d["xyz_deform"].shape[-1] != config.xyz.param_count:
        raise ValueError(f"{path}: xyz_deform has {d['xyz_deform'].shape[-1]}"
                         f" coefficients, the order needs "
                         f"{config.xyz.param_count}")

    def pad_rot(arr, cap, count):
        out = _pad(arr, cap)
        out[count:, 0] = 1.0
        return out

    def t(a):
        return torch.as_tensor(a, device=dev)

    params = GaussianParams(
        scene_xyz=t(_pad(xyz[scene_mask], Ns)),
        scene_shs_dc=t(_pad(shs_dc[scene_mask].astype(np.float32), Ns)),
        scene_shs_rest=t(_pad(shs_rest[scene_mask].astype(np.float32), Ns)),
        scene_scaling=t(_pad(scale[scene_mask], Ns, fill=-10.0)),
        scene_rotation=t(pad_rot(rot[scene_mask], Ns, ns)),
        scene_opacity=t(_pad(opac[scene_mask], Ns, fill=-15.0)),
        scene_shs_deform=t(_pad(d["shs_deform_scene"], Ns)),
        obj_xyz=t(_pad(xyz[obj_mask], No)),
        obj_shs_dc=t(_pad(shs_dc[obj_mask].astype(np.float32), No)),
        obj_shs_rest=t(_pad(shs_rest[obj_mask].astype(np.float32), No)),
        obj_scaling=t(_pad(scale[obj_mask], No, fill=-10.0)),
        obj_rotation=t(pad_rot(rot[obj_mask], No, no)),
        obj_opacity=t(_pad(opac[obj_mask], No, fill=-15.0)),
        obj_shs_deform=t(_pad(d["shs_deform_obj"], No)),
        xyz_deform=t(_pad(d["xyz_deform"], No)),
        rotation_deform=t(_pad(d["rotation_deform"], No)),
        gs_time_sigma=t(_pad(d["gs_time_sigma"], No)),
        background_deform=t(np.asarray(d["background_deform"], np.float32)),
    )
    scene_alive = np.zeros(Ns, bool)
    scene_alive[:ns] = True
    obj_alive = np.zeros(No, bool)
    obj_alive[:no] = True
    zeros = torch.zeros(Ns + No, dtype=torch.float32, device=dev)
    state = GaussianState(
        scene_alive=t(scene_alive), obj_alive=t(obj_alive),
        gs_time=t(_pad(d["gs_time"], No)),
        max_radii2d=zeros, xyz_grad_accum=zeros.clone(), denom=zeros.clone(),
        obj_near_idx=torch.zeros((1, 1), dtype=torch.int32, device=dev),
        obj_near_valid=torch.zeros((1,), dtype=torch.bool, device=dev),
    )
    return params, state, config


def _state_leaves(state: GaussianState) -> list:
    return [getattr(state, f.name) for f in dataclasses.fields(state)]


def save_state(path: str, trainables: TrainableState, opt_state: AdamState,
               state: GaussianState, iteration: int,
               extras: Optional[dict] = None) -> None:
    """Full training snapshot -> one .npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}

    def put(prefix, values):
        for i, leaf in enumerate(values):
            arrays[f"{prefix}.{i}"] = _np(leaf)

    put("params", leaves(trainables)[:-1])
    put("env", [trainables.env.grid])
    put("adam_m", leaves(opt_state.m))
    put("adam_v", leaves(opt_state.v))
    put("state", _state_leaves(state))
    arrays["adam_count"] = np.asarray(_np(torch.as_tensor(opt_state.count)))
    arrays["iteration"] = np.asarray(iteration)
    if extras:
        for k, val in extras.items():
            arrays[f"extra.{k}"] = np.asarray(val)
    np.savez(path, **arrays)


def load_state(path: str, template_trainables: TrainableState,
               template_opt: AdamState, template_state: GaussianState):
    """Restore a snapshot saved by save_state (by this package or the JAX
    package). The templates give the structure and the device; shapes
    must match (same capacity). Returns (trainables, opt_state, state,
    iteration)."""
    z = np.load(path, allow_pickle=False)

    def get(prefix, like: list) -> list:
        out = [torch.as_tensor(z[f"{prefix}.{i}"], device=x.device)
               for i, x in enumerate(like)]
        for x, y in zip(like, out):
            if tuple(x.shape) != tuple(y.shape):
                raise ValueError(f"{path}: {prefix} leaf of shape "
                                 f"{tuple(y.shape)}, template "
                                 f"{tuple(x.shape)}")
        return out

    def tree(prefix, like: TrainableState) -> TrainableState:
        return from_leaves(like, get(prefix, leaves(like)))

    g = get("params", leaves(template_trainables)[:-1])
    (grid,) = get("env", [template_trainables.env.grid])
    trainables = from_leaves(template_trainables, g + [grid])
    opt_state = AdamState(
        m=tree("adam_m", template_opt.m), v=tree("adam_v", template_opt.v),
        count=torch.as_tensor(z["adam_count"]))
    st = get("state", _state_leaves(template_state))
    state = GaussianState(**{f.name: x for f, x in
                             zip(dataclasses.fields(template_state), st)})
    return trainables, opt_state, state, int(z["iteration"])


def load_env(path: str, device=None) -> EnvironmentMap:
    """The sky grid saved beside a checkpoint (env.npy)."""
    return EnvironmentMap(grid=torch.as_tensor(
        np.asarray(np.load(path), np.float32), device=resolve_device(device)))
