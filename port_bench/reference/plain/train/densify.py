"""Densification and pruning on capacity-padded blocks: a frozen plain copy
of the port's `densify_and_prune_eps` (adgs_tpu_torch/train/densify.py),
in float32 torch operations, without the port's profiling counters.

Clone and split write into DEAD slots, found by a stable argsort of the
alive mask, at fixed shapes. The Adam moments ride along in the same
scatter (zeros for new slots); pruning clears the alive bit. More
requested copies than dead slots drop the excess and report it. The
split's N(0, 1) draw is an input. The sky grid and its moments are
carried by reference, never copied.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.quaternion import to_rotation_matrix
from ..models.gaussians import GaussianState
from .optim import AdamState, TrainableState

SCENE_FIELDS = ("scene_xyz", "scene_shs_dc", "scene_shs_rest",
                "scene_scaling", "scene_rotation", "scene_opacity",
                "scene_shs_deform")
OBJ_FIELDS = ("obj_xyz", "obj_shs_dc", "obj_shs_rest", "obj_scaling",
              "obj_rotation", "obj_opacity", "obj_shs_deform", "xyz_deform",
              "rotation_deform", "gs_time_sigma")
SPLIT_N = 2


class DensifyReport(NamedTuple):
    """0-d integer tensors."""

    scene_cloned: torch.Tensor
    scene_split: torch.Tensor
    obj_cloned: torch.Tensor
    obj_split: torch.Tensor
    scene_dropped: torch.Tensor   # requested but no free slot
    obj_dropped: torch.Tensor
    scene_pruned: torch.Tensor
    obj_pruned: torch.Tensor


def _scatter_copies(blocks: dict, alive: torch.Tensor,
                    src_mask: torch.Tensor, overrides: dict, copies: int):
    """Write `copies` duplicates of the masked slots into dead slots.
    blocks: name -> [C, ...] tensors (params and moments). overrides: name
    -> [copies, C, ...] values for the new duplicates, or a number written
    into all of them (the moments' zeros); other blocks copy their source
    rows.

    Returns (new_blocks, new_alive, n_written, n_dropped)."""
    C = alive.shape[0]
    dev = alive.device
    # masked slots first, dead slots first (stable: in slot order)
    src_order = torch.argsort((~src_mask).to(torch.uint8), stable=True)
    free_order = torch.argsort(alive.to(torch.uint8), stable=True)
    n_src = torch.sum(src_mask)
    n_free = torch.sum(~alive)

    k = torch.arange(copies * C, device=dev)
    cand_src = src_order[k // copies]
    copy_idx = k % copies
    valid = (k // copies < n_src) & (k < n_free)
    # invalid copies go to row C of a buffer one row longer, then dropped
    dest = torch.where(valid, free_order[torch.clamp(k, max=C - 1)],
                       torch.full_like(k, C))

    def put(arr, vals):
        buf = torch.cat([arr, arr[:1]], dim=0)
        buf[dest] = vals
        return buf[:C]

    out = {}
    for name, arr in blocks.items():
        ov = overrides.get(name)
        if ov is None:
            vals = arr[cand_src]
        elif isinstance(ov, torch.Tensor):
            vals = ov[copy_idx, cand_src]
        else:
            vals = torch.tensor(ov, dtype=arr.dtype, device=dev)
        out[name] = put(arr, vals)
    new_alive = put(alive, torch.tensor(True, device=dev))
    n_written = torch.sum(valid)
    n_dropped = copies * n_src - n_written
    return out, new_alive, n_written, n_dropped


def _block(trainables: TrainableState, opt_state: AdamState,
           fields: tuple[str, ...]) -> dict:
    blocks = {}
    for f in fields:
        blocks[f"p.{f}"] = getattr(trainables.gaussians, f)
        blocks[f"m.{f}"] = getattr(opt_state.m.gaussians, f)
        blocks[f"v.{f}"] = getattr(opt_state.v.gaussians, f)
    return blocks


def _unblock(blocks: dict, trainables: TrainableState, opt_state: AdamState,
             fields: tuple[str, ...]):
    def part(pre, like):
        return dataclasses.replace(like, **{f: blocks[pre + f]
                                            for f in fields})

    return (trainables._replace(gaussians=part("p.", trainables.gaussians)),
            opt_state._replace(
                m=opt_state.m._replace(gaussians=part("m.",
                                                      opt_state.m.gaussians)),
                v=opt_state.v._replace(gaussians=part("v.",
                                                      opt_state.v.gaussians))))


def _zero_moments(fields) -> dict:
    return {pre + f: 0.0 for f in fields for pre in ("m.", "v.")}


def _densify_block(trainables, opt_state, fields, alive, grads_avg,
                   grad_threshold, extent, percent_dense, big_extent_frac,
                   prune_big, min_opacity, gs_time, eps, prefix):
    """Clone + split + prune for one (scene or obj) block. eps: the split's
    N(0, 1) draw [N, C, 3]. Returns updated (trainables, opt_state, alive,
    gs_time, n_cloned, n_split, n_dropped, n_pruned)."""
    gauss = trainables.gaussians
    scaling = torch.exp(getattr(gauss, f"{prefix}_scaling"))
    max_scale = torch.amax(scaling, dim=-1)
    densify = (grads_avg >= grad_threshold) & alive

    # clone: small Gaussians, raw copies
    clone_mask = densify & (max_scale <= extent * percent_dense)
    blocks = _block(trainables, opt_state, fields)
    if gs_time is not None:
        blocks["s.gs_time"] = gs_time
    blocks, alive, n_cloned, drop_c = _scatter_copies(
        blocks, alive, clone_mask, _zero_moments(fields), copies=1)

    # split: large Gaussians, SPLIT_N samples of each, scales / (0.8 N)
    split_mask = densify & (max_scale > extent * percent_dense)
    rot = to_rotation_matrix(getattr(gauss, f"{prefix}_rotation"))
    v = eps.to(scaling.dtype) * scaling[None]                 # [N, C, 3]
    samples = torch.sum(rot[None] * v[:, :, None, :], dim=-1)  # rot @ v
    new_xyz = getattr(gauss, f"{prefix}_xyz")[None] + samples
    new_scaling = torch.log(scaling / (0.8 * SPLIT_N))[None].expand(
        SPLIT_N, -1, -1)
    ov = _zero_moments(fields)
    ov[f"p.{prefix}_xyz"] = new_xyz
    ov[f"p.{prefix}_scaling"] = new_scaling
    blocks, alive, n_split, drop_s = _scatter_copies(
        blocks, alive, split_mask, ov, copies=SPLIT_N)
    alive = alive & ~split_mask          # the split sources go

    # opacity and size pruning
    opacity = torch.sigmoid(blocks[f"p.{prefix}_opacity"][:, 0])
    prune = opacity < min_opacity
    if prune_big:
        big = (torch.amax(torch.exp(blocks[f"p.{prefix}_scaling"]), dim=-1)
               > extent * big_extent_frac)
        prune = prune | big
    n_pruned = torch.sum(prune & alive)
    alive = alive & ~prune

    gs_time_out = blocks.pop("s.gs_time", None)
    trainables, opt_state = _unblock(blocks, trainables, opt_state, fields)
    return (trainables, opt_state, alive, gs_time_out,
            n_cloned, n_split, drop_c + drop_s, n_pruned)


def densify_and_prune_eps(trainables: TrainableState, opt_state: AdamState,
                          state: GaussianState, eps_scene: torch.Tensor,
                          eps_obj: torch.Tensor, max_scene_grad: float,
                          max_obj_grad: float, min_opacity: float,
                          prune_big: bool, scene_extent: float,
                          object_extent: float, percent_dense: float
                          ) -> tuple[TrainableState, AdamState,
                                     GaussianState, DensifyReport]:
    """Clone, split and prune both blocks on the given split draws
    (eps_scene [2, Ns, 3], eps_obj [2, No, 3]), then reset the
    densification statistics. prune_big: also prune Gaussians larger than
    a share of the extent (after the first opacity reset)."""
    grads = state.xyz_grad_accum / torch.clamp(state.denom, min=1e-12)
    grads = torch.where(state.denom > 0, grads, torch.zeros_like(grads))
    Ns = trainables.gaussians.scene_capacity
    prune_big = bool(prune_big)

    (trainables, opt_state, scene_alive, _, sc_c, sc_s, sc_d, sc_p) = \
        _densify_block(trainables, opt_state, SCENE_FIELDS,
                       state.scene_alive, grads[:Ns], max_scene_grad,
                       scene_extent, percent_dense, 0.05, prune_big,
                       min_opacity, None, eps_scene, "scene")
    (trainables, opt_state, obj_alive, gs_time, ob_c, ob_s, ob_d, ob_p) = \
        _densify_block(trainables, opt_state, OBJ_FIELDS,
                       state.obj_alive, grads[Ns:], max_obj_grad,
                       object_extent, percent_dense, 0.1, prune_big,
                       min_opacity, state.gs_time, eps_obj, "obj")

    new_state = dataclasses.replace(
        state, scene_alive=scene_alive, obj_alive=obj_alive, gs_time=gs_time,
        max_radii2d=torch.zeros_like(state.max_radii2d),
        xyz_grad_accum=torch.zeros_like(state.xyz_grad_accum),
        denom=torch.zeros_like(state.denom))
    report = DensifyReport(scene_cloned=sc_c, scene_split=sc_s,
                           obj_cloned=ob_c, obj_split=ob_s,
                           scene_dropped=sc_d, obj_dropped=ob_d,
                           scene_pruned=sc_p, obj_pruned=ob_p)
    return trainables, opt_state, new_state, report
