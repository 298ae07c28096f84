"""Densification and pruning on capacity-padded blocks (counterpart of
adgs_tpu/train/densify.py; the reference's densify_and_clone,
densify_and_split with N = 2 and the 0.8 N scale shrink, opacity and size
pruning, reset_opacity and the Adam-state surgery).

Clone and split write into DEAD slots, found by a stable argsort of the
alive mask, at fixed shapes and in the same slots as the JAX package. The
Adam moments ride along in the same scatter (zeros for new slots);
pruning clears the alive bit, so moments of dead slots are inert. More
requested copies than dead slots drop the excess and report it; the
trainer then grows the capacity (`grow_capacity`).

Every function returns new tensors and leaves its inputs as they were.
The sky grid and its moments are carried by reference, never copied.
The split's normal draw is kept apart from the computation:
`densify_and_prune` draws it from a torch.Generator, and
`densify_and_prune_eps` takes it as input.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.quaternion import to_rotation_matrix
from ..models.gaussians import GaussianParams, GaussianState
from ..profiling import copied_in
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
            copied_in(vals)
        out[name] = put(arr, vals)
    true = torch.tensor(True, device=dev)
    copied_in(true)
    new_alive = put(alive, true)
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


def split_draws(trainables: TrainableState, generator: torch.Generator):
    """The split's N(0, 1) draws of both blocks, [N, Ns, 3] then [N, No, 3],
    from `generator` (on the parameters' device)."""
    g = trainables.gaussians
    return tuple(torch.randn((SPLIT_N,) + tuple(x.shape), generator=generator,
                             dtype=x.dtype, device=x.device)
                 for x in (g.scene_scaling, g.obj_scaling))


def densify_and_prune(trainables: TrainableState, opt_state: AdamState,
                      state: GaussianState, generator: torch.Generator,
                      max_scene_grad: float, max_obj_grad: float,
                      min_opacity: float, prune_big: bool,
                      scene_extent: float, object_extent: float,
                      percent_dense: float
                      ) -> tuple[TrainableState, AdamState, GaussianState,
                                 DensifyReport]:
    """densify_and_prune with the split's draws from `generator`."""
    eps_scene, eps_obj = split_draws(trainables, generator)
    return densify_and_prune_eps(
        trainables, opt_state, state, eps_scene, eps_obj, max_scene_grad,
        max_obj_grad, min_opacity, prune_big, scene_extent, object_extent,
        percent_dense)


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


def reset_opacity(trainables: TrainableState, opt_state: AdamState
                  ) -> tuple[TrainableState, AdamState]:
    """Clamp every activated opacity to <= 0.01 and zero the opacity Adam
    moments."""
    def new_raw(raw):
        clamped = torch.clamp(torch.sigmoid(raw), max=0.01)
        return torch.log(clamped / (1.0 - clamped))

    g = trainables.gaussians
    g = dataclasses.replace(g, scene_opacity=new_raw(g.scene_opacity),
                            obj_opacity=new_raw(g.obj_opacity))

    def zeroed(moments: GaussianParams) -> GaussianParams:
        return dataclasses.replace(
            moments, scene_opacity=torch.zeros_like(g.scene_opacity),
            obj_opacity=torch.zeros_like(g.obj_opacity))

    return (trainables._replace(gaussians=g),
            opt_state._replace(
                m=opt_state.m._replace(gaussians=zeroed(opt_state.m.gaussians)),
                v=opt_state.v._replace(gaussians=zeroed(opt_state.v.gaussians))))


def _fill_for(name: str, moments: bool) -> float:
    """Dead-slot values: zeros, except (for parameters) an opacity logit of
    -15 and a log-scale of -10; rotations are made identity after."""
    if moments:
        return 0.0
    if name.endswith("opacity"):
        return -15.0
    if name.endswith("scaling"):
        return -10.0
    return 0.0


def _pad(arr: torch.Tensor, extra: int, fill) -> torch.Tensor:
    if extra == 0:
        return arr
    block = torch.full((extra,) + tuple(arr.shape[1:]), fill,
                       dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, block], dim=0)


def grow_capacity(trainables: TrainableState, opt_state: AdamState,
                  state: GaussianState, new_scene_cap: int,
                  new_obj_cap: int):
    """Pad every per-Gaussian block to the new capacities with dead slots
    (identity quaternions, opacity logit -15, log-scale -10, zero moments)
    and reset the densification statistics. The KNN groups and the sky
    are kept as they are. Returns (trainables, opt_state, state)."""
    g = trainables.gaussians
    Ns, No = g.scene_capacity, g.obj_capacity
    ds, do = new_scene_cap - Ns, new_obj_cap - No
    if ds < 0 or do < 0:
        raise ValueError(f"capacity cannot shrink: scene {Ns} -> "
                         f"{new_scene_cap}, obj {No} -> {new_obj_cap}")

    def pad_params(p: GaussianParams, moments: bool) -> GaussianParams:
        kw = {f: _pad(getattr(p, f), ds, _fill_for(f, moments))
              for f in SCENE_FIELDS}
        kw.update({f: _pad(getattr(p, f), do, _fill_for(f, moments))
                   for f in OBJ_FIELDS})
        if not moments:
            # identity quaternions in the new slots (none: an empty slice)
            kw["scene_rotation"][Ns:, 0] = 1.0
            kw["obj_rotation"][No:, 0] = 1.0
        return dataclasses.replace(p, **kw)

    new_g = pad_params(g, moments=False)
    new_m = opt_state.m._replace(gaussians=pad_params(opt_state.m.gaussians,
                                                      moments=True))
    new_v = opt_state.v._replace(gaussians=pad_params(opt_state.v.gaussians,
                                                      moments=True))
    total = new_scene_cap + new_obj_cap
    zeros = dict(dtype=torch.float32, device=state.denom.device)
    new_state = dataclasses.replace(
        state,
        scene_alive=_pad(state.scene_alive, ds, False),
        obj_alive=_pad(state.obj_alive, do, False),
        gs_time=_pad(state.gs_time, do, 0.0),
        max_radii2d=torch.zeros(total, **zeros),
        xyz_grad_accum=torch.zeros(total, **zeros),
        denom=torch.zeros(total, **zeros))
    return (trainables._replace(gaussians=new_g),
            AdamState(m=new_m, v=new_v, count=opt_state.count), new_state)
