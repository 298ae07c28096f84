"""Tile-sharded rendering and training over torch.distributed ranks
(counterpart of adgs_tpu/parallel/shard.py).

The pixel x primitive interaction is partitioned by sharding image TILE
ROWS across the mesh's "tile" axis. Each rank:

  1. deforms + preprocesses its 1/D slice of the Gaussians,
  2. routes per-primitive render payloads to the slabs their rects
     intersect: either an all-gather (every rank bins every primitive) or,
     with primitive_exchange=True, a duplicateWithKeys-style all-to-all
     (rasterizer_impl.cu:70-111) that moves only the intersecting rows,
  3. bins its slab's instances (B2, B1) and composites them (B3; B4 and
     B5 backward), and samples the sky on its slab's rays (B7; B8).

The slab: each rank clips every primitive's tile rect to its own tile
rows of the frame's grid (JAX translates screen space instead, see
_render_local_slab), so binning and compositing are the single-device
ones, unchanged, and a slab's pixels are composited as the single-device
render composites them.

JAX runs this as one SPMD program (shard_map); here every rank runs the
same eager program on its own coordinates, and the collectives of
collectives.py carry JAX's transposes. The loss is one scalar replicated
over the mesh; each rank seeds its backward with 1 / (ranks) (see
collectives.py), and the parameter gradients, every rank's share of
them, cross the ranks as ONE flat all-reduce. Every rank then holds the
same gradients and makes the same Adam update, so the replicated
parameters stay bitwise equal across ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..core.camera import Camera
from ..models.gaussians import (GaussianConfig, activated_scaling,
                                deform, obj_mask)
from ..ops import flow as flow_ops
from ..ops import image as image_ops
from ..raster import binning as binning_lib
from ..raster import preprocess as prep_lib
from ..raster.composite import depth_feature
from ..raster.preprocess import Preprocessed
from ..raster.render import OP_FLOOR, CompositePacked, pack_gaussian_rows
from ..raster.types import TILE_X, TILE_Y, RasterSettings
from ..render import settings_for_camera
from ..train.config import OptimizationConfig
from ..train.losses import FrameBatch, compute_losses, gaussian_term_losses
from ..train.optim import (AdamState, TrainableState, adam_update,
                           from_leaves, leaves, lr_tree)
from ..train.step import LossAndGrads
from . import collectives as cc
from .mesh import Mesh

_SSIM_HALO = 5   # 11x11 window reach


def _render_local_slab(prep: Preprocessed, settings: RasterSettings,
                       rows_per_dev: int, index: int, flow_points, semantic,
                       capacity: int, layout: str):
    """Bin and composite this rank's slab (the counterpart of
    composite_tiles_pallas over JAX's window): tile rows [index *
    rows_per_dev, + rows_per_dev) of the frame, past its last row padded
    as empty tiles. Returns ([rows*TILE_Y, W_pad, CH] slab features,
    [rows*TILE_Y, W_pad] final T, this slab's visibility, num_rendered).

    JAX translates screen space by the slab's origin and renders a local
    grid; that subtraction rounds the mean of a Gaussian centred far off
    the slab, and at 1M Gaussians the rounding flips a handful of 1/255
    gates. Here screen space stays the frame's: each primitive's tile rect
    is clipped to the slab's rows, so the slab's tiles hold the instances,
    keys and pixel coordinates of the single-device render, and the kernels
    see the frame's grid with every other tile empty."""
    gx, gy = settings.grid_x, settings.grid_y
    r0 = index * rows_per_dev
    n_real = max(0, min(rows_per_dev, gy - r0))
    rect_min, rect_max = prep_lib.get_rect(prep.mean2d, prep.extent, gx, gy)
    rect_min = torch.stack([rect_min[:, 0], torch.clamp(
        rect_min[:, 1], r0, r0 + n_real)], dim=-1)
    rect_max = torch.stack([rect_max[:, 0], torch.clamp(
        rect_max[:, 1], r0, r0 + n_real)], dim=-1)
    tiles = ((rect_max[:, 0] - rect_min[:, 0])
             * (rect_max[:, 1] - rect_min[:, 1]))
    visible = prep.visible & (tiles > 0)
    wprep = prep._replace(
        rect_min=rect_min, rect_max=rect_max,
        tiles_touched=torch.where(visible, tiles,
                                  torch.zeros_like(tiles)).to(torch.int32),
        visible=visible)
    with torch.no_grad():
        b = binning_lib.bin_gaussians(wprep, settings, capacity)
    feats = [wprep.rgb, depth_feature(wprep.depth, settings.inv_depth)[:, None]]
    if flow_points is not None:
        feats.append(flow_points)
    if semantic is not None:
        feats.append(semantic)
    features = torch.cat(feats, dim=-1)
    opac = torch.where(wprep.visible, wprep.opacity,
                       torch.zeros_like(wprep.opacity))
    log_op = torch.log(torch.clamp(opac, min=OP_FLOOR))
    packed, _ = pack_gaussian_rows(wprep.mean2d, wprep.conic, log_op,
                                   features)
    ch = features.shape[-1]
    blended, final_t = CompositePacked.apply(packed, b, ch, gx, layout)
    blended = blended.reshape(gy, gx, ch, TILE_Y * TILE_X)[r0:r0 + n_real]
    final_t = final_t.reshape(gy, gx, TILE_Y * TILE_X)[r0:r0 + n_real]
    pad = rows_per_dev - n_real
    if pad:
        # tile rows past the frame: empty tiles (nothing blended, T = 1)
        blended = torch.cat([blended, blended.new_zeros(
            (pad,) + tuple(blended.shape[1:]))])
        final_t = torch.cat([final_t, final_t.new_ones(
            (pad,) + tuple(final_t.shape[1:]))])
    rows = rows_per_dev
    slab = blended.permute(0, 1, 3, 2).reshape(rows, gx, TILE_Y, TILE_X, ch)
    slab = slab.permute(0, 2, 1, 3, 4).reshape(rows * TILE_Y, gx * TILE_X, ch)
    t = final_t.reshape(rows, gx, TILE_Y, TILE_X).permute(0, 2, 1, 3)
    t = t.reshape(rows * TILE_Y, gx * TILE_X)
    return slab, t, visible, b.num_rendered


def _slice_gaussian_axis(tree, d: int, D: int, scene_cap: int,
                         obj_cap: int):
    """This rank's 1/D block of every per-Gaussian leading axis of a
    tensor or a dataclass of tensors. Leaves whose leading dim matches
    neither block size (e.g. the shared background trajectory) stay
    whole."""
    def f(x):
        if not torch.is_tensor(x) or x.dim() == 0:
            return x
        n = x.shape[0]
        if n == scene_cap or n == obj_cap:
            per = n // D
            return x[d * per:(d + 1) * per]
        if n == scene_cap + obj_cap:
            ps, po = scene_cap // D, obj_cap // D
            return torch.cat([x[d * ps:(d + 1) * ps],
                              x[scene_cap + d * po:scene_cap + (d + 1) * po]])
        return x
    if torch.is_tensor(tree):
        return f(tree)
    return dataclasses.replace(tree, **{
        fl.name: f(getattr(tree, fl.name))
        for fl in dataclasses.fields(tree)})


def default_exchange_capacity(n_loc: int, D: int) -> int:
    """Initial per-pair exchange capacity: 2x the uniform share
    (overflow-flagged, grown by the trainer when the flag fires)."""
    return max(64, -(-2 * n_loc // D) // 8 * 8)


# columns of a primitive's render payload (the exchange's row layout):
# mean2d 0:2, conic 2:5, depth 5, rgb 6:9, opacity 9, extent 10:12,
# visible 12, then the flow points (3) and the object mask (1) if present
_VIS = 12


def _payload(prep: Preprocessed, flow, sem) -> torch.Tensor:
    cols = [prep.mean2d, prep.conic, prep.depth[:, None], prep.rgb,
            prep.opacity[:, None], prep.extent,
            prep.visible.to(torch.float32)[:, None]]
    if flow is not None:
        cols.append(flow)
    if sem is not None:
        cols.append(sem)
    return torch.cat(cols, dim=-1)


def _unpayload(rows: torch.Tensor, has_flow: bool, has_sem: bool,
               radii: Optional[torch.Tensor] = None):
    """(Preprocessed, flow points, semantic) of payload rows; the slab
    render recomputes the rects, so they stay zero here."""
    nr = rows.shape[0]
    zi = torch.zeros((nr, 2), dtype=torch.int32, device=rows.device)
    prep = Preprocessed(
        mean2d=rows[:, 0:2], depth=rows[:, 5], conic=rows[:, 2:5],
        opacity=rows[:, 9], rgb=rows[:, 6:9],
        radii=rows.new_zeros(nr) if radii is None else radii,
        extent=rows[:, 10:12], rect_min=zi, rect_max=zi,
        tiles_touched=torch.zeros(nr, dtype=torch.int32, device=rows.device),
        visible=rows[:, _VIS] > 0.5)
    c = _VIS + 1
    flow = sem = None
    if has_flow:
        flow = rows[:, c:c + 3]
        c += 3
    if has_sem:
        sem = rows[:, c:c + 1]
    return prep, flow, sem


def _exchange_primitives(payload: torch.Tensor, dev_lo: torch.Tensor,
                         dev_hi: torch.Tensor, D: int, group,
                         cap_pair: int):
    """duplicateWithKeys across the ranks: each rank sends each of its
    primitives ONLY to the ranks whose tile-row slab its rect intersects,
    as one all-to-all with a fixed per-pair capacity.

    payload: [n_loc, F]; dev_lo/dev_hi: [n_loc] inclusive destination
    range (lo > hi = send nowhere). Returns ([D * cap_pair, F] received
    rows, overflow flag over the group). Unfilled slots stay exactly zero,
    so the payload's visible column doubles as the slot-valid mask. A row
    sent to several slabs is scattered once per destination; the
    scatters' backward sums the destinations' cotangents."""
    n, F = payload.shape
    e_rng = torch.arange(D, dtype=torch.int32, device=payload.device)
    m = (dev_lo[:, None] <= e_rng) & (e_rng <= dev_hi[:, None])   # [n, D]
    pos = torch.cumsum(m.to(torch.int32), dim=0) - 1    # slot within bucket
    counts = 1 + pos[-1]                                # [D]
    dest = torch.where(m & (pos < cap_pair), e_rng * cap_pair + pos,
                       torch.full_like(pos, D * cap_pair)).long()
    send = payload.new_zeros((D * cap_pair + 1, F))
    for e in range(D):
        # disjoint bucket regions; the rows a destination does not take
        # share the sink row, which is cut off below
        send = send.index_put((dest[:, e],), payload)
    recv = cc.all_to_all(send[:D * cap_pair], group)
    overflow = (counts.max() > cap_pair).to(torch.int32).reshape(1)
    return recv, cc.pmax(overflow, group)[0] > 0


def _frame_order(rows: torch.Tensor, D: int, cap_pair: int, ns_loc: int,
                 ns: int, no_loc: int) -> torch.Tensor:
    """The received rows, their last column (the sender's local index)
    dropped, the valid ones first in the frame's Gaussian order: rank e's
    local row i is Gaussian e * ns_loc + i of the scene block, or ns + e *
    no_loc + (i - ns_loc) of the object block. The binning's stable sort
    then breaks depth ties as the single-device render does (the depth key
    keeps ~21 bits at 1,872 tiles, so ties are common), and each tile
    composites its instances in the same order."""
    src = torch.arange(D, device=rows.device).repeat_interleave(cap_pair)
    loc = rows[:, -1].to(torch.int64)
    glob = torch.where(loc < ns_loc, src * ns_loc + loc,
                       ns + src * no_loc + (loc - ns_loc))
    key = torch.where(rows[:, _VIS] > 0.5, glob,
                      torch.full_like(glob, ns + D * no_loc))
    return rows[torch.argsort(key, stable=True), :-1]


def _device_render(params, state, screen_offset, *, config, settings, time,
                   flow_time, render_objmask, mesh: Mesh, axis: str,
                   rows_per_dev, capacity, layout, can_shard_prims,
                   primitive_exchange, exchange_capacity,
                   gather_pkg: bool = True):
    """This rank's render: deform + preprocess the local 1/D primitive
    slice, route payloads (all-gather or exchange), bin + composite the
    local tile-row slab.

    Returns (slab [rows*TY, W_pad, CH], t [rows*TY, W_pad], visible [N],
    radii [N], pkg|None, exchange overflow, num_rendered of the slab)."""
    group = mesh.group(axis)
    D, d = mesh.shape[axis], mesh.coords[axis]
    has_flow, has_sem = flow_time is not None, render_objmask
    no_overflow = torch.zeros((), dtype=torch.bool,
                              device=params.scene_xyz.device)
    if can_shard_prims:
        ns, no = params.scene_capacity, params.obj_capacity
        p_loc = _slice_gaussian_axis(params, d, D, ns, no)
        s_loc = _slice_gaussian_axis(state, d, D, ns, no)
        so_loc = _slice_gaussian_axis(screen_offset, d, D, ns, no)
        pkg_loc, flow_loc = deform(p_loc, s_loc, config, time, flow_time)
        sem_loc = obj_mask(p_loc).to(torch.float32)[:, None] if has_sem \
            else None
        prep_loc = prep_lib.preprocess(
            pkg_loc["xyz"], activated_scaling(p_loc), pkg_loc["rotation"],
            pkg_loc["opacity"], pkg_loc["shs"], settings,
            screen_offset=so_loc, active_mask=s_loc.alive)
        ns_loc = ns // D

        def order(g):
            # [D, n/D, ...] rank blocks -> the full [Ns + No, ...] order
            tail = tuple(g.shape[2:])
            return torch.cat([g[:, :ns_loc].reshape((-1,) + tail),
                              g[:, ns_loc:].reshape((-1,) + tail)])

        pkg = None
        if gather_pkg:
            # the small global-need fields, one gather for all of them
            flat = [pkg_loc[k].reshape(pkg_loc[k].shape[0], -1)
                    for k in sorted(pkg_loc)]
            full = order(cc.all_gather(torch.cat(flat, dim=-1), group))
            pkg, c = {}, 0
            for k, x in zip(sorted(pkg_loc), flat):
                w = x.shape[1]
                pkg[k] = full[:, c:c + w].reshape(
                    (-1,) + tuple(pkg_loc[k].shape[1:]))
                c += w
        radii_full = order(cc.gather_nograd(prep_loc.radii, group))
        payload = _payload(prep_loc, flow_loc, sem_loc)

        if primitive_exchange:
            # route each primitive's RENDER payload only to the slabs its
            # rect intersects
            cap_pair = (exchange_capacity
                        or default_exchange_capacity(payload.shape[0], D))
            rlo = prep_loc.rect_min[:, 1] // rows_per_dev
            rhi = torch.clamp((prep_loc.rect_max[:, 1] - 1) // rows_per_dev,
                              0, D - 1)
            vis0 = prep_loc.visible
            dev_lo = torch.where(vis0, rlo, torch.ones_like(rlo))
            dev_hi = torch.where(vis0, rhi, torch.zeros_like(rhi))
            n_loc = payload.shape[0]
            if n_loc >= 1 << 24:
                raise ValueError(f"{n_loc} Gaussians a rank: the exchange "
                                 "carries their index as float32")
            local = torch.arange(n_loc, dtype=torch.float32,
                                 device=payload.device)[:, None]
            rows, ex_overflow = _exchange_primitives(
                torch.cat([payload, local], dim=-1), dev_lo.to(torch.int32),
                dev_hi.to(torch.int32), D, group, cap_pair)
            rows = _frame_order(rows, D, cap_pair, ns_loc, ns, no // D)
            prep, flow_points, semantic = _unpayload(rows, has_flow, has_sem)
            slab, t, _, nrend = _render_local_slab(
                prep, settings, rows_per_dev, d, flow_points, semantic,
                capacity, layout)
            return (slab, t, radii_full > 0, radii_full, pkg, ex_overflow,
                    nrend)

        prep, flow_points, semantic = _unpayload(
            order(cc.all_gather(payload, group)), has_flow, has_sem,
            radii_full)
    else:
        pkg, flow_points = deform(params, state, config, time, flow_time)
        semantic = obj_mask(params).to(torch.float32)[:, None] if has_sem \
            else None
        prep = prep_lib.preprocess(
            pkg["xyz"], activated_scaling(params), pkg["rotation"],
            pkg["opacity"], pkg["shs"], settings,
            screen_offset=screen_offset, active_mask=state.alive)
        if not gather_pkg:
            pkg = None
    slab, t, visible, nrend = _render_local_slab(
        prep, settings, rows_per_dev, d, flow_points, semantic, capacity,
        layout)
    # visible anywhere -> visible (for the densification statistics)
    vis = visible.to(torch.int32)
    dist.all_reduce(vis, group=group)
    return slab, t, vis > 0, prep.radii, pkg, no_overflow, nrend


def _can_shard_prims(params, D: int) -> bool:
    return params.scene_capacity % D == 0 and params.obj_capacity % D == 0


def sharded_render_images(
    params, state, config: GaussianConfig, camera: Camera, mesh: Mesh,
    axis: str = "tile", env_map=None, cam_rays=None, flow_time=None,
    render_objmask: bool = False, screen_offset=None,
    active_sh_degree: Optional[int] = None, inv_depth: bool = True,
    capacity: int = 1 << 18, shard_primitives: bool = True,
    primitive_exchange: bool = False,
    exchange_capacity: Optional[int] = None, layout: str = "gather",
    gather_pkg: bool = True) -> dict:
    """The multi-rank render, returning on every rank the dict that
    render() returns. Two sharded axes of work ride the same mesh axis:
    the primitive axis (each rank deforms + preprocesses its 1/D slice of
    the Gaussians) and the pixel axis (each rank bins + composites its
    tile-row slab); the slabs are all-gathered into the full frame.
    Differentiable with the transposes of collectives.py: a loss that
    every rank computes from the output, seeded with 1 / (ranks), gives
    each rank its share of the gradients."""
    sh_degree = (active_sh_degree if active_sh_degree is not None
                 else config.sh_degree)
    settings = settings_for_camera(camera, sh_degree, inv_depth)
    D = mesh.shape[axis]
    group = mesh.group(axis)
    rows_per_dev = -(-settings.grid_y // D)
    if screen_offset is None:
        screen_offset = torch.zeros((params.capacity, 2),
                                    dtype=torch.float32,
                                    device=params.scene_xyz.device)
    slab, t, visible, radii, pkg, ex_overflow, nrend = _device_render(
        params, state, screen_offset, config=config, settings=settings,
        time=camera.time, flow_time=flow_time,
        render_objmask=render_objmask, mesh=mesh, axis=axis,
        rows_per_dev=rows_per_dev, capacity=capacity, layout=layout,
        can_shard_prims=shard_primitives and _can_shard_prims(params, D),
        primitive_exchange=primitive_exchange,
        exchange_capacity=exchange_capacity, gather_pkg=gather_pkg)
    slabs = cc.all_gather(slab, group)          # [D, rows*TY, W_pad, CH]
    ts = cc.all_gather(t, group)
    nrend = cc.pmax(nrend.reshape(1), group)[0]

    H, W = settings.image_height, settings.image_width
    ch = slabs.shape[-1]
    full = slabs.reshape(-1, slabs.shape[-2], ch)[:H, :W]   # [H, W, CH]
    t_full = ts.reshape(-1, ts.shape[-1])[:H, :W]
    color = full[..., :3].permute(2, 0, 1)
    chc = 4
    img_flow = img_sem = None
    if flow_time is not None:
        img_flow = full[..., chc:chc + 3].permute(2, 0, 1)
        chc += 3
    if render_objmask:
        img_sem = full[..., chc:chc + 1].permute(2, 0, 1)
    opacity = 1.0 - t_full
    if env_map is not None and cam_rays is not None:
        background = env_map.image_background(cam_rays, camera.world_view)
        rendered = color + (1.0 - opacity)[None] * background
    else:
        background = torch.zeros_like(color)
        rendered = color
    return {
        "render": rendered, "foreground": color, "background": background,
        "depth": full[..., 3], "img_opacity": opacity, "img_flow": img_flow,
        "img_semantic": img_sem, "radii": radii,
        "visibility_filter": radii > 0,
        # True when the fixed per-pair exchange capacity dropped rows:
        # the caller grows exchange_capacity (always False on the
        # all-gather path)
        "exchange_overflow": ex_overflow,
        # max over ranks: drives the trainer's instance-capacity sizing
        "num_rendered": nrend,
        **(pkg or {}),
    }


def sharded_render_color(params, state, config, camera, mesh, **kw):
    return sharded_render_images(params, state, config, camera, mesh,
                                 **kw)["render"]


def _slab_image_losses(rendered, depth_s, opac_s, flow_img_s, sem_s,
                       batch_sl: FrameBatch, opt: OptimizationConfig,
                       scene_extent: float, group, H: int, W: int,
                       row0: int):
    """Every image-loss term from this rank's slab: pixel-local terms as
    psum'd sums, SSIM through a halo exchange, the depth scale/shift
    alignment through psum'd normal-equation moments. Returns (total,
    logs), the same scalars on every rank of the group, matching
    train.losses.compute_losses up to f32 reassociation of the sums.

    The data-independent sums ride ONE stacked psum (the per-term
    summation order, and so every value, is unchanged); only the depth
    alignment needs a second (its residual depends on the first's
    moments). The halo moves rendered and ground truth in one exchange.
    rendered: [3, rows, W]; depth/opac: [rows, W]; batch_sl: this rank's
    rows (zero past the image height H)."""
    rows = rendered.shape[1]
    rmask = ((row0 + torch.arange(rows, device=rendered.device)) < H
             ).to(torch.float32)
    m1 = rmask[None, :, None]
    m2 = rmask[:, None]
    npx = float(H * W)
    logs = {}

    gt = batch_sl.image
    part = [torch.sum(torch.abs(rendered - gt) * m1)]          # l1
    # the end ranks' halos are zeros: the full image's SAME zero padding,
    # so halo + crop is value-identical to the full-image SSIM
    both_h = cc.halo_rows(torch.cat([rendered * m1, gt * m1], dim=0),
                          _SSIM_HALO, group, row_axis=1)
    smap = image_ops.ssim_map(both_h[:3], both_h[3:]
                              )[0][:, _SSIM_HALO:-_SSIM_HALO]
    part.append(torch.sum(smap * m1))                          # ssim

    use_depth = opt.lambda_depth > 0.0
    if use_depth:
        pred, targ = depth_s, batch_sl.depth
        mask = torch.broadcast_to(m2, pred.shape)
        part += [torch.sum(mask * pred * pred), torch.sum(mask * pred),
                 torch.sum(mask), torch.sum(mask * pred * targ),
                 torch.sum(mask * targ)]
    use_flow = opt.lambda_flow > 0.0 and batch_sl.flow is not None
    if use_flow:
        fpk = batch_sl.flow
        err_sum, count = flow_ops.flow_loss_sums(
            flow_img_s, fpk.flow, fpk.vis, fpk.K, fpk.R, fpk.T, opac_s,
            dist=scene_extent * 1e-3, full_hw=(H, W),
            pix_mask=torch.broadcast_to(m2, fpk.vis.shape))
        part += [err_sum, count.to(torch.float32)]
    use_obj = opt.lambda_obj > 0.0
    if use_obj:
        predo = torch.clamp(sem_s[0], 1e-3, 1.0 - 1e-3)
        t_ob = (batch_sl.semantic > 0).to(torch.float32)
        part.append(-torch.sum((t_ob * torch.log(predo)
                                + (1 - t_ob) * torch.log(1 - predo)) * m2))
    use_sky = opt.lambda_sky > 0.0
    if use_sky:
        preds = 1.0 - torch.clamp(opac_s, 1e-3, 1.0 - 1e-3)
        part.append(-torch.sum((batch_sl.sky * torch.log(preds)
                                + (1 - batch_sl.sky)
                                * torch.log(1 - preds)) * m2))

    S = cc.psum(torch.stack(part), group)
    it = iter(S.unbind(0))

    l1 = next(it) / (3.0 * npx)
    logs["l1_loss"] = l1
    dssim = 1.0 - next(it) / (3.0 * npx)
    logs["dssim_loss"] = dssim
    total = ((1.0 - opt.lambda_dssim) * opt.lambda_l1 * l1
             + opt.lambda_dssim * dssim)

    if use_depth:
        a00, a01, a11, b0, b1 = (next(it) for _ in range(5))
        det = a00 * a11 - a01 * a01
        zero = torch.zeros_like(det)
        safe = torch.where(det == 0.0, torch.ones_like(det), det)
        scale = torch.where(det == 0.0, zero, (a11 * b0 - a01 * b1) / safe)
        shift = torch.where(det == 0.0, zero, (-a01 * b0 + a00 * b1) / safe)
        sums = cc.psum(torch.stack([
            torch.sum(torch.abs(scale * pred + shift - targ) * mask),
            torch.sum(mask)]), group)
        dl = sums[0] / torch.clamp(sums[1], min=1.0)
        total = total + opt.lambda_depth * dl
        logs["depth_loss"] = dl

    if use_flow:
        fsum, fcnt = next(it), next(it)
        fl = torch.where(fcnt > 0, fsum / torch.clamp(fcnt, min=1.0),
                         torch.zeros_like(fsum))
        if batch_sl.flow_valid is not None:
            fl = torch.where(batch_sl.flow_valid, fl, torch.zeros_like(fl))
        total = total + opt.lambda_flow * fl
        logs["flow_loss"] = fl

    if use_obj:
        ob = next(it) / npx
        total = total + opt.lambda_obj * ob
        logs["obj_loss"] = ob

    if use_sky:
        sk = next(it) / npx
        total = total + opt.lambda_sky * sk
        logs["sky_loss"] = sk

    return total, logs


def _shard_axis(x: torch.Tensor, n: int) -> Optional[int]:
    """The first axis that splits into n equal slices of at least one."""
    for i, s in enumerate(x.shape):
        if s >= n and s % n == 0:
            return i
    return None


def sharded_adam_update(trainables: TrainableState, grads: TrainableState,
                        opt_state: AdamState, lrs: TrainableState,
                        mesh: Mesh) -> tuple[TrainableState, AdamState]:
    """ZeRO-style optimizer sharding: every rank updates a 1/W slice of
    each leaf (W ranks in all; the slice along the first axis that W
    divides: the Gaussian capacity for the parameters, a row axis of the
    sky grid), and one all-gather reassembles the updated parameters and
    moments. Indivisible leaves (scalars, tiny vectors) are updated whole
    on every rank. Adam is elementwise, so the result is bitwise
    adam_update's."""
    W, r = mesh.size, mesh.rank
    groups = [leaves(trainables), leaves(grads), leaves(opt_state.m),
              leaves(opt_state.v)]
    axes = [_shard_axis(p, W) for p in groups[0]]

    def part(x, i):
        if i is None:
            return x
        per = x.shape[i] // W
        # contiguous for Adam's kernel: the sky's slices (axis 1) are not
        return x.narrow(i, r * per, per).contiguous()

    sliced = [from_leaves(trainables, [part(x, i) for x, i in zip(g, axes)])
              for g in groups]
    new_t, new_s = adam_update(
        sliced[0], sliced[1],
        AdamState(m=sliced[2], v=sliced[3], count=opt_state.count), lrs)
    outs = [leaves(new_t), leaves(new_s.m), leaves(new_s.v)]
    flat = [x.reshape(-1) for out in outs
            for x, i in zip(out, axes) if i is not None]
    got = (cc.gather_nograd(torch.cat(flat), dist.group.WORLD)
           if flat else None)
    full, off = [], 0
    for out in outs:
        res = []
        for x, i in zip(out, axes):
            if i is None:
                res.append(x)
                continue
            n = x.numel()
            blocks = got[:, off:off + n].reshape((W,) + tuple(x.shape))
            res.append(torch.cat(list(blocks.unbind(0)), dim=i))
            off += n
        full.append(from_leaves(trainables, res))
    return full[0], AdamState(m=full[1], v=full[2], count=new_s.count)


def allreduce_flat(tensors: list, group=None) -> list:
    """Sum each tensor over the group's ranks with ONE all-reduce of their
    concatenation (the collective diet of JAX's packed trainables)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def select_camera(tree, b: int):
    """Camera, FrameBatch (with its FlowPackage) or tensor b of a stack
    (data_parallel.stack_cameras / stack_batches)."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree[b]
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: select_camera(getattr(tree, f.name), b)
            for f in dataclasses.fields(tree)
            if torch.is_tensor(getattr(tree, f.name))})
    return type(tree)(*[select_camera(x, b) for x in tree])


def _pad_slice(x: torch.Tensor, row_axis: int, H_pad: int, row0: int,
               rows: int) -> torch.Tensor:
    """Rows [row0, row0 + rows) of x zero-padded to H_pad rows."""
    pad = [0, 0] * (x.dim() - row_axis - 1) + [0, H_pad - x.shape[row_axis]]
    return torch.nn.functional.pad(x, pad).narrow(row_axis, row0, rows)


def _stats(state, screen_grad, radii, vis, B: Optional[int]):
    """Densification statistics of one step; with B cameras (leading
    axis), B reference iterations' worth: grad norms and visibility summed,
    radii maxed, dL/dscreen scaled back by B (the camera mean divided
    it)."""
    visf = vis.to(torch.float32)
    zero = torch.zeros_like(visf)
    if B is not None:
        snorm = torch.linalg.vector_norm(screen_grad * B, dim=-1)
        radii_max = torch.amax(torch.where(vis, radii.to(torch.float32),
                                           zero), dim=0)
        grad_acc = torch.sum(snorm * visf, dim=0)
        den_acc = torch.sum(visf, dim=0)
    else:
        snorm = torch.linalg.vector_norm(screen_grad, dim=-1)
        radii_max = torch.where(vis, radii.to(torch.float32), zero)
        grad_acc = snorm * visf
        den_acc = visf
    return dataclasses.replace(
        state, max_radii2d=torch.maximum(state.max_radii2d, radii_max),
        xyz_grad_accum=state.xyz_grad_accum + grad_acc,
        denom=state.denom + den_acc)


def make_sharded_train_step(
    config: GaussianConfig, opt: OptimizationConfig, frame_gap: float,
    scene_extent: float, cameras_extent: float, mesh: Mesh,
    axis: str = "tile", capacity: int = 1 << 18, inv_depth: bool = True,
    layout: str = "gather", primitive_exchange: bool = False,
    exchange_capacity: Optional[int] = None, loss_mode: str = "slab",
    data_axis: Optional[str] = None):
    """The multi-rank counterpart of train.step.make_train_step, with its
    call signature: step(params, env, opt_state, state, camera, batch,
    cam_rays, iteration, active_sh_degree=3) -> (params, env, opt_state,
    state, logs); logs also hold num_rendered (max over ranks) and
    exchange_overflow. `step.loss_and_grads` is its differentiable half,
    the all-reduced gradients before Adam, and `step.update(params, env,
    opt_state, state, loss_and_grads's result, iteration)` the rest. The
    trainer swaps it in when it runs on a mesh.

    loss_mode:
      - "slab" (default): the image losses per rank on its tile-row slab:
        SSIM through an 11-px halo exchange, everything else as psum'd
        sufficient statistics; the sky sampled on the slab's rays only;
      - "gathered": all-gather the slabs and run the whole loss stack on
        the full frame on every rank (the parity reference).

    data_axis: camera-batch data parallelism on a 2-D mesh (slab mode
    only): `camera`, `batch` and `cam_rays` carry a leading B axis, B ==
    mesh.shape[data_axis]; each data row trains its camera, the loss is
    the camera mean, and the densification statistics add up like B
    reference iterations."""
    if loss_mode not in ("slab", "gathered"):
        raise ValueError(f"unknown loss_mode {loss_mode!r}")
    if data_axis is not None and loss_mode != "slab":
        raise ValueError("data_axis requires loss_mode='slab'")
    render_objmask = opt.lambda_obj > 0.0
    batched = data_axis is not None
    D = mesh.shape[axis]
    B = mesh.shape[data_axis] if batched else None
    group = mesh.group(axis)

    def slab_loss(tr, so, state, camera, batch, cam_rays, sh):
        cam, batch_b, rays_b, so_b = camera, batch, cam_rays, so
        if batched:
            b = mesh.coords[data_axis]
            cam, batch_b, rays_b, so_b = (select_camera(x, b) for x in
                                          (camera, batch, cam_rays, so))
        H, W = cam.height, cam.width
        grid_y = -(-H // TILE_Y)
        rows_per_dev = -(-grid_y // D)
        rows = rows_per_dev * TILE_Y
        H_pad = D * rows
        row0 = mesh.coords[axis] * rows

        def sl(x, row_axis):
            return _pad_slice(x, row_axis, H_pad, row0, rows)

        has_flow = batch_b.flow is not None
        batch_sl = batch_b._replace(
            image=sl(batch_b.image, 1), depth=sl(batch_b.depth, 0),
            sky=sl(batch_b.sky, 0), semantic=sl(batch_b.semantic, 0),
            flow=None if not has_flow else batch_b.flow._replace(
                flow=sl(batch_b.flow.flow, 1), vis=sl(batch_b.flow.vis, 0)))
        settings = settings_for_camera(cam, sh, inv_depth)
        flow_time = batch_b.flow.time if has_flow else None
        p = tr.gaussians
        slab, t, visible, radii, _, ex_overflow, nrend = _device_render(
            p, state, so_b, config=config, settings=settings, time=cam.time,
            flow_time=flow_time, render_objmask=render_objmask, mesh=mesh,
            axis=axis, rows_per_dev=rows_per_dev, capacity=capacity,
            layout=layout,
            can_shard_prims=_can_shard_prims(p, D),
            primitive_exchange=primitive_exchange,
            exchange_capacity=exchange_capacity, gather_pkg=False)
        color = slab[:, :W, :3].permute(2, 0, 1)              # [3, rows, W]
        depth_s = slab[:, :W, 3]
        chc = 4
        flow_img_s = sem_s = None
        if has_flow:
            flow_img_s = slab[:, :W, chc:chc + 3].permute(2, 0, 1)
            chc += 3
        if render_objmask:
            sem_s = slab[:, :W, chc:chc + 1].permute(2, 0, 1)
        t_s = t[:, :W]
        # the sky on THIS slab's rays only: 1/D of the frame
        bg = tr.env.image_background(sl(rays_b, 0), cam.world_view)
        rendered = color + t_s[None] * bg
        total, logs = _slab_image_losses(
            rendered, depth_s, 1.0 - t_s, flow_img_s, sem_s, batch_sl, opt,
            scene_extent, group, H, W, row0)
        if batched:
            # camera means over the data axis, one psum for the loss and
            # its logs; each data row's statistics gathered by camera
            names = sorted(logs)
            m = cc.psum(torch.stack([total] + [logs[k] for k in names]),
                        mesh.group(data_axis)) / B
            total, logs = m[0], {k: m[i + 1] for i, k in enumerate(names)}
            rv = cc.gather_nograd(torch.stack([radii.to(torch.float32),
                                               visible.to(torch.float32)]),
                                  mesh.group(data_axis))
            radii, visible = rv[:, 0], rv[:, 1] > 0.5
        return total, logs, radii, visible, ex_overflow, nrend

    def gathered_loss(tr, so, state, camera, batch, cam_rays, sh):
        flow_time = batch.flow.time if batch.flow is not None else None
        pkg = sharded_render_images(
            tr.gaussians, state, config, camera, mesh, axis, env_map=tr.env,
            cam_rays=cam_rays, flow_time=flow_time,
            render_objmask=render_objmask, screen_offset=so,
            active_sh_degree=sh, inv_depth=inv_depth, capacity=capacity,
            primitive_exchange=primitive_exchange,
            exchange_capacity=exchange_capacity, layout=layout,
            gather_pkg=False)
        total, logs = compute_losses(pkg, batch, tr.gaussians, state, config,
                                     opt, frame_gap, scene_extent)
        return (total, logs, pkg["radii"], pkg["visibility_filter"],
                pkg["exchange_overflow"], pkg["num_rendered"])

    def loss_and_grads(params, env, state, camera, batch, cam_rays,
                       active_sh_degree: int = 3) -> LossAndGrads:
        dev = params.scene_xyz.device
        trainables = TrainableState(gaussians=params, env=env)
        inputs = [x.detach().requires_grad_(True) for x in leaves(trainables)]
        tr = from_leaves(trainables, inputs)
        so = torch.zeros(((B,) if batched else ()) + (params.capacity, 2),
                         dtype=torch.float32, device=dev, requires_grad=True)
        if loss_mode == "slab":
            total, logs, radii, vis, exo, nrend = slab_loss(
                tr, so, state, camera, batch, cam_rays, active_sh_degree)
            # the image-free terms, replicated like the parameters
            g_total, g_logs = gaussian_term_losses(tr.gaussians, state, opt,
                                                   frame_gap)
            total = total + g_total
            logs = dict(logs, **g_logs, total_loss=total)
        else:
            total, logs, radii, vis, exo, nrend = gathered_loss(
                tr, so, state, camera, batch, cam_rays, active_sh_degree)
        # the loss is one scalar held by every rank: seed 1 / ranks, and
        # the one flat all-reduce sums the ranks' shares
        grads = torch.autograd.grad(total * (1.0 / mesh.size), inputs + [so],
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs + [so], grads)]
        grads = allreduce_flat(grads)
        # each rank's slab count in a slot of its own, so that one max
        # over the ranks gives the largest slab's and every slab's
        flags = torch.zeros(mesh.size + 1, dtype=torch.int32, device=dev)
        flags[mesh.rank] = nrend.reshape(()).to(torch.int32)
        flags[-1] = exo.to(torch.int32)
        flags = cc.pmax(flags, dist.group.WORLD)
        logs = {k: v.detach() for k, v in logs.items()}
        logs["exchange_overflow"] = flags[-1] > 0
        if loss_mode == "slab":
            # the step's splat instances: every camera's slabs (the
            # gathered path's counts are already the largest slab's)
            logs["splat_instances"] = flags[:-1].sum()
        return LossAndGrads(
            logs=logs, grads=from_leaves(trainables, grads[:-1]),
            screen_grad=grads[-1], radii=radii, visibility=vis,
            num_rendered=flags[:-1].max())

    @torch.no_grad()
    def update(params, env, opt_state, state, out: LossAndGrads, iteration):
        lrs = lr_tree(opt, scene_extent, cameras_extent, iteration)
        new_tr, new_opt_state = sharded_adam_update(
            TrainableState(gaussians=params, env=env), out.grads, opt_state,
            lrs, mesh)
        new_state = _stats(state, out.screen_grad, out.radii, out.visibility,
                           B)
        return new_tr.gaussians, new_tr.env, new_opt_state, new_state

    def step(params, env, opt_state, state, camera, batch, cam_rays,
             iteration, active_sh_degree: int = 3):
        out = loss_and_grads(params, env, state, camera, batch, cam_rays,
                             active_sh_degree)
        params, env, opt_state, state = update(params, env, opt_state, state,
                                               out, iteration)
        logs = dict(out.logs, num_rendered=out.num_rendered)
        return params, env, opt_state, state, logs

    step.loss_and_grads = loss_and_grads
    step.update = update
    return step
