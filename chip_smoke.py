#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adgs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero before the last line is printed):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles every kernel of csrc/ (one nvcc per source, in
     parallel) and prints the build seconds and ptxas resource use;
  3. scene: the KITTI-75 model at full width (~1M Gaussians, 30% object
     Gaussians, log-scales shrunk by log(0.3)), a 1242x375 frame and a
     3x8192x8192 sky grid, all made from --seed; for training also the
     frame batch of bench.py's protocol and KNN groups (obj_capacity // 8
     anchors of 8, the port's exact ops/knn over the alive object
     Gaussians);
  4. the serving path: 8 requests through make_staged_render_fn
     (two camera poses, times spread over [0, 1]) with the launch counts
     reset just before; every output finite, no overflow, every serving
     kernel launched; one frame held to the "torch" backend at 1e-4;
  5. cli.render: the full-width model saved as a checkpoint (save_ply,
     env.npy, cfg_args.json) beside a 1242x375 KITTI-format scene, then
     adgs_tpu_torch.cli.render.main over both splits once per layout,
     launch counts reset before each: B1, B2, B3, B7 in both, B6 only
     under ADGS_RM=1; PNGs bitwise equal across layouts, PSNR and SSIM
     finite and equal; each layout's FPS;
  6. serving in both layouts in turns (gather, rows, ...), AB_ROUNDS
     turns of 8 requests each;
  7. the training path: 6 steps of make_train_step at full width
     (OptimizationConfig() defaults, every loss term on, SH degree 3,
     iteration 1000) with the launch counts reset just before; losses
     finite, no overflow, all seven kernels launched; one step held to
     the "torch" backend (logs 1e-4, gradients rtol 5e-3 atol 2e-5,
     updated parameters as tests/test_torch_train.py, statistics); one
     step run twice from the same inputs, and one step in the rows
     layout, every updated tensor bitwise equal to the first;
  8. training in both layouts in turns, AB_ROUNDS turns of 3 steps;
  9. the trainer: adgs_tpu_torch.cli.train on a KITTI-format scene
     (1242x375, KITTI P2's focal, the two poses, 10 frames: 8 train, 2
     test) whose reader leaves ~1M Gaussians (~30% object: 700,000 scene
     points on distinct 0.5-unit voxels, 3,000,000 object points of which
     it keeps 10%), with configs/kitti-75.py at SH degree 3, the
     3x8192x8192 sky, every loss term, ModelConfig's instance capacity
     and 40 iterations (densify every 10 from 0, opacity reset every 20,
     KNN refresh every 5); launch counts reset just before: every loss
     finite, all seven training kernels launched, an instance-capacity
     growth by the overflow guard, a Gaussian-capacity growth, clones and
     splits; each densify's alive counts add up (before + cloned + split
     - split sources - pruned = after) and its new slots' moments are
     zero; after each opacity reset every alive opacity is <= 0.01 and
     its moments zero; after each KNN refresh every valid group holds
     alive object slots and min(a_cap, alive // K) groups are valid (on
     one, recall of the exact KNN logged); test frame 0 at full SH degree
     in memory and by cli.render on the checkpoint within 1/255; seconds
     per part, ms/step, device ms of each densify, reset, refresh and
     growth, peak memory;
10. the quality gate: adgs_tpu_torch.scripts.quality_gate at the JAX
     gate's defaults (a 256x160 KITTI-format scene of 16 stereo
     timestamps whose images are plain-PyTorch renders of 6,000 known
     Gaussians, 3,000 init points, the 3x512x512 sky, 2,000 iterations,
     evaluations every 250) under the trainer's checks and timers, launch
     counts reset just before: every loss finite, all seven training
     kernels launched,
     the JAX gate's assertions (every PSNR finite, the test curve
     monotone within 0.5 dB, a gain of at least 4 dB, a final test PSNR
     of at least 22 dB); the curve printed beside the TPU's
     (QUALITY_r05.json); seconds per part, ms/step, each densify's report
     and alive counts, each capacity growth, the ground-truth renders'
     largest num_rendered against their capacity; then, on the trained
     model and training frame 0, B3 (ch=4 and ch=8, 1e-4, final T bitwise
     its serial replay) and B4 (rtol 1e-3, atol 1e-5 max|twin|, into
     buffers of NaN, tile order and zero rows bitwise) on the 160-tile
     frame, B7 (bitwise) and B8 (as in phase 11) on the 3x512x512 sky at
     the frame's coords and the extra coordinate fields, each also at
     C = 1;
11. kernel parity at the slices' shapes, each kernel against its plain
     PyTorch twin on the same inputs: B2 live compaction and B1 expansion
     bitwise (B1 also at a capacity below num_rendered), B3 compositing
     1e-4 at ch=4 and ch=8 (on the served frame, and at ch=8 on the
     training step's inputs) and its final T bitwise its serial replay
     (render.py composite_final_t_serial: a single wrongly culled pair
     fails it at any T; its quarter culling's share logged from its
     rendition), B7 sky sample bitwise
     (a served frame's coords, off-grid and NaN coords, and C=1); on the
     training step's inputs with N(0,1) cotangents, B4 compositing
     backward (rtol 1e-3, atol 1e-5 max|twin|, written into a buffer
     of NaN, the rows past the valid instances bitwise zero; its tile
     order bitwise against a stable sort of the counts; the tiles'
     instance counts logged: mean, p99, max, and the whole-tile exits;
     and, with every opacity at 0.99 and every splat 8x wider, its
     whole-tile exit: every row written, those past the exit zeros, both
     layouts bitwise; there B3 finite, final T in [1e-4, 1] and bitwise
     its serial replay, both layouts bitwise),
     B5 segment sum on B4's rows and on the KNN gather's sorted rows,
     and B8 sky scatter (1e-6
     of max|twin| of the scatter twin, bitwise against the rendition of
     its own order and a second launch; also on off-grid/NaN coords, on
     taps across the last column, on bases at x0 = -1 and y0 = -1, and at
     C = 1; its device time logged by part beside F.grid_sample's
     gradient); B5 also on synthetic bounds (a 100,000-row segment,
     all segments empty, bounds[0] > 0 with bounds[n] < R; D in 1, 3,
     16, 33, 98), each case launched twice and bitwise equal; in the rows
     instance layout (ADGS_RM=1), B6 lane pad bitwise against its twin
     and F.pad, B3 and B4 bitwise against their gather layout. This
     phase and the next run after the timed paths, so that their
     profiler sessions and allocations do not reach the timed steps;
 12. the lab: E1 and E2 (every variant of exp/lab_rowmajor.py) against
     their twins at 1e-5 of max|twin|, E1 also at one chunk a program
     over a program count that is not a multiple of 8, then the ported
     lab at its defaults with the launch counts reset just before;
 13. times with CUDA events: ms per frame and per training step and ms
     per stage, all read from events recorded inside the requests and
     steps themselves, peak device memory, a torch.profiler view of one
     request and one step (top device ops, device busy share), and one
     JSON line ({"kernels": [...]}) with each kernel's launches on its
     path (training; B3 at ch=4 on serving, B6 and the rows B3 on
     cli.render's rows run, the rows B4 on the rows training steps, E1/E2
     in the lab) and on the quality gate ("gate_launches"), its time by
     CUDA events over calls enqueued back to back and its device time per
     call (torch.profiler, a few calls), its plain twin's time, its bound
     and, where one PyTorch call computes the same function, that call's
     two times.
14. scene preparation: a street of known geometry (ground, facades, end
     walls, four car-sized boxes, one moving; dot-textured so that feature
     centres are 3D points) written as a raw KITTI-MOT tracking layout
     (28 stereo timestamps of 1242x375 PNGs at KITTI P2's focal, velodyne
     sweeps of 120,000 returns, OXTS, calib) and as a Waymo segment (20
     packed frames: a 64x2650 TOP range image swept over 0.1 s with its
     per-pixel poses, a 1920x1280 FRONT JPEG), then the port's chain on the
     card: convert_kitti --use_color, pseudo labels from the ground truth
     (import_semantic_masks, import_depth_maps, package_scene_flow),
     segment_pcd, triangulate --window 4, validate_scene, cli.train -c
     configs/kitti-75.py for 20 iterations, and convert_waymo --use_color
     --use_depth. The first calls of each stage function are kept and
     replayed by the port on the CPU: integer, boolean, id and depth-map
     outputs bitwise, float32 within one float32 ulp, float64 within 1e-9
     relative (DLT points on the tracks whose eigenvalue gap fixes them),
     match sets equal but for queries within 1e-5 of the ratio cut
     (counted); convert_kitti's and triangulate's whole runs on the CPU,
     timed beside the card's, their files compared; every checked LiDAR
     point tagged with its own box's id; 90% of the triangulated static
     points within 0.1 m of the street; every Waymo point within 0.01 m of
     it; every cli.train loss finite; seconds per stage, counts.
Phases 3-14 are `run(device, seed)`, which a CPU rehearsal can call at a
small size with host-side stand-ins for the CUDA timers.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

# KITTI-75 preset (configs/kitti-75.py order_args)
KITTI_75 = dict(xyz=[None, 5, 0, 6, 0, 0], rotation=[0, 0, 0, 0, None, 5],
                shs=[0, 0, 0, 6, 0, 0], background=[None, 5, 0, 6, 0, 0])
FRAME_NUM = 60
WIDTH, HEIGHT = 1242, 375
FOCAL = 721.5377          # KITTI P2 focal length (px)
N_GAUSS = 1_000_000
ENV_RES = 8192
FRAMES = 8                # requests served on the serving path
STEPS = 6                 # training steps on the training path
AB_ROUNDS = 3             # turns of each layout in the layout A/B
ITERATION = 1000          # the step's iteration (bench.py's protocol)
SCENE_EXTENT, CAMERAS_EXTENT = 20.0, 10.0   # bench.py's step arguments
TRAIN_TIME = 0.5          # the training camera's time
CAP_HEADROOM = 0.92       # instance capacity = num_rendered / 0.92
HBM_BYTES_S = 3.35e12     # H100 SXM memory rate
FP32_FLOP_S = 67e12       # H100 SXM f32 rate outside the tensor cores
# f32 operations of a gated (instance, pixel) pair in B3 and B4: dx, dy,
# power (9) and the power > 0 test; the exp and 1/255 test that some of
# them also take are left out, so the bound stays a lower bound
GATED_PAIR_OPS = 12
# camera +z -> world +x: a horizon-looking pose (the sky on the equator)
HORIZON = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)

KERNELS = {
    "compact_live": dict(id="B2", source="adgs_tpu_torch/csrc/compact.cu",
                         replaces="adgs_tpu/raster/pallas/expand.py:309"),
    "expand": dict(id="B1", source="adgs_tpu_torch/csrc/expand.cu",
                   replaces="adgs_tpu/raster/pallas/expand.py:81"),
    "composite_fwd": dict(id="B3", source="adgs_tpu_torch/csrc/composite.cu",
                          replaces="adgs_tpu/raster/pallas/render.py:555"),
    "composite_bwd": dict(id="B4",
                          source="adgs_tpu_torch/csrc/composite_bwd.cu",
                          replaces="adgs_tpu/raster/pallas/render.py:642"),
    "segment_sum": dict(id="B5", source="adgs_tpu_torch/csrc/segment_sum.cu",
                        replaces="adgs_tpu/raster/pallas/render.py:850"),
    "grid_sample": dict(id="B7", source="adgs_tpu_torch/csrc/grid_sample.cu",
                        replaces="adgs_tpu/ops/grid_sample.py:192"),
    "grid_sample_bwd": dict(id="B8",
                            source="adgs_tpu_torch/csrc/grid_sample_bwd.cu",
                            replaces="adgs_tpu/ops/grid_sample.py:233"),
    "pad_lanes": dict(id="B6", source="adgs_tpu_torch/csrc/pad_lanes.cu",
                      replaces="adgs_tpu/raster/pallas/render.py:321"),
    "lab_cm": dict(id="E1", source="adgs_tpu_torch/csrc/lab_rowmajor.cu",
                   replaces="exp/lab_rowmajor.py:105"),
    "lab_rm": dict(id="E2", source="adgs_tpu_torch/csrc/lab_rowmajor.cu",
                   replaces="exp/lab_rowmajor.py:128"),
}
SERVING_KERNELS = ("compact_live", "expand", "composite_fwd", "grid_sample")
TRAINING_KERNELS = ("compact_live", "expand", "composite_fwd",
                    "composite_bwd", "segment_sum", "grid_sample",
                    "grid_sample_bwd")
LAB_KERNELS = ("lab_cm", "lab_rm")
# the cli.render phase's scene: the two poses, 5 timestamps each (frame 4
# of each camera is nvs-75's test frame)
CLI_TIMESTAMPS = 5
CLI_POINTS = 20_000       # points3d-75.ply / colmap-75.ply


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds of fn() over iters calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """The device-side events of a finished torch.profiler session (kernels,
    copies, sets: the CPU ops that launched them carry the same time
    again) and the name of their device-time attribute."""
    import torch
    events = prof.key_averages()
    if not events:
        return [], "self_device_time_total"
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and getattr(e, attr) > 0], attr


def device_ms(fn, calls: int = 5, sessions: int = 3):
    """Mean device milliseconds per call of fn(): the device time that
    torch.profiler records during `calls` calls, summed, over the calls.
    Beside cuda_ms it splits a call's time between the card and the host
    that enqueues it. A profiler session now and then records no device
    event at all; such a session is run again, up to `sessions` in all,
    and None is returned if none records any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels, attr = device_events(prof)
        if kernels:
            return sum(getattr(e, attr) for e in kernels) / 1e3 / calls
    log("  (the profiler recorded no device time in "
        f"{sessions} sessions)")
    return None


def times(fn, iters: int, lib=None, lib_iters: int | None = None) -> dict:
    """A record's times: fn's card ms (CUDA events over `iters` calls
    enqueued back to back) and device ms, and the same two for the
    library call `lib` where there is one (else None)."""
    out = dict(ms=cuda_ms(fn, iters=iters), device_ms=device_ms(fn),
               library_ms=None, library_device_ms=None)
    if lib is not None:
        out.update(library_ms=cuda_ms(lib, iters=lib_iters or iters),
                   library_device_ms=device_ms(lib))
    return out


def yaw(rad: float) -> np.ndarray:
    c, s = math.cos(rad), math.sin(rad)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def camera_poses():
    """The two (R, T) world->camera poses of every phase."""
    return [(HORIZON, np.array([0.0, 0.0, 8.0])),
            (HORIZON @ yaw(0.15), np.array([0.5, -0.3, 8.0]))]


def build_scene(device, seed: int, n: int, width: int, height: int,
                env_res: int):
    """The KITTI-75 model from a numpy seed: (config, params, state, env,
    rays, cameras). Points lie 6-14 units ahead of the camera (world +x)."""
    import dataclasses
    import torch
    from adgs_tpu_torch.core.camera import Camera
    from adgs_tpu_torch.models import gaussians as gm
    from adgs_tpu_torch.models.env_map import EnvironmentMap, camera_rays
    from adgs_tpu_torch.ops.knn import mean_knn_sq_dist

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    pts[:, 0] = rng.uniform(-2.0, 6.0, size=n)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    obj_id = (rng.random(n) < 0.3).astype(np.float32)
    times = rng.uniform(size=n).astype(np.float32)
    d2 = mean_knn_sq_dist(pts)

    cfg = gm.GaussianConfig.from_order_args(KITTI_75, frame_num=FRAME_NUM,
                                            sh_degree=3, use_time_mask=True)
    params, state = gm.create_from_pcd(pts, cols, obj_id, times, cfg, d2,
                                       seed=seed, device=device)
    params = gm.set_init_time_sigma(params, 1.0 / FRAME_NUM)
    # instance density of a trained scene: shrink every log-scale
    shr = float(np.log(0.3))
    params = dataclasses.replace(params,
                                 scene_scaling=params.scene_scaling + shr,
                                 obj_scaling=params.obj_scaling + shr)
    gen = torch.Generator(device=device).manual_seed(seed)
    env = EnvironmentMap(grid=torch.randn((3, env_res, env_res),
                                          generator=gen, device=device))
    fovx = 2 * math.atan(width / (2 * FOCAL))
    fovy = 2 * math.atan(height / (2 * FOCAL))
    cams = [Camera.create(R=R, T=T, fovx=fovx, fovy=fovy, width=width,
                          height=height, device=device)
            for R, T in camera_poses()]
    rays = torch.as_tensor(camera_rays(cams[0].focal_x, height, width),
                           device=device)
    return cfg, params, state, env, rays, cams


def requests(cams, frames: int):
    """(camera, time) per request: alternating poses, times over [0, 1]."""
    ts = np.linspace(0.03, 0.97, frames)
    return [cams[i % len(cams)].at_time(float(t)) for i, t in enumerate(ts)]


def size_capacity(cfg, params, state, cams) -> tuple[int, int]:
    """Capacity as the trainer sizes it: max num_rendered / 0.92, rounded
    up to 4096. Returns (capacity, max num_rendered)."""
    from adgs_tpu_torch.render import compute_binning
    nr = max(int(compute_binning(c, params, state, cfg, capacity=1 << 10)
                 .num_rendered) for c in cams)
    return -(-int(nr / CAP_HEADROOM) // 4096) * 4096, nr


def frame_inputs(cfg, params, state, cam, capacity: int):
    """Settings, full Preprocessed (with SH colour) and Binning of a frame."""
    from adgs_tpu_torch.models.gaussians import (activated_scaling,
                                                 deformed_package)
    from adgs_tpu_torch.raster.binning import bin_gaussians
    from adgs_tpu_torch.raster.preprocess import preprocess
    from adgs_tpu_torch.render import settings_for_camera
    st = settings_for_camera(cam, cfg.sh_degree)
    pkg = deformed_package(params, state, cfg, cam.time)
    prep = preprocess(pkg["xyz"], activated_scaling(params), pkg["rotation"],
                      pkg["opacity"], pkg["shs"], st, active_mask=state.alive)
    return st, prep, bin_gaussians(prep, st, capacity, backend="torch")


def composite_rows(cfg, params, prep, flow_time, ch):
    """A frame's packed compositing rows: colour and depth (ch=4), at ch=8
    also the flow points at flow_time and the object mask."""
    import torch
    from adgs_tpu_torch.models.gaussians import deformed_xyz, obj_mask
    from adgs_tpu_torch.raster import render as rl
    from adgs_tpu_torch.raster.composite import depth_feature

    opac = torch.where(prep.visible, prep.opacity,
                       torch.zeros_like(prep.opacity))
    feats = [prep.rgb, depth_feature(prep.depth, True)[:, None]]
    if ch == 8:
        feats += [deformed_xyz(params, cfg, flow_time),
                  obj_mask(params).float()[:, None]]
    packed, _ = rl.pack_gaussian_rows(
        prep.mean2d, prep.conic, torch.log(torch.clamp(opac, min=rl.OP_FLOOR)),
        torch.cat(feats, -1))
    return packed


def saturated_rows(packed):
    """The saturated copy of packed rows: every opacity 0.99 and every
    splat 8x wider, so that a tile's pixels all stop within its first
    batch."""
    sat = packed.clone()
    sat[:, 2:5] *= 1.0 / 64.0
    sat[:, 5] = math.log(0.99)
    return sat


def b3_flops(pairs, ch) -> int:
    """B3's operations on this run's data: per composited pair 16 for
    power and alpha, 3 for T and its test, 1 for the weight and 2 ch for
    the blend; per gated pair GATED_PAIR_OPS, counted only in the
    (instance, quarter)s that the quarter culling keeps (B3 never
    evaluates the others)."""
    return (int(pairs.hit) * (20 + 2 * ch)
            + int(pairs.gated - pairs.culled) * GATED_PAIR_OPS)


def check_final_t(name, got, serial) -> None:
    """B3's final T bitwise its serial replay (render.py
    composite_final_t_serial), which a single wrongly culled pair with
    alpha >= 1/255 changes at any T: on a difference, how many pixels and
    by how much (relative) are logged before the check fails."""
    import torch
    same = bool(torch.equal(got, serial))
    msg = "bitwise equal"
    if not same:
        d = got != serial
        rel = ((got - serial).abs() / serial.abs().clamp(min=1e-30))[d]
        msg = (f"DIFFER at {int(d.sum())} of {d.numel()} pixels, max "
               f"relative {float(rel.max()):.3e}")
    log(f"  {name} vs its serial replay: {msg}")
    if not same:
        raise AssertionError(f"{name}: not bitwise its serial replay")


def quarter_cull_log(what, masks, binning, pairs) -> None:
    """The share of (instance, quarter)s and of gated pairs that B3's
    quarter culling removes, by its rendition."""
    total = int(binning.tile_start[-1] + binning.tile_count[-1])
    kept = int(sum(((masks[:total] >> q) & 1).sum() for q in range(4)))
    log(f"  B3 quarter culling on {what} (its rendition): {4 * total - kept} "
        f"of {4 * total} (instance, quarter) pairs culled "
        f"({100 * (4 * total - kept) / max(4 * total, 1):.1f}%), "
        f"{int((masks[:total] == 0).sum())} of {total} instances whole; "
        f"{int(pairs.culled)} of {int(pairs.gated)} gated (instance, pixel) "
        "pairs never evaluated")


def check_close(name, got, want, atol, rtol=0.0) -> float:
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = torch.allclose(got, want, rtol=rtol, atol=atol)
    log(f"  {name}: max |diff| {err:.3e} (atol {atol:g}, rtol {rtol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain twin")
    return err


def kernel_phase(cfg, params, state, env, rays, cam, capacity, seed):
    """B2, B1, B3 and B7 against their plain twins at a served frame's
    shapes; returns per-kernel records (error, times, bound)."""
    import torch
    import torch.nn.functional as F
    from adgs_tpu_torch.raster import binning as bl
    from adgs_tpu_torch.raster import render as rl
    from adgs_tpu_torch.ops import grid_sample as gs

    st, prep, binning = frame_inputs(cfg, params, state, cam, capacity)
    rec = {}

    # B2: live-first compaction, bitwise
    tiles = prep.tiles_touched
    offsets = torch.cumsum(tiles, 0, dtype=torch.int32)
    cargs = (offsets - tiles, tiles, prep.rect_min.contiguous(),
             prep.rect_max.contiguous(),
             bl.quantize_depth(prep.depth, st.num_tiles), offsets[-1])
    table, n_live = bl.compact_live(*cargs)
    table_p, n_live_p = bl.compact_live_torch(*cargs)
    same = bool(torch.equal(table, table_p)) and bool(torch.equal(n_live,
                                                                  n_live_p))
    n, k = tiles.shape[0], int(n_live)
    log(f"  B2 compact_live: table bitwise {'equal' if same else 'DIFFER'} "
        f"over {n} rows ({k} live)")
    if not same:
        raise AssertionError("B2 compaction disagrees with its plain twin")
    rec["compact_live"] = dict(
        max_abs_err=0.0,
        **times(lambda: bl.compact_live(*cargs), 20),
        plain_ms=cuda_ms(lambda: bl.compact_live_torch(*cargs), iters=5),
        bytes=n * 28 + n * 32, flops=0)

    # B1: expansion of B2's table, bitwise
    d_bits = bl.depth_bits_for(st.num_tiles)
    args = (table, n_live, offsets[-1], binning.gauss_id.shape[0], st.grid_x,
            d_bits, st.num_tiles)
    key_k, gid_k = bl.expand(*args)
    key_p, gid_p = bl.expand_torch(*args)
    same = bool(torch.equal(key_k, key_p)) and bool(torch.equal(gid_k, gid_p))
    log(f"  B1 expand: key/gid bitwise {'equal' if same else 'DIFFER'} "
        f"over {key_k.numel()} slots")
    if not same:
        raise AssertionError("B1 expansion disagrees with its plain twin")
    # the drop path: a capacity below num_rendered
    nr = int(offsets[-1])
    drop = (table, n_live, offsets[-1], nr // 2) + args[4:]
    check_bitwise(f"B1 expand vs its twin, capacity {nr // 2} < "
                  f"num_rendered {nr} (the drop path)", bl.expand(*drop),
                  bl.expand_torch(*drop))
    R = key_k.numel()
    rec["expand"] = dict(
        max_abs_err=0.0,
        **times(lambda: bl.expand(*args), 20),
        plain_ms=cuda_ms(lambda: bl.expand_torch(*args), iters=5),
        bytes=k * 32 + R * 12, flops=0)

    # B3: compositing, ch=4 (serving) and ch=8 (+flow +semantic); final T
    # bitwise its serial replay (the same for both widths: only the
    # features differ), which holds the quarter culling exactly
    serial = masks = None
    err = err_rows = 0.0
    for ch in (8, 4):
        packed = composite_rows(cfg, params, prep, cam.time + 0.01, ch)
        cargs = (packed, ch, binning.gauss_id, binning.tile_start,
                 binning.tile_count, st.grid_x)
        if serial is None:
            serial = rl.composite_final_t_serial(*cargs)
            masks = rl.quarter_masks_torch(packed, binning.gauss_id,
                                           binning.tile_start,
                                           binning.tile_count, st.grid_x)
        bk, tk = rl.composite_fwd(*cargs)
        bp, tp, pairs = rl.composite_fwd_torch(*cargs, count_pairs=True,
                                               masks=masks)
        err = max(err, check_close(f"B3 composite ch={ch} blended", bk, bp,
                                   1e-4, 1e-4),
                  check_close(f"B3 composite ch={ch} final_t", tk, tp,
                              1e-4, 1e-4))
        check_final_t(f"B3 composite ch={ch} final_t", tk, serial)
        # the rows layout: the same kernel source, bitwise the gather's
        inst = rl.build_instances_rows(binning.gauss_id, packed)
        rargs = (inst,) + cargs[1:]
        br, tr = rl.composite_fwd(*rargs, layout="rows")
        check_bitwise(f"B3 rows layout ch={ch} vs gather layout",
                      (br, tr), (bk, tk))
        bpr, tpr = rl.composite_fwd_torch(*rargs, layout="rows")
        err_rows = max(err_rows, check_close(
            f"B3 rows layout ch={ch} blended vs its twin", br, bpr, 1e-4,
            1e-4), check_close(f"B3 rows layout ch={ch} final_t vs its twin",
                               tr, tpr, 1e-4, 1e-4))
    quarter_cull_log("the served frame", masks, binning, pairs)
    del serial, masks
    # times at the serving width (ch=4, the last packed above)
    T = binning.tile_start.shape[0]
    f_cols = packed.shape[1]
    rec["pad_lanes"] = pad_lanes_record(packed)
    # the rest of the rows layout's build: one row gather into tile order
    wide = rl.pad_to_lanes(packed.t())
    gid = binning.gauss_id.long()
    gather_ms = cuda_ms(lambda: torch.index_select(wide, 0, gid), iters=20)
    build_ms = cuda_ms(lambda: rl.build_instances_rows(binning.gauss_id,
                                                       packed), iters=20)
    log(f"  rows layout build: index_select of {R} rows of "
        f"{rl.LANES * 4} B {gather_ms:.4f} ms; build_instances_rows (B6 + "
        f"gather) {build_ms:.4f} ms")
    del wide
    rec["composite_fwd_rows"] = dict(
        kernel="composite_fwd", use="rows layout, ch=4",
        max_abs_err=err_rows,
        **times(lambda: rl.composite_fwd(*rargs, layout="rows"), 20),
        plain_ms=cuda_ms(lambda: rl.composite_fwd_torch(*rargs,
                                                        layout="rows"),
                         iters=2),
        # the F used columns of each instance row, ranges, output
        bytes=R * f_cols * 4 + T * 8 + T * 5 * 256 * 4,
        flops=b3_flops(pairs, ch))
    rec["composite_fwd"] = dict(
        use="serving, ch=4", max_abs_err=err,
        **times(lambda: rl.composite_fwd(*cargs), 20),
        plain_ms=cuda_ms(lambda: rl.composite_fwd_torch(*cargs), iters=2),
        bytes=packed.numel() * 4 + R * 4 + T * 8 + T * 5 * 256 * 4,
        flops=b3_flops(pairs, ch), pairs=pairs)

    # B7: sky sample on the full grid, bitwise its twin: at the frame's
    # coords; at coords in [-1.2, 1.2] with 5% NaN (taps off the grid get
    # weight 0, NaN indices saturate to 0); at C = 1 (the generic kernel)
    coords = sky_coords(rays, cam)
    grid = env.grid
    sk = gs.grid_sample(grid, coords)
    check_bitwise("B7 grid_sample vs its twin (served frame)", sk,
                  gs.grid_sample_torch(grid, coords))
    gen = torch.Generator(device=grid.device).manual_seed(seed)
    wild = torch.rand(coords.shape, generator=gen, device=grid.device)
    wild = wild * 2.4 - 1.2
    wild[torch.rand(coords.shape, generator=gen, device=grid.device)
         < 0.05] = float("nan")
    grid1 = grid[:1].contiguous()
    for label, g, c in (("off-grid and NaN coords", grid, wild),
                        ("C=1, served frame", grid1, coords),
                        ("C=1, off-grid and NaN coords", grid1, wild)):
        check_bitwise(f"B7 grid_sample vs its twin ({label})",
                      gs.grid_sample(g, c), gs.grid_sample_torch(g, c))
    del wild, grid1
    err = 0.0
    lib = F.grid_sample(grid[None], coords[None], align_corners=True,
                        padding_mode="zeros")[0]
    check_close("B7 grid_sample vs torch grid_sample (yardstick)", sk, lib,
                1e-4)
    cells = torch.unique(torch.cat([(yi * grid.shape[2] + xi).reshape(-1)
                                    for xi, yi, _ in gs._taps(grid.shape,
                                                              coords)]))
    C, npix = grid.shape[0], coords.numel() // 2
    rec["grid_sample"] = dict(
        max_abs_err=err,
        **times(lambda: gs.grid_sample(grid, coords), 50,
                lib=lambda: F.grid_sample(grid[None], coords[None],
                                          align_corners=True,
                                          padding_mode="zeros")),
        plain_ms=cuda_ms(lambda: gs.grid_sample_torch(grid, coords), iters=10),
        bytes=npix * 8 + C * npix * 4 + cells.numel() * C * 4,
        flops=npix * (12 + 8 * C), distinct_cells=int(cells.numel()))
    return rec


def fmt_ms(x) -> str:
    return "none" if x is None else f"{x:.4f}"


def check_bitwise(name, got, want) -> None:
    """Tensors (or tuples of them) equal bit for bit."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"  {name}: {'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"{name}: not bitwise equal")


def pad_lanes_record(packed):
    """B6 on the frame's packed rows taken as [F, N] (packed.t(), no
    copy), bitwise against its twin; F.pad of the transpose is the
    library yardstick."""
    import torch.nn.functional as F_nn
    from adgs_tpu_torch.raster import render as rl
    src = packed.t()
    F, n = src.shape
    wide = rl.pad_to_lanes(src)
    check_bitwise("B6 pad_to_lanes vs its twin", wide,
                  rl.pad_to_lanes_torch(src))
    n_pad = wide.shape[0]

    def lib():
        return F_nn.pad(src.t(), (0, rl.LANES - F, 0, n_pad - n))

    check_bitwise("B6 vs torch F.pad of the transpose (yardstick)", wide,
                  lib())
    return dict(max_abs_err=0.0,
                **times(lambda: rl.pad_to_lanes(src), 20, lib=lib),
                plain_ms=cuda_ms(lambda: rl.pad_to_lanes_torch(src), iters=5),
                bytes=F * n * 4 + n_pad * rl.LANES * 4, flops=0,
                use=f"[{F}, {n}] -> [{n_pad}, {rl.LANES}]")


def sky_coords(rays, cam):
    """[H, W, 2] env-map coords of the camera's rays (EnvironmentMap.color's
    arithmetic)."""
    import torch
    from adgs_tpu_torch.models.env_map import direction_to_angles
    world = rays @ cam.world_view[:3, :3].T
    world = world / torch.linalg.vector_norm(world, dim=-1, keepdim=True)
    ang = direction_to_angles(world)
    return (ang * ang.new_tensor([1.0 / math.pi, 2.0 / math.pi])).contiguous()


def check_segment_sum(label, rows, bounds) -> float:
    """B5 on rows [R, D] and bounds [n+1] against its twin at 1e-6 of
    max|twin| plus 1e-6 relative (the twin sums in float64), and a second
    launch bitwise equal to the first (the order of the sums is fixed).
    Returns the largest difference."""
    from adgs_tpu_torch.raster import render as rl
    per = rl.segment_sum(rows, bounds)
    check_bitwise(f"{label}, second launch", rl.segment_sum(rows, bounds),
                  per)
    per_p = rl.segment_sum_torch(rows, bounds)
    scale = float(per_p.abs().max()) if per_p.numel() else 0.0
    return check_close(label, per, per_p, 1e-6 * scale, 1e-6)


def segment_sum_cases(dev, seed) -> None:
    """B5's synthetic cases, for D in 1, 3, 16, 33, 98: one segment of
    100,000 rows among 50,000 segments of 0-3 rows; every segment empty
    (bounds[0] = bounds[n] inside the rows); bounds[0] > 0 with bounds[n]
    < R; rows N(0,1) from the seed."""
    import torch
    rng = np.random.default_rng(seed + 3)

    def rows(R, D):
        return torch.as_tensor(rng.standard_normal((R, D), np.float32),
                               device=dev)

    def tensor(b):
        return torch.as_tensor(np.asarray(b, np.int32), device=dev)

    for D in (1, 3, 16, 33, 98):
        lens = rng.integers(0, 4, size=50_000)
        lens[rng.integers(50_000)] = 100_000
        b = np.concatenate([[0], np.cumsum(lens)])
        check_segment_sum(f"B5 D={D}, one segment of 100000 rows",
                          rows(int(b[-1]), D), tensor(b))
        check_segment_sum(f"B5 D={D}, all segments empty", rows(1000, D),
                          tensor(np.full(40_001, 377)))
        lens = rng.integers(0, 6, size=30_000)
        b = 1234 + np.concatenate([[0], np.cumsum(lens)])
        check_segment_sum(f"B5 D={D}, bounds[0] > 0 and bounds[n] < R",
                          rows(int(b[-1]) + 5000, D), tensor(b))


def segment_sum_record(label, rows, bounds, owner, use):
    """B5 held as check_segment_sum holds it, on rows [R, D] and bounds
    [n+1]; owner holds the segment of each row in [bounds[0], bounds[n]),
    for index_add_. Returns the kernel's record."""
    import torch
    from adgs_tpu_torch.raster import render as rl
    err = check_segment_sum(label, rows, bounds)
    n, D = bounds.shape[0] - 1, rows.shape[1]
    lo, hi = int(bounds[0]), int(bounds[-1])
    used = rows[lo:hi]
    lens = (bounds[1:] - bounds[:-1]).float()
    log(f"  {label}: {n} segments, {float((lens == 0).float().mean()):.3f} "
        f"empty, rows per segment p50 {float(lens.quantile(0.5)):.0f}, "
        f"p99 {float(lens.quantile(0.99)):.0f}, max {int(lens.max())}")
    return dict(
        max_abs_err=err, use=f"{use} [{hi - lo}, {D}] into {n} segments",
        **times(lambda: rl.segment_sum(rows, bounds), 20,
                lib=lambda: torch.zeros((n, D), device=rows.device)
                .index_add_(0, owner, used)),
        plain_ms=cuda_ms(lambda: rl.segment_sum_torch(rows, bounds), iters=5),
        bytes=((hi - lo) * D + n + 1 + n * D) * 4, flops=(hi - lo) * D)


def step_composite_inputs(cfg, params, state, cam, batch, capacity):
    """The training step's compositing inputs: its settings, binning and
    packed ch=8 rows (colour, depth, the flow points at the batch's flow
    time, the object mask)."""
    st, prep, binning = frame_inputs(cfg, params, state, cam, capacity)
    return st, binning, composite_rows(cfg, params, prep, batch.flow.time, 8)


def tile_count_stats(tile_count) -> dict:
    """Instances per tile: mean, p99 and max over the frame's tiles."""
    c = tile_count.double()
    return dict(tiles=int(c.numel()), mean=float(c.mean()),
                p99=float(c.quantile(0.99)), max=int(c.max()))


B4_BATCH = 128   # instances B4 stages at a time (csrc/composite_bwd.cu)


def whole_tile_exits(reach, tile_count) -> dict:
    """The tiles B4 leaves at a batch boundary before their last instance,
    all their pixels stopped, and the rows it zeroes after them, as the
    twin's replay has it (reach: a tile's instances up to its last pixel's
    stop, PairCounts.reach)."""
    base = (reach + B4_BATCH - 1) // B4_BATCH * B4_BATCH
    left = (tile_count.long() - base).clamp(min=0)
    return dict(tiles=int((left > 0).sum()), rows=int(left.sum()))


def b4_buffers(binning, ch, device):
    """B4's output buffers, the rows filled with NaN and the tile order
    with -1, so that a row or a tile the kernel does not write fails its
    check."""
    import torch
    from adgs_tpu_torch.raster import render as rl
    R, T = binning.gauss_id.shape[0], binning.tile_count.shape[0]
    return (torch.full((R, rl.grad_cols(ch)), float("nan"), device=device),
            torch.full((T,), -1, dtype=torch.int32, device=device))


def b4_exit_check(packed, binning, grid_x, ch, gen) -> None:
    """B4's whole-tile exit and the zero rows it writes after it, which
    the step's own inputs do not reach: the same instances with every
    opacity at 0.99 and every splat 8x wider, so that a tile's pixels all
    stop within its first batch. Into buffers of NaN, every row must be
    written, and the rows of the instances a whole batch or more past the
    exit that the twin's replay predicts must be exact zeros (only the
    exit's tail writes them); the rows layout bitwise the gather layout's.
    B4 is not held to the twin: with most pixels stopping, the twin's
    log-space transmittance and the kernel's running product may part on
    a stop that falls within rounding of 1e-4. B3's final T is held
    bitwise to its serial replay, which rounds as the kernel does."""
    import torch
    from adgs_tpu_torch.raster import render as rl
    sat = saturated_rows(packed)
    fargs = (sat, ch, binning.gauss_id, binning.tile_start,
             binning.tile_count, grid_x)
    blended, final_t = rl.composite_fwd(*fargs)
    # B3 on the saturated copy: finite, T never below its stop, the rows
    # layout bitwise the gather layout's
    ok = (bool(torch.isfinite(blended).all())
          and bool(((final_t >= 1e-4) & (final_t <= 1.0)).all()))
    log(f"  B3 saturated: outputs finite, final T in [1e-4, 1]: "
        f"{'ok' if ok else 'FAIL'} (min T {float(final_t.min()):.3e})")
    if not ok:
        raise AssertionError("B3 on the saturated copy: bad outputs")
    check_final_t("B3 saturated final_t", final_t,
                  rl.composite_final_t_serial(*fargs))
    inst = rl.build_instances_rows(binning.gauss_id, sat)
    check_bitwise("B3 saturated: rows layout vs gather layout",
                  rl.composite_fwd(inst, *fargs[1:], layout="rows"),
                  (blended, final_t))
    fwd_out = torch.cat([blended, final_t[:, None]], 1).contiguous()
    g_out = torch.randn(fwd_out.shape, generator=gen, device=fwd_out.device)
    bargs = (sat, ch, binning.gauss_id, binning.slot_sorted,
             binning.tile_start, binning.tile_count, grid_x, fwd_out, g_out)
    _, _, pairs = rl.composite_fwd_torch(*fargs, count_pairs=True)
    ex = whole_tile_exits(pairs.reach, binning.tile_count)
    log(f"  B4 saturated: whole-tile exits (the twin's replay): "
        f"{ex['tiles']} tiles, {ex['rows']} rows zeroed after them")
    rows, order = b4_buffers(binning, ch, sat.device)
    rl.composite_bwd_into(rows, order, *bargs)
    written = bool(torch.isfinite(rows).all())
    log(f"  B4 saturated: every row written: {'ok' if written else 'FAIL'}")
    if not written:
        raise AssertionError("B4 left rows unwritten")
    total = int(binning.tile_start[-1] + binning.tile_count[-1])
    tid = binning.tile_id[:total].long()
    j = (torch.arange(total, device=sat.device)
         - binning.tile_start.long()[tid])
    past = (pairs.reach + 2 * B4_BATCH - 1) // B4_BATCH * B4_BATCH
    far = binning.slot_sorted[:total][j >= past[tid]].long()
    if far.numel() == 0:
        raise AssertionError("B4 saturated: no instance past an exit")
    check_bitwise(f"B4 saturated: the {far.numel()} rows a batch or more "
                  "past the exit are zeros", rows[far],
                  torch.zeros_like(rows[far]))
    rows_r, order = b4_buffers(binning, ch, sat.device)
    rl.composite_bwd_into(rows_r, order, inst, *bargs[1:], layout="rows")
    check_bitwise("B4 saturated: rows layout vs gather layout", rows_r, rows)


def backward_kernel_phase(rec, cfg, params, state, env, rays, cam, batch,
                          capacity, seed):
    """B4, B5 and B8 against their plain twins on the training step's own
    inputs (its camera, its ch=8 rows with the flow points at the batch's
    flow time, its sky coords), with N(0,1) cotangents so that the rows
    are O(1)."""
    import torch
    import torch.nn.functional as F
    from adgs_tpu_torch.raster import render as rl
    from adgs_tpu_torch.ops import grid_sample as gs
    from adgs_tpu_torch.train.losses import sorted_group_rows

    st, binning, packed = step_composite_inputs(cfg, params, state, cam,
                                                batch, capacity)
    grid = env.grid
    coords = sky_coords(rays, cam)
    gen = torch.Generator(device=grid.device).manual_seed(seed)

    # B4: rtol 1e-3, atol 1e-5 max|twin| (the sums over a tile's 256
    # pixels run in another order). It writes every row, so here it writes
    # into buffers of NaN: a row it missed fails the check
    ch = 8
    tc = tile_count_stats(binning.tile_count)
    log(f"  B4 instances per tile over {tc['tiles']} tiles: mean "
        f"{tc['mean']:.1f}, p99 {tc['p99']:.1f}, max {tc['max']}")
    fargs = (packed, ch, binning.gauss_id, binning.tile_start,
             binning.tile_count, st.grid_x)
    blended, final_t = rl.composite_fwd(*fargs)
    fwd_out = torch.cat([blended, final_t[:, None]], 1).contiguous()
    g_out = torch.randn(fwd_out.shape, generator=gen, device=fwd_out.device)
    bargs = (packed, ch, binning.gauss_id, binning.slot_sorted,
             binning.tile_start, binning.tile_count, st.grid_x, fwd_out, g_out)
    # B3 at the step's width, on the step's inputs
    masks = rl.quarter_masks_torch(packed, binning.gauss_id,
                                   binning.tile_start, binning.tile_count,
                                   st.grid_x)
    bp, tp, pairs = rl.composite_fwd_torch(*fargs, count_pairs=True,
                                           masks=masks)
    err = max(check_close("B3 composite ch=8 (step) blended", blended, bp,
                          1e-4, 1e-4),
              check_close("B3 composite ch=8 (step) final_t", final_t, tp,
                          1e-4, 1e-4))
    check_final_t("B3 composite ch=8 (step) final_t", final_t,
                  rl.composite_final_t_serial(*fargs))
    quarter_cull_log("the step", masks, binning, pairs)
    del bp, tp, masks
    R, T = binning.gauss_id.shape[0], binning.tile_start.shape[0]
    rec["composite_fwd_ch8"] = dict(
        kernel="composite_fwd", use="training, ch=8", max_abs_err=err,
        **times(lambda: rl.composite_fwd(*fargs), 20),
        plain_ms=cuda_ms(lambda: rl.composite_fwd_torch(*fargs), iters=2),
        bytes=(packed.numel() + R + 2 * T + T * (ch + 1) * 256) * 4,
        flops=b3_flops(pairs, ch))
    ex = whole_tile_exits(pairs.reach, binning.tile_count)
    log(f"  B4 whole-tile exits (the twin's replay): {ex['tiles']} tiles, "
        f"{ex['rows']} rows zeroed after them")
    gc = rl.grad_cols(ch)
    rows, order = b4_buffers(binning, ch, packed.device)
    rl.composite_bwd_into(rows, order, *bargs)
    check_bitwise("B4 tile order (longest first) vs a stable sort", order,
                  torch.sort(binning.tile_count, descending=True,
                             stable=True).indices.to(torch.int32))
    total = int(binning.tile_start[-1] + binning.tile_count[-1])
    check_bitwise(f"B4 rows past the {total} valid instances: zeros",
                  rows[total:], torch.zeros_like(rows[total:]))
    rows_p = rl.composite_bwd_torch(*bargs)
    scale = float(rows_p.abs().max())
    err = check_close("B4 composite_bwd rows", rows, rows_p, 1e-5 * scale,
                      1e-3)
    nc = rl.N_GEOM_GRAD + ch
    # the rows layout: bitwise the gather layout's rows
    inst = rl.build_instances_rows(binning.gauss_id, packed)
    rargs = (inst,) + bargs[1:]
    rows_r, order = b4_buffers(binning, ch, packed.device)
    rl.composite_bwd_into(rows_r, order, *rargs, layout="rows")
    check_bitwise("B4 rows layout vs gather layout", rows_r, rows)
    err_rows = check_close("B4 rows layout vs its twin", rows_r,
                           rl.composite_bwd_torch(*rargs, layout="rows"),
                           1e-5 * scale, 1e-3)
    rec["composite_bwd_rows"] = dict(
        kernel="composite_bwd", use="rows layout, ch=8",
        max_abs_err=err_rows,
        **times(lambda: rl.composite_bwd(*rargs, layout="rows"), 10),
        plain_ms=cuda_ms(lambda: rl.composite_bwd_torch(*rargs,
                                                        layout="rows"),
                         iters=2),
        bytes=(R * packed.shape[1] + R + 2 * fwd_out.numel() + R * gc) * 4,
        flops=(int(pairs.hit) * (50 + 3 * ch + nc)
               + int(pairs.gated) * GATED_PAIR_OPS))
    del inst, rows_r
    rec["composite_bwd"] = dict(
        max_abs_err=err,
        **times(lambda: rl.composite_bwd(*bargs), 10),
        plain_ms=cuda_ms(lambda: rl.composite_bwd_torch(*bargs), iters=2),
        bytes=(packed.numel() + 2 * R + 2 * fwd_out.numel() + R * gc) * 4,
        # per composited pair: ~36 for power, alpha, T and dL/dalpha, 2 ch
        # for f.g, 14 + ch for the pixel's 6 + ch values, nc for their sum
        flops=(int(pairs.hit) * (50 + 3 * ch + nc)
               + int(pairs.gated) * GATED_PAIR_OPS),
        pairs=pairs)
    b4_exit_check(packed, binning, st.grid_x, ch, gen)

    # B5 on B4's rows: 1e-6 of max|twin| (the twin sums in float64)
    bounds = rl.contiguous_bounds(binning.gauss_start, binning.num_rendered, R)
    n = bounds.shape[0] - 1
    owner = torch.repeat_interleave(
        torch.arange(n, device=rows.device), (bounds[1:] - bounds[:-1]).long())
    rec["segment_sum"] = segment_sum_record(
        "B5 segment_sum on B4's rows", rows, bounds, owner,
        "compositing backward: B4's presort rows")

    # B5 on the KNN group gather's backward at the step's shape: both
    # regularizers' columns, every anchor group
    idx = state.obj_near_idx
    n_obj = params.xyz_deform.shape[0]
    D = params.xyz_deform[0].numel() + params.gs_time_sigma[0].numel()
    d_g = torch.randn(tuple(idx.shape) + (D,), generator=gen,
                      device=idx.device)
    krows, ids, kbounds = sorted_group_rows(d_g, idx, n_obj)
    rec["segment_sum_knn"] = segment_sum_record(
        "B5 segment_sum on the KNN gather's rows", krows, kbounds, ids,
        "KNN group gather backward: sorted group rows")
    rec["segment_sum_knn"]["kernel"] = "segment_sum"
    # its longest segment alone (the groups past the valid anchors all
    # point at value 0): its tiles in parallel, then one span sum
    seg_len = kbounds[1:] - kbounds[:-1]
    i = int(torch.argmax(seg_len))
    one = kbounds[i:i + 2].contiguous()
    alone = times(lambda: rl.segment_sum(krows, one), 20)
    log(f"  B5 on the KNN rows: longest segment {int(seg_len[i])} rows "
        f"(value {i}), alone {alone['ms']:.4f} ms (device "
        f"{fmt_ms(alone['device_ms'])} ms); median segment "
        f"{int(seg_len.median())} rows")

    # B8: bitwise against the rendition of its own order, 1e-6 of
    # max|twin| against the scatter twin (index_add_, atomics on the card),
    # a second launch bitwise; on the step's coords, on off-grid and NaN
    # coords, on a field whose taps cross the grid's last column and rows,
    # and at C = 1
    C = grid.shape[0]
    shape = tuple(grid.shape)
    g_sky = torch.randn((C,) + tuple(coords.shape[:-1]), generator=gen,
                        device=grid.device)
    err = check_sky_scatter("step's sky coords", g_sky, coords, shape)
    for label, c in sky_coord_cases(coords, shape, gen):
        check_sky_scatter(label, g_sky, c, shape)
        check_sky_scatter(label + ", C=1", g_sky[:1].contiguous(), c,
                          (1,) + shape[1:])
    d_grid = gs.grid_sample_bwd(g_sky, coords, shape)
    leaf = grid.detach().clone().requires_grad_(True)
    out = F.grid_sample(leaf[None], coords[None], align_corners=True,
                        padding_mode="zeros")

    def lib():
        return torch.autograd.grad(out, leaf, g_sky[None], retain_graph=True)

    check_close("B8 vs the grid gradient of torch grid_sample (yardstick)",
                d_grid, lib()[0], 1e-4)
    del d_grid
    sky_scatter_breakdown(g_sky, coords, shape, lib)
    npix = coords.numel() // 2
    rec["grid_sample_bwd"] = dict(
        max_abs_err=err,
        **times(lambda: gs.grid_sample_bwd(g_sky, coords, shape), 10,
                lib=lib),
        plain_ms=cuda_ms(lambda: gs.grid_sample_bwd_torch(g_sky, coords,
                                                          shape), iters=3),
        # the gradient is dense: the whole grid is written once
        bytes=npix * 8 + C * npix * 4 + grid.numel() * 4,
        flops=4 * npix * (20 + 2 * C))


def sky_coord_cases(coords, shape, gen):
    """B8's extra coordinate fields, of the step's coords' shape: uniform
    in [-1.2, 1.2] with 5% NaN (taps off the grid, NaN bases); uniform in
    [-1, 1] with every 16th pixel within a few cells of the right edge
    (taps that cross the last column or leave the grid; every 7th of them
    on x = 1) and every 16th (offset 4) on y = +-1; uniform in [-1, 1]
    with every 16th pixel just left of x = -1 and every 16th (offset 8)
    on the top or bottom row (bases at x0 = -1, y0 = -1 and y0 = Hg - 1).
    Edge pixels are spread along their edge, so a base holds a few of
    them, as a sky's rays do."""
    import torch
    _, Hg, Wg = shape
    dev = coords.device

    def unif(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    def field(lo, hi):
        n = coords.numel() // 2
        return torch.stack([unif(n, lo, hi), unif(n, lo, hi)], -1)

    wild = field(-1.2, 1.2)
    wild[torch.rand(wild.shape, generator=gen, device=dev) < 0.05] = \
        float("nan")
    right = field(-1.0, 1.0)
    edge = right[::16]
    edge[:, 0] = unif(edge.shape[0], 1 - 4 / (Wg - 1), 1 + 1 / (Wg - 1))
    edge[::7, 0] = 1.0
    edge = right[4::16]
    edge[:, 1] = torch.where(unif(edge.shape[0], 0, 1) < 0.5, -1.0, 1.0)
    corner = field(-1.0, 1.0)
    edge = corner[::16]
    edge[:, 0] = unif(edge.shape[0], -1 - 1 / (Wg - 1), -1.0)
    edge = corner[8::16]
    ny = edge.shape[0]
    edge[:, 1] = torch.where(unif(ny, 0, 1) < 0.5,
                             unif(ny, -1 - 1 / (Hg - 1), -1.0),
                             unif(ny, 1.0, 1 + 1 / (Hg - 1)))
    return [(label, f.reshape(coords.shape).contiguous())
            for label, f in (("off-grid and NaN coords", wild),
                             ("taps across the last column", right),
                             ("bases at x0 = -1, y0 = -1 and y0 = Hg - 1",
                              corner))]


def check_sky_scatter(label, g, coords, shape) -> float:
    """B8 on (g, coords) bitwise against grid_sample_bwd_pixel_order (its
    own order, deterministic) and against a second launch, and within
    1e-6 of max|twin| of the scatter twin. Returns that difference."""
    from adgs_tpu_torch.ops import grid_sample as gs
    d_grid = gs.grid_sample_bwd(g, coords, shape)
    check_bitwise(f"B8 {label}, second launch",
                  gs.grid_sample_bwd(g, coords, shape), d_grid)
    check_bitwise(f"B8 {label} vs its order's twin", d_grid,
                  gs.grid_sample_bwd_pixel_order(g, coords, shape))
    d_plain = gs.grid_sample_bwd_torch(g, coords, shape)
    scale = float(d_plain.abs().max())
    return check_close(f"B8 {label} vs the scatter twin", d_grid, d_plain,
                       1e-6 * scale, 1e-6)


# B8's parts, by the names of the device kernels they launch; the order
# is torch.sort's: its radix passes, its memset, the copy of its keys and
# its index fill; F.grid_sample's gradient sums with its bilinear sampler
# kernel and zeroes the grid with cuDNN's scalePackedTensor
SKY_PARTS = (("keys", ("pixel_keys",)),
             ("order", ("Radix", "fill_reverse_indices", "Memset",
                        "Memcpy")),
             ("values", ("tap_values",)),
             ("sum+fill", ("sum_fill",)),
             ("sum", ("bilinear_sampler",)),
             ("fill", ("FillFunctor", "scalePackedTensor")))


def kernel_split(fn, calls: int = 5) -> dict:
    """{device kernel name: device ms per call} of fn() from one
    torch.profiler session over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels, attr = device_events(prof)
    return {e.key: getattr(e, attr) / 1e3 / calls for e in kernels}


def sky_scatter_breakdown(g, coords, shape, lib) -> None:
    """Log B8's device time per call split by its parts (SKY_PARTS), each
    kernel named, and beside it that of lib (the grid gradient of
    F.grid_sample)."""
    from adgs_tpu_torch.ops import grid_sample as gs
    for what, fn in (("B8", lambda: gs.grid_sample_bwd(g, coords, shape)),
                     ("F.grid_sample grid gradient", lib)):
        split = kernel_split(fn)
        parts = {}
        for name, ms in split.items():
            part = next((p for p, keys in SKY_PARTS
                         if any(k in name for k in keys)), "other")
            parts[part] = parts.get(part, 0.0) + ms
        log(f"# {what} device ms per call by part: total "
            f"{sum(split.values()):.4f}; " + json.dumps(
                {k: round(v, 4) for k, v in parts.items()}))
        for name, ms in sorted(split.items(), key=lambda kv: -kv[1]):
            log(f"#   {ms:.4f} ms  {name[:100]}")


def lab_phase(dev, seed):
    """The ported lab (adgs_tpu_torch.exp.lab_rowmajor) at its defaults:
    first E1 and E2 in every variant against their twins (1e-5 of
    max|twin|) on the lab's operands, then the lab itself, with the launch
    counts reset just before and read just after, then the twins' and
    torch.bmm's times. Returns (records, launches)."""
    import torch
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.exp import lab_rowmajor as lab

    n, rows = lab.sizes()
    r = lab.programs(rows)
    inp = lab.make_inputs(n, rows, np.random.default_rng(seed), dev)
    errs = []
    for v in lab.VARIANTS:
        got, twin = lab.run_variant(v, inp, r), lab.twin_variant(v, inp, r)
        scale = float(twin.abs().max())
        errs.append(check_close(f"{KERNELS[v.kernel]['id']} {v.label}", got,
                                twin, 1e-5 * scale))
    # E1 also at one chunk a program, over about the same rows, with a
    # program count that is not a multiple of 8 (7483 at the defaults)
    p1 = lab.Programs(max(1, r.nprog * r.per - 5), 1)
    twin = lab.block_sums_cm_torch(inp.inst_cm, p1)
    check_close(f"E1 per=1, {p1.nprog} programs",
                lab.block_sums_cm(inp.inst_cm, p1), twin,
                1e-5 * float(twin.abs().max()))
    torch.cuda.synchronize()
    _kernels.reset_launches()
    lab_ms = lab.main(["--seed", str(seed), "--device", str(dev)])
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    nbytes = lab.variant_bytes(r)
    recs = {}
    for v, err in zip(lab.VARIANTS, errs):
        src = getattr(inp, v.operand)
        blk = (lab.cm_blocks(src, r) if v.form == "cm"
               else lab.rm_blocks(src, r))
        recs[f"{v.kernel}:{v.form}:{v.operand}"] = dict(
            kernel=v.kernel, use=f"{v.form}, {v.label}", max_abs_err=err,
            ms=lab_ms[v.label],
            device_ms=device_ms(lambda: lab.run_variant(v, inp, r)),
            plain_ms=cuda_ms(lambda: lab.twin_variant(v, inp, r), iters=5),
            library_ms=cuda_ms(lambda: lab.library_block_sums(blk), iters=10),
            library_device_ms=device_ms(lambda: lab.library_block_sums(blk)),
            bytes=nbytes, flops=r.covered * 128)
    return recs, launches


def write_cli_scene(root, seed, poses, width, height, points, obj=None):
    """A KITTI-format scene (tests/test_data_cli.py's contract: poses.npz,
    image/, depth/, semantic/, sky/, flow/nvs-75/, points3d-75.ply,
    colmap-75.ply) at width x height, KITTI P2's focal: the two poses as
    the two cameras, CLI_TIMESTAMPS timestamps each, images and priors
    from the seed, init clouds from `points` [M, 3] with object flags
    `obj` [M] (None: 30% at random); the SfM cloud is the first 1000."""
    import os
    from PIL import Image
    from adgs_tpu_torch.data.ply import store_point_cloud

    rng = np.random.default_rng(seed + 2)
    num_cam = len(poses)
    for d in ("image", "depth", "semantic", "sky", "flow/nvs-75"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    total = CLI_TIMESTAMPS * num_cam
    time_stamp = np.repeat(np.arange(CLI_TIMESTAMPS), num_cam).astype(
        np.float64)
    R = np.tile(np.eye(4), (total, 1, 1))
    T = np.zeros((total, 4))
    for i in range(total):
        R[i, :3, :3], T[i, :3] = poses[i % num_cam]
    np.savez(os.path.join(root, "poses.npz"), time_stamp=time_stamp, R=R,
             T=T, height=height, width=width, focal=FOCAL)
    K = np.array([[FOCAL, 0, width / 2], [0, FOCAL, height / 2], [0, 0, 1.0]])
    for i in range(total):
        name = f"{i:06d}"
        img = (rng.uniform(size=(height, width, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, "image", name + ".png"))
        np.save(os.path.join(root, "depth", name + ".npy"),
                rng.uniform(0.1, 1.0, (height, width, 1)).astype(np.float32))
        np.save(os.path.join(root, "semantic", "mask_" + name + ".npy"),
                (rng.random((height, width)) < 0.2).astype(np.int32))
        np.save(os.path.join(root, "sky", "mask_" + name + ".npy"),
                (rng.random((height, width)) < 0.3).astype(np.uint8))
        pkg = [np.float64(time_stamp[i]), K, poses[i % num_cam][0],
               poses[i % num_cam][1],
               rng.uniform(0, width - 1, (2, height, width)),
               (rng.random((height, width)) > 0.5).astype(np.float32)]
        np.savez(os.path.join(root, "flow", "nvs-75", name + ".npz"),
                 flow=np.asarray([pkg], dtype=object))
    cols = rng.uniform(size=points.shape) * 255
    if obj is None:
        obj = (rng.random(len(points)) < 0.3).astype(np.float32)
    tms = rng.uniform(0, CLI_TIMESTAMPS - 1, len(points)).astype(np.float32)
    store_point_cloud(os.path.join(root, "points3d-75.ply"), points, cols,
                      tms, obj)
    store_point_cloud(os.path.join(root, "colmap-75.ply"), points[:1000],
                      cols[:1000])


def cli_phase(cfg, params, state, env, cams, poses, seed, dev):
    """adgs_tpu_torch.cli.render from a saved checkpoint at full width:
    the model written with the port's save_ply, env.npy and
    cfg_args.json beside a 1242x375 KITTI-format scene, then cli.render
    in render mode over both splits, once per layout (ADGS_RM unset, then
    ADGS_RM=1 for that call only), launch counts reset just before each
    and read just after. PNGs bitwise equal across layouts, PSNR/SSIM
    finite and equal. Returns {layout: (results, launches)}."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import torch
    from PIL import Image
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.cli import common as cli_common
    from adgs_tpu_torch.cli import render as cli_render
    from adgs_tpu_torch.train import checkpoint as ckpt
    from adgs_tpu_torch.train.config import OptimizationConfig

    times = np.linspace(0.0, 1.0, CLI_TIMESTAMPS)
    capacity, nr = size_capacity(cfg, params, state,
                                 [c.at_time(float(t)) for c in cams
                                  for t in times])
    out = {}
    with tempfile.TemporaryDirectory(prefix="adgs_cli_") as tmp:
        t0 = time.perf_counter()
        scene = os.path.join(tmp, "scene")
        model = os.path.join(tmp, "model")
        n_obj = int(state.obj_alive.sum())
        pts = torch.cat([params.scene_xyz[:CLI_POINTS // 2],
                         params.obj_xyz[:min(n_obj, CLI_POINTS // 2)]])
        write_cli_scene(scene, seed, poses, WIDTH, HEIGHT,
                        pts.cpu().numpy())
        base = os.path.join(model, "point_cloud", f"iteration_{ITERATION}")
        ckpt.save_ply(os.path.join(base, "point_cloud.ply"), params, state,
                      cfg)
        np.save(os.path.join(base, "env.npy"), env.grid.cpu().numpy())
        cli_common.save_cfg_args(model, cli_common.ModelConfig(
            source_path=scene, model_path=model, sh_degree=cfg.sh_degree,
            capacity=capacity, env_resolution=env.grid.shape[-1],
            order_args=KITTI_75), OptimizationConfig())
        log(f"# cli.render: checkpoint and scene written in "
            f"{time.perf_counter() - t0:.1f} s ({len(times) * len(cams)} "
            f"frames, capacity {capacity} for max num_rendered {nr})")
        for layout in ("gather", "rows"):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            _kernels.reset_launches()
            if layout == "rows":
                os.environ["ADGS_RM"] = "1"
            try:
                cli_render.main(["-m", model, "--device", str(dev)])
            finally:
                os.environ.pop("ADGS_RM", None)
            torch.cuda.synchronize()
            launches = dict(_kernels.launches)
            res = {}
            for split, name in (("train", "results-train.json"),
                                ("test", "results.json")):
                with open(os.path.join(model, name)) as f:
                    res[split] = json.load(f)[f"ours_{ITERATION}"]
                os.replace(os.path.join(model, split),
                           os.path.join(model, f"{split}_{layout}"))
            log(f"# cli.render, layout {layout}: "
                f"{time.perf_counter() - t0:.1f} s; launches {launches}; "
                + "; ".join(f"{k}: " + json.dumps(v)
                            for k, v in res.items()))
            out[layout] = (res, launches)
        n_png = 0
        for split in ("train", "test"):
            for kind in ("renders", "gt"):
                d = os.path.join(f"{split}_gather", f"ours_{ITERATION}", kind)
                names = sorted(os.listdir(os.path.join(model, d)))
                for f in names:
                    a = np.asarray(Image.open(os.path.join(model, d, f)))
                    b = np.asarray(Image.open(os.path.join(
                        model, d.replace("_gather", "_rows"), f)))
                    if a.shape != (HEIGHT, WIDTH, 3) or not np.array_equal(
                            a, b):
                        raise AssertionError(f"cli.render {split} {kind} {f}:"
                                             " PNGs differ across layouts")
                    n_png += 1
            rg, rr = out["gather"][0][split], out["rows"][0][split]
            for k in ("PSNR", "SSIM"):
                if not (math.isfinite(rg[k]) and rg[k] == rr[k]):
                    raise AssertionError(f"cli.render {split} {k}: "
                                         f"{rg[k]} vs {rr[k]}")
        log(f"  cli.render: {n_png} PNGs bitwise equal across layouts; "
            "PSNR and SSIM equal")
        shutil.rmtree(model)
    return out


# the trainer phase: a KITTI-format scene whose reader leaves ~1M
# Gaussians, trained through adgs_tpu_torch.cli.train
TRAIN_SCENE_POINTS = 700_000   # one per 0.5-unit voxel (the KITTI voxel)
TRAIN_OBJ_POINTS = 3_000_000   # the KITTI reader keeps 10% of them
TRAIN_CARS = 60                # car-sized boxes holding the object points
TRAIN_DEPTH = (15.0, 90.0)     # depths of the scene points
TRAIN_ITERS = 40
# The default densify thresholds (2e-4) write nothing on this scene: on
# an H100 no Gaussian's mean screen gradient at the first densify passes
# 1e-5 (max 5.6e-6 scene, 3.6e-6 object; the densify lines log them).
# These sit near that densify's 99th percentiles (2.0e-8, 4.9e-8).
TRAIN_GRAD_ARGS = ["--densify_scene_grad_threshold", "2e-8",
                   "--densify_obj_grad_threshold", "5e-8"]


def train_args() -> list:
    """cli.train's arguments after -s, -m, --seed and --device: the
    KITTI-75 preset at SH degree 3 and the full sky, every loss term on
    (OptimizationConfig's defaults), ModelConfig's instance capacity, and
    a schedule that densifies, resets opacity and refreshes the KNN
    groups within TRAIN_ITERS iterations."""
    n = str(TRAIN_ITERS)
    return (["-c", "configs/kitti-75.py", "--sh_degree", "3",
             "--env_resolution", str(ENV_RES), "--iterations", n,
             "--densification_interval", "10", "--densify_from_iter", "0",
             "--opacity_reset_interval", "20",
             "--near_idx_reset_interval", "5", "--test_iterations", n,
             "--save_iterations", n] + TRAIN_GRAD_ARGS)


def train_scene_points(seed, cams, n_scene, n_obj):
    """The trainer phase's init cloud, all in view of both cameras:
    n_scene scene points, one in each of as many distinct 0.5-unit voxels
    at depths TRAIN_DEPTH, then n_obj object points in TRAIN_CARS
    4 x 2 x 1.5 boxes at depths 12-40. Returns (points [M, 3] float32,
    object flags [M])."""
    rng = np.random.default_rng(seed + 3)
    mats = [(c.world_view.cpu().numpy().astype(np.float64),
             c.full_proj.cpu().numpy().astype(np.float64)) for c in cams]

    def in_view(p, margin, near, far=np.inf):
        h = np.concatenate([p, np.ones((len(p), 1))], axis=1)
        ok = np.ones(len(p), bool)
        for wv, fp in mats:
            z = (h @ wv)[:, 2]
            q = h @ fp
            ok &= ((z > near) & (z < far)
                   & (np.abs(q[:, 0]) < margin * q[:, 3])
                   & (np.abs(q[:, 1]) < margin * q[:, 3]))
        return ok

    v = 0.5
    far = TRAIN_DEPTH[1]
    grid = np.stack(np.meshgrid(np.arange(-8.0, far, v),
                                np.arange(-far, far, v),
                                np.arange(-far / 3, far / 3, v),
                                indexing="ij"), -1).reshape(-1, 3)
    grid = grid[in_view(grid + v / 2, 0.95, TRAIN_DEPTH[0], far)]
    if len(grid) < n_scene:
        raise AssertionError(f"{len(grid)} voxels in view, {n_scene} wanted")
    corner = grid[rng.choice(len(grid), n_scene, replace=False)]
    scene = corner + rng.uniform(0.1, 0.9, corner.shape) * v
    cars = []
    while len(cars) < TRAIN_CARS:
        c = np.array([rng.uniform(4.0, 32.0), rng.uniform(-12.0, 12.0),
                      rng.uniform(-3.0, 1.0)])
        if in_view(c[None], 0.7, 10.0)[0]:
            cars.append(c)
    per = -(-n_obj // TRAIN_CARS)
    obj = np.concatenate([c + (rng.random((per, 3)) - 0.5)
                          * np.array([4.0, 2.0, 1.5]) for c in cars])[:n_obj]
    points = np.concatenate([scene, obj]).astype(np.float32)
    flags = np.concatenate([np.zeros(n_scene), np.ones(n_obj)])
    return points, flags.astype(np.float32)


def cuda_timed(fn):
    """(fn()'s result, the CUDA-event ms from before it to after it)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


class TrainProbe:
    """Wraps what an entry point runs (read_scene, Trainer, its step,
    densify, opacity reset, KNN refresh, capacity growths, evaluate, save)
    to check each call and time it; `entry` is the module whose read_scene
    and Trainer it calls (cli.train unless given). `restore` puts every
    wrapped function back."""

    def __init__(self, entry=None):
        import torch
        from adgs_tpu_torch.cli import train as cli_train
        from adgs_tpu_torch.train import densify as densify_mod
        from adgs_tpu_torch.train.trainer import MetricsLogger, Trainer
        self.torch = torch
        self.trainer = None
        self.seconds = {"read_scene": 0.0, "Trainer init": 0.0,
                        "evaluation": 0.0, "save": 0.0}
        self.panel_s = 0.0
        self.steps, self.densify, self.resets, self.refreshes = [], [], [], []
        self.grows, self.instance_grows, self.eval_renders = [], [], []
        self.recall = None
        self._patches = []
        p = self._patch
        entry = entry or cli_train
        p(entry, "read_scene", self._read_scene)
        p(entry, "Trainer", self._make_trainer)
        p(densify_mod, "densify_and_prune", self._densify_and_prune)
        p(densify_mod, "reset_opacity", self._reset_opacity)
        p(densify_mod, "grow_capacity", self._grow_capacity)
        p(MetricsLogger, "image", self._image)
        for name in ("_build_step", "refresh_near_idx",
                     "_maybe_grow_instance_capacity", "eval_render_fn",
                     "evaluate", "save"):
            p(Trainer, name, getattr(self, name.lstrip("_") + "_"))

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._patches.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def restore(self):
        for owner, name, orig in reversed(self._patches):
            setattr(owner, name, orig)
        self._patches = []

    def _timed_s(self, part, fn):
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.seconds[part] += time.perf_counter() - t0
        return out

    def _read_scene(self, orig):
        def read_scene(*a, **k):
            scene = self._timed_s("read_scene", lambda: orig(*a, **k))
            n_obj = int((scene.obj_id > 0.5).sum())
            log(f"#   read_scene: {len(scene.points)} Gaussians "
                f"({len(scene.points) - n_obj} scene, {n_obj} object, "
                f"{n_obj / len(scene.points):.1%}); extent scene "
                f"{scene.scene_extent:.2f}, cameras {scene.cameras_extent:.2f}")
            return scene
        return read_scene

    def _image(self, orig):
        def image(logger, *a, **k):
            t0 = time.perf_counter()
            orig(logger, *a, **k)
            self.panel_s += time.perf_counter() - t0
        return image

    def _make_trainer(self, orig):
        def make(*a, **k):
            self.trainer = self._timed_s("Trainer init", lambda: orig(*a, **k))
            return self.trainer
        return make

    def build_step_(self, orig):
        probe = self

        def build(tr):
            orig(tr)
            step = tr._step_fn

            def timed_step(*a, **k):
                t0 = time.perf_counter()
                out = step(*a, **k)
                probe.torch.cuda.synchronize()
                probe.steps.append((tr.iteration,
                                    (time.perf_counter() - t0) * 1e3,
                                    out[4]["total_loss"]))
                return out
            tr._step_fn = timed_step
        return build

    def _densify_and_prune(self, orig):
        def densify(trainables, opt_state, state, generator, *args):
            (max_scene_grad, max_obj_grad, _, prune_big, scene_extent,
             object_extent, percent_dense) = args
            torch = self.torch
            g = trainables.gaussians
            grads = state.xyz_grad_accum / torch.clamp(state.denom, min=1e-12)
            grads = torch.where(state.denom > 0, grads, 0.0)
            Ns = g.scene_capacity
            blocks = (("scene", state.scene_alive, grads[:Ns], max_scene_grad,
                       scene_extent), ("obj", state.obj_alive, grads[Ns:],
                                       max_obj_grad, object_extent))
            pre = {}
            for name, alive, gr, thr, extent in blocks:
                big = (torch.amax(torch.exp(getattr(g, name + "_scaling")),
                                  -1) > extent * percent_dense)
                dens = (gr >= thr) & alive
                q = torch.quantile(gr[alive][:1 << 24].double(),
                                   torch.tensor([0.5, 0.99, 1.0],
                                                dtype=torch.float64,
                                                device=gr.device))
                pre[name] = dict(alive=alive.clone(), n=int(alive.sum()),
                                 clone=int((dens & ~big).sum()),
                                 split=int((dens & big).sum()),
                                 over=int(dens.sum()),
                                 grad_q=[float(x) for x in q])
            out, ms = cuda_timed(lambda: orig(trainables, opt_state, state,
                                              generator, *args))
            t2, o2, s2, rep = out
            rep = {k: int(v) for k, v in rep._asdict().items()}
            from adgs_tpu_torch.train.densify import OBJ_FIELDS, SCENE_FIELDS
            for (name, *_), fields in zip(blocks, (SCENE_FIELDS, OBJ_FIELDS)):
                b = pre[name]
                after = getattr(s2, name + "_alive")
                n_after = int(after.sum())
                want = (b["n"] + rep[name + "_cloned"] + rep[name + "_split"]
                        - b["split"] - rep[name + "_pruned"])
                if n_after != want:
                    raise AssertionError(
                        f"densify, {name}: {n_after} alive after, "
                        f"{b['n']} + {rep[name + '_cloned']} + "
                        f"{rep[name + '_split']} - {b['split']} - "
                        f"{rep[name + '_pruned']} = {want} expected")
                if (rep[name + "_cloned"] + rep[name + "_split"]
                        + rep[name + "_dropped"]
                        != b["clone"] + 2 * b["split"]):
                    raise AssertionError(f"densify, {name}: copies written "
                                         "and dropped do not add up")
                new = after & ~b["alive"]
                for f in fields:
                    for mom in (o2.m.gaussians, o2.v.gaussians):
                        if bool(getattr(mom, f)[new].any()):
                            raise AssertionError(
                                f"densify: moment of {f} not zero in a new "
                                "slot")
                b["new"] = int(new.sum())
            rec = dict(iteration=self.trainer.iteration, device_ms=ms,
                       report=rep, prune_big=bool(prune_big),
                       over_threshold={k: (v["over"], v["n"])
                                       for k, v in pre.items()},
                       grad_median_p99_max={k: v["grad_q"]
                                            for k, v in pre.items()})
            self.densify.append(rec)
            log(f"#   densify at {rec['iteration']}: {ms:.3f} device ms; "
                f"{json.dumps(rep)}; over the grad threshold (of alive): "
                f"{json.dumps(rec['over_threshold'])}, grads (median, "
                f"p99, max) {json.dumps(rec['grad_median_p99_max'])}; "
                "new slots "
                f"{pre['scene']['new']} + {pre['obj']['new']}, moments zero; "
                "alive counts add up")
            return t2, o2, s2, out[3]
        return densify

    def _reset_opacity(self, orig):
        def reset(trainables, opt_state):
            torch = self.torch
            (t2, o2), ms = cuda_timed(lambda: orig(trainables, opt_state))
            st = self.trainer.state
            g = t2.gaussians
            act = torch.sigmoid(torch.cat([g.scene_opacity[st.scene_alive],
                                           g.obj_opacity[st.obj_alive]]))
            # the JAX test's bar: 0.01 + 1e-6 (logit and sigmoid round)
            if float(act.max()) > 0.01 + 1e-6:
                raise AssertionError(f"opacity reset: max alive opacity "
                                     f"{float(act.max())}")
            for mom in (o2.m.gaussians, o2.v.gaussians):
                if bool(mom.scene_opacity.any() | mom.obj_opacity.any()):
                    raise AssertionError("opacity reset: moments not zero")
            self.resets.append((self.trainer.iteration, ms))
            log(f"#   opacity reset at {self.trainer.iteration}: {ms:.3f} "
                f"device ms; max alive opacity {float(act.max()):.6f}, "
                "opacity moments zero")
            return t2, o2
        return reset

    def _grow_capacity(self, orig):
        def grow(trainables, opt_state, state, ns, no):
            g = trainables.gaussians
            out, ms = cuda_timed(lambda: orig(trainables, opt_state, state,
                                              ns, no))
            rec = (self.trainer.iteration, g.scene_capacity, g.obj_capacity,
                   ns, no, ms)
            self.grows.append(rec)
            log(f"#   Gaussian capacity at {rec[0]}: scene {rec[1]} -> "
                f"{ns}, obj {rec[2]} -> {no}; {ms:.3f} device ms")
            return out
        return grow

    def refresh_near_idx_(self, orig):
        probe = self

        def refresh(tr):
            _, ms = cuda_timed(lambda: orig(tr))
            probe.check_refresh(tr, ms)
        return refresh

    def check_refresh(self, tr, ms):
        """Every index of a valid group is an alive object slot and the
        valid count is min(a_cap, n_alive // K); on the second refresh,
        the groups' recall of the exact KNN of the same anchors."""
        torch = self.torch
        st = tr.state
        K = tr.opt.near_num
        a_cap = max(1, tr.params.obj_capacity // K)
        idx, valid = st.obj_near_idx, st.obj_near_valid
        n_alive = int(st.obj_alive.sum())
        n_valid = int(valid.sum())
        if tuple(idx.shape) != (a_cap, K) or n_valid != min(a_cap,
                                                              n_alive // K):
            raise AssertionError(f"KNN refresh: {tuple(idx.shape)} groups, "
                                 f"{n_valid} valid for {n_alive} alive")
        groups = idx[valid].long()
        if not bool(st.obj_alive[groups].all()):
            raise AssertionError("KNN refresh: a group holds a dead slot")
        rec = dict(iteration=tr.iteration, device_ms=ms, valid=n_valid)
        if len(self.refreshes) == 1:
            from adgs_tpu_torch.ops.knn import knn_indices
            pts = tr.params.obj_xyz
            if tr.config.use_time_mask:
                pts = torch.cat([pts, st.gs_time[:, None]
                                 * tr.scene.scene_extent], 1)
            alive_slots = torch.nonzero(st.obj_alive)[:, 0]
            live = pts[alive_slots].cpu().numpy()
            g = groups.cpu().numpy()
            pos = torch.searchsorted(alive_slots,
                                     groups[:, 0].contiguous()).cpu().numpy()
            exact = alive_slots.cpu().numpy()[knn_indices(live[pos], live,
                                                          K)]
            rec["recall"] = self.recall = float(np.mean(
                [len(set(a) & set(b)) / K for a, b in zip(g.tolist(),
                                                          exact.tolist())]))
        self.refreshes.append(rec)
        log(f"#   KNN refresh at {tr.iteration}: {ms:.3f} device ms; "
            f"{n_valid} valid groups of {K} over {n_alive} alive, all "
            "alive object slots"
            + (f"; recall of the exact KNN {rec['recall']:.4f}"
               if "recall" in rec else ""))

    def maybe_grow_instance_capacity_(self, orig):
        probe = self

        def grow(tr, num_rendered):
            old = tr.capacity
            orig(tr, num_rendered)
            if tr.capacity != old:
                probe.instance_grows.append(
                    (tr.iteration, num_rendered, old, tr.capacity,
                     num_rendered > old))
                log(f"#   instance capacity at {tr.iteration}: {old} -> "
                    f"{tr.capacity} for num_rendered {num_rendered}"
                    + (" (overflow guard)" if num_rendered > old else ""))
        return grow

    def eval_render_fn_(self, orig):
        def eval_render_fn(tr):
            fn = orig(tr)

            def timed(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self.torch.cuda.synchronize()
                self.eval_renders.append(time.perf_counter() - t0)
                return out
            return timed
        return eval_render_fn

    def evaluate_(self, orig):
        def evaluate(tr, *a, **k):
            return self._timed_s("evaluation", lambda: orig(tr, *a, **k))
        return evaluate

    def save_(self, orig):
        def save(tr, *a, **k):
            return self._timed_s("save", lambda: orig(tr, *a, **k))
        return save


def trainer_phase(cams, seed, dev, card):
    """adgs_tpu_torch.cli.train at full width on a KITTI-format scene
    (1242x375, KITTI P2's focal, the two poses, 10 frames: 8 train, 2
    test) whose reader leaves ~1M Gaussians (~30% object), then cli.render
    on the checkpoint; the checks and logs of TrainProbe, the launch
    counts reset just before, and test frame 0 rendered at full SH degree
    in memory and by cli.render within 1/255. Returns a summary."""
    import gc
    import os
    import tempfile
    import torch
    from PIL import Image
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.cli import render as cli_render
    from adgs_tpu_torch.cli import train as cli_train
    from adgs_tpu_torch.render import make_staged_render_fn

    here = os.path.dirname(os.path.abspath(__file__))
    args = [a if a != "configs/kitti-75.py" else os.path.join(here, a)
            for a in train_args()]
    log(f"# trainer ({card}): cli.train " + " ".join(train_args()))
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="adgs_train_") as tmp:
        t0 = time.perf_counter()
        scene = os.path.join(tmp, "scene")
        model = os.path.join(tmp, "model")
        pts, obj = train_scene_points(seed, cams, TRAIN_SCENE_POINTS,
                                      TRAIN_OBJ_POINTS)
        write_cli_scene(scene, seed, camera_poses(), WIDTH, HEIGHT, pts, obj)
        seconds["scene write"] = time.perf_counter() - t0
        log(f"#   scene: {len(pts) - int(obj.sum())} scene points on "
            f"distinct voxels, {int(obj.sum())} object points in "
            f"{TRAIN_CARS} boxes, written in {seconds['scene write']:.1f} s")
        del pts, obj

        probe = TrainProbe()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            trainer = cli_train.main(["-s", scene, "-m", model, "--seed",
                                      str(seed), "--device", str(dev)] + args)
            torch.cuda.synchronize()
        finally:
            probe.restore()
            probe.trainer = None
        total = time.perf_counter() - t0
        launches = dict(_kernels.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        seconds.update(probe.seconds)
        seconds["training"] = total - sum(probe.seconds.values())
        seconds["evaluation renders"] = sum(probe.eval_renders)
        # TensorBoard's image panels, where it imports (PNG encoding)
        seconds["evaluation panels"] = probe.panel_s

        # the checks of the run as a whole
        log(f"#   launches {launches}")
        check_launched("cli.train", launches, TRAINING_KERNELS)
        losses = torch.stack([s[2] for s in probe.steps]).cpu().numpy()
        if len(losses) != trainer.iteration or not np.isfinite(losses).all():
            raise AssertionError(f"cli.train losses: {losses}")
        if not any(g[4] for g in probe.instance_grows):
            raise AssertionError("no instance-capacity growth by the "
                                 "overflow guard")
        if not probe.grows:
            raise AssertionError("no Gaussian-capacity growth")
        reps = [d["report"] for d in probe.densify]
        if not any(r["scene_cloned"] + r["obj_cloned"] for r in reps):
            raise AssertionError("no densify wrote clones")
        if not any(r["scene_split"] + r["obj_split"] for r in reps):
            raise AssertionError("no densify wrote splits")
        if not probe.resets or probe.recall is None:
            raise AssertionError("no opacity reset or no KNN refresh")

        # test frame 0 at full SH degree: in memory, then by cli.render
        cfg = trainer.config
        fn = make_staged_render_fn(cfg, active_sh_degree=cfg.sh_degree,
                                   inv_depth=trainer.inv_depth,
                                   capacity=trainer.capacity,
                                   layout=trainer.layout)
        cam, _, _ = trainer._get_frame("test", 0)
        rays = trainer._rays_for(cam, trainer.scene.test_frames[0].cam_id)
        out = fn(cam, trainer.params, trainer.state, trainer.env, rays)
        mem = cli_render._to_uint8(torch.clamp(out["render"], 0.0, 1.0))
        it = trainer.iteration
        n_alive = int(trainer.state.num_scene) + int(trainer.state.num_obj)
        ms_ema = trainer.timer.ema_s * 1e3
        del out, fn, trainer
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cli_render.main(["-m", model, "--skip_train", "--device", str(dev)])
        torch.cuda.synchronize()
        seconds["render"] = time.perf_counter() - t0
        png = np.asarray(Image.open(os.path.join(
            model, "test", f"ours_{it}", "renders", "00000.png")))
        diff = np.abs(png.astype(np.int32) - mem.astype(np.int32))
        log(f"#   test frame 0, in memory vs cli.render's PNG: max "
            f"{int(diff.max())}/255, {int((diff > 0).sum())} of {diff.size} "
            "values differ")
        if png.shape != mem.shape or diff.max() > 1:
            raise AssertionError("cli.render's PNG differs from the "
                                 "in-memory render by more than 1/255")
        with open(os.path.join(model, "results.json")) as f:
            res = json.load(f)[f"ours_{it}"]

    dens_its = {d["iteration"] for d in probe.densify}
    plain = [s[1] for s in probe.steps if s[0] not in dens_its and s[0] > 1]
    summary = dict(
        seconds={k: round(v, 3) for k, v in seconds.items()},
        steps=len(probe.steps), alive_after=n_alive,
        step_timer_ms=ms_ema, median_step_ms_no_densify=float(np.median(plain)),
        step_ms=[round(s[1], 3) for s in probe.steps],
        losses=[round(float(x), 6) for x in losses],
        densify=probe.densify, resets=probe.resets,
        refreshes=probe.refreshes, knn_recall=probe.recall,
        gaussian_growths=probe.grows, instance_growths=probe.instance_grows,
        peak_gb=peak_gb, cli_render=res)
    log(f"# trainer ({card}): " + json.dumps(summary))
    log(f"# trainer ({card}): StepTimer {ms_ema:.3f} ms/step (EMA), median "
        f"{summary['median_step_ms_no_densify']:.3f} ms over "
        f"{len(plain)} steps without densify; peak {peak_gb:.2f} GB; "
        f"seconds {json.dumps(summary['seconds'])}")
    return summary


# the quality gate: adgs_tpu_torch.scripts.quality_gate at the JAX gate's
# defaults (scripts/quality_gate.py), held to its assertions and printed
# beside the TPU's curve in QUALITY_r05.json
GATE = dict(width=256, height=160, n_frames=16, n_gt=6000)
GATE_ITERS, GATE_EVAL_EVERY = 2000, 250
GATE_MIN_GAIN_DB, GATE_MIN_FINAL_DB = 4.0, 22.0


def gate_phase(seed, dev, card):
    """The port's quality gate on the card: build_gt_scene, then
    quality_gate.main on it (2,000 iterations, evaluations every 250) under
    TrainProbe's checks and timers, the launch counts reset just before;
    JAX's assertions (finite, monotone within 0.5 dB, gain and final PSNR),
    the curve beside the TPU's, then kernel parity at the gate's shapes on
    the trained model. Returns a summary."""
    import os
    import tempfile
    import torch
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.scripts import quality_gate as qg

    here = os.path.dirname(os.path.abspath(__file__))
    args = [f"--{k}={v}" for k, v in GATE.items()] + [
        f"--iters={GATE_ITERS}", f"--eval_every={GATE_EVAL_EVERY}",
        f"--min_gain_db={GATE_MIN_GAIN_DB}",
        f"--min_final_db={GATE_MIN_FINAL_DB}", f"--device={dev}"]
    log(f"# quality gate ({card}): quality_gate " + " ".join(args))
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="adgs_gate_") as tmp:
        t0 = time.perf_counter()
        nr = qg.build_gt_scene(os.path.join(tmp, "scene"), **GATE, seed=seed,
                               device=dev)
        torch.cuda.synchronize()
        seconds["scene build"] = time.perf_counter() - t0
        log(f"#   ground truth: {GATE['n_frames'] * 2} renders, largest "
            f"num_rendered {nr} of its capacity {qg.GT_CAPACITY}, "
            f"{seconds['scene build']:.3f} s")
        probe = TrainProbe(qg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            # main asserts as the JAX gate does (check_gate) and raises
            result = qg.main(args + ["--scene_dir", tmp, "--out",
                                     os.path.join(tmp, "QUALITY.json")])
            torch.cuda.synchronize()
            trainer = probe.trainer
        finally:
            probe.restore()
            probe.trainer = None
        total = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seconds.update(probe.seconds)
    seconds["training"] = total - sum(probe.seconds.values())
    seconds["evaluation renders"] = sum(probe.eval_renders)
    seconds["evaluation panels"] = probe.panel_s
    log(f"#   launches {launches}")
    check_launched("quality gate", launches, TRAINING_KERNELS)
    losses = torch.stack([s[2] for s in probe.steps]).cpu().numpy()
    if len(losses) != GATE_ITERS or not np.isfinite(losses).all():
        raise AssertionError(f"quality gate: {len(losses)} steps, losses "
                             f"finite: {bool(np.isfinite(losses).all())}")

    with open(os.path.join(here, "QUALITY_r05.json")) as f:
        tpu = json.load(f)
    log("#   curve (iteration: test PSNR, train PSNR, test SSIM; the port "
        "on this card | the JAX package on a TPU v5e, QUALITY_r05.json):")
    for i, it in enumerate(result["iters"]):
        j = tpu["iters"].index(it) if it in tpu["iters"] else None
        theirs = ("none" if j is None else
                  f"{tpu['test_psnr'][j]:.3f}, {tpu['train_psnr'][j]:.3f}, "
                  f"{tpu['test_ssim'][j]:.4f}")
        log(f"#     {it:5d}: {result['test_psnr'][i]:.3f}, "
            f"{result['train_psnr'][i]:.3f}, {result['test_ssim'][i]:.4f} | "
            f"{theirs}")
    log(f"#   final test PSNR {result['final_test_psnr']:.3f} (TPU "
        f"{tpu['final_test_psnr']:.3f}, difference "
        f"{result['final_test_psnr'] - tpu['final_test_psnr']:+.3f} dB), "
        f"gain {result['gain_db']:.3f} dB, monotone {result['monotone_ok']}")

    dens_its = {d["iteration"] for d in probe.densify}
    plain = [s[1] for s in probe.steps if s[0] not in dens_its and s[0] > 1]
    reps = [d["report"] for d in probe.densify]
    summary = dict(
        seconds={k: round(v, 3) for k, v in seconds.items()},
        steps=len(probe.steps), step_timer_ms=trainer.timer.ema_s * 1e3,
        median_step_ms_no_densify=float(np.median(plain)),
        step_ms_p10_p90=[float(np.percentile(plain, q)) for q in (10, 90)],
        alive_after=int(trainer.state.num_scene) + int(trainer.state.num_obj),
        densifies=len(reps),
        cloned=sum(r["scene_cloned"] + r["obj_cloned"] for r in reps),
        split=sum(r["scene_split"] + r["obj_split"] for r in reps),
        pruned=sum(r["scene_pruned"] + r["obj_pruned"] for r in reps),
        gaussian_growths=probe.grows, instance_growths=probe.instance_grows,
        refreshes=len(probe.refreshes), knn_recall=probe.recall,
        gt_max_num_rendered=nr, peak_gb=peak_gb, launches=launches,
        curve=result)
    log(f"# quality gate ({card}): " + json.dumps(summary))
    log(f"# quality gate ({card}): StepTimer "
        f"{summary['step_timer_ms']:.3f} ms/step (EMA), median "
        f"{summary['median_step_ms_no_densify']:.3f} ms over {len(plain)} "
        f"steps without densify; {len(reps)} densifies wrote "
        f"{summary['cloned']} clones and {summary['split']} splits; peak "
        f"{peak_gb:.2f} GB; seconds {json.dumps(summary['seconds'])}")
    gate_kernel_parity(trainer, seed)
    return summary


def gate_kernel_parity(tr, seed) -> None:
    """B3, B4, B7 and B8 against their twins at the gate's shapes, on the
    trained model and training frame 0: B3 at ch=4 and ch=8 (1e-4, final
    T bitwise its serial replay), B4 at ch=8 with N(0,1) cotangents (rtol
    1e-3, atol 1e-5 max|twin|, into buffers of NaN, its tile order and
    its zero rows bitwise), B7 bitwise and B8 as check_sky_scatter holds it
    on the 3x512^2 sky at the frame's coords and at sky_coord_cases', also
    at C = 1."""
    import torch
    from adgs_tpu_torch.ops import grid_sample as gs
    from adgs_tpu_torch.raster import render as rl

    cam, _, _ = tr._get_frame("train", 0)
    rays = tr._rays_for(cam, tr.scene.train_frames[0].cam_id)
    with torch.no_grad():
        st, prep, binning = frame_inputs(tr.config, tr.params, tr.state, cam,
                                         tr.capacity)
    nr = int(binning.num_rendered)
    tc = tile_count_stats(binning.tile_count)
    log(f"# kernel parity at the gate's shapes: frame {st.image_width}x"
        f"{st.image_height}, {tc['tiles']} tiles, {nr} instances (capacity "
        f"{tr.capacity}); per tile mean {tc['mean']:.1f}, p99 "
        f"{tc['p99']:.1f}, max {tc['max']}; sky {tuple(tr.env.grid.shape)}")
    if nr > tr.capacity:
        raise AssertionError("gate frame: instance overflow")
    gen = torch.Generator(device=prep.mean2d.device).manual_seed(seed)
    for ch in (4, 8):
        with torch.no_grad():
            packed = composite_rows(tr.config, tr.params, prep,
                                    cam.time + 0.01, ch)
        fargs = (packed, ch, binning.gauss_id, binning.tile_start,
                 binning.tile_count, st.grid_x)
        blended, final_t = rl.composite_fwd(*fargs)
        bp, tp = rl.composite_fwd_torch(*fargs)
        check_close(f"B3 gate ch={ch} blended", blended, bp, 1e-4, 1e-4)
        check_close(f"B3 gate ch={ch} final_t", final_t, tp, 1e-4, 1e-4)
        check_final_t(f"B3 gate ch={ch} final_t", final_t,
                      rl.composite_final_t_serial(*fargs))
    # B4 at the training width (ch=8, the last packed above)
    fwd_out = torch.cat([blended, final_t[:, None]], 1).contiguous()
    g_out = torch.randn(fwd_out.shape, generator=gen, device=fwd_out.device)
    bargs = (packed, ch, binning.gauss_id, binning.slot_sorted,
             binning.tile_start, binning.tile_count, st.grid_x, fwd_out, g_out)
    rows, order = b4_buffers(binning, ch, packed.device)
    rl.composite_bwd_into(rows, order, *bargs)
    check_bitwise("B4 gate tile order (longest first) vs a stable sort",
                  order, torch.sort(binning.tile_count, descending=True,
                                    stable=True).indices.to(torch.int32))
    total = int(binning.tile_start[-1] + binning.tile_count[-1])
    check_bitwise(f"B4 gate rows past the {total} valid instances: zeros",
                  rows[total:], torch.zeros_like(rows[total:]))
    rows_p = rl.composite_bwd_torch(*bargs)
    check_close("B4 gate composite_bwd rows", rows, rows_p,
                1e-5 * float(rows_p.abs().max()), 1e-3)

    grid = tr.env.grid
    coords = sky_coords(rays, cam)
    shape = tuple(grid.shape)
    grid1 = grid[:1].contiguous()
    cases = [("gate's sky coords", coords)] + sky_coord_cases(coords, shape,
                                                              gen)
    g_sky = torch.randn((shape[0],) + tuple(coords.shape[:-1]), generator=gen,
                        device=grid.device)
    for label, c in cases:
        check_bitwise(f"B7 gate grid_sample vs its twin ({label})",
                      gs.grid_sample(grid, c), gs.grid_sample_torch(grid, c))
        check_bitwise(f"B7 gate grid_sample vs its twin ({label}, C=1)",
                      gs.grid_sample(grid1, c), gs.grid_sample_torch(grid1, c))
        check_sky_scatter(f"gate, {label}", g_sky, c, shape)
        check_sky_scatter(f"gate, {label}, C=1", g_sky[:1].contiguous(), c,
                          (1,) + shape[1:])


def serve_phase(cfg, params, state, env, rays, reqs, capacity,
                layout="gather"):
    """The serving path: every request through make_staged_render_fn, with
    CUDA-event stage marks recorded inside each request. Returns the
    outputs, each request's marks (adgs_tpu_torch._stages) and the launch
    counts."""
    import torch
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.render import make_staged_render_fn

    fn = make_staged_render_fn(cfg, capacity=capacity, layout=layout)
    fn(reqs[0], params, state, env, rays)         # warm-up (allocator, libs)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    outs, marks = [], []
    for cam in reqs:
        m = []
        outs.append(fn(cam, params, state, env, rays, stage_marks=m))
        marks.append(m)
    torch.cuda.synchronize()
    return outs, marks, dict(_kernels.launches)


def check_outputs(outs, reqs, width, height):
    import torch
    for i, out in enumerate(outs):
        shapes = {"render": (3, height, width), "foreground": (3, height, width),
                  "background": (3, height, width), "depth": (height, width),
                  "img_opacity": (height, width)}
        for k, shp in shapes.items():
            if tuple(out[k].shape) != shp:
                raise AssertionError(f"frame {i}: {k} shape "
                                     f"{tuple(out[k].shape)} != {shp}")
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"frame {i}: {k} not finite")
        if float(out["img_opacity"].max()) <= 0.5:
            raise AssertionError(f"frame {i}: the scene is not on screen")


def train_inputs(device, seed, params, state, width, height):
    """bench.py's frame batch (uniform image, depth of ones, sky of zeros,
    30% object pixels, a uniform flow target at time 0.35) and the KNN
    groups of its regularizer variant: obj_capacity // 8 anchors of 8
    neighbours among the alive object Gaussians (the port's exact
    ops/knn.knn_indices). Returns (batch, state)."""
    import dataclasses
    import torch
    from adgs_tpu_torch.ops.flow import FlowPackage
    from adgs_tpu_torch.ops.knn import knn_indices
    from adgs_tpu_torch.train.losses import FrameBatch

    rng = np.random.default_rng(seed + 1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    fx = 0.5 * width / np.tan(0.6)
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]])
    batch = FrameBatch(
        image=t(rng.uniform(size=(3, height, width))),
        depth=t(np.ones((height, width))), sky=t(np.zeros((height, width))),
        semantic=t(rng.random((height, width)) < 0.3),
        flow=FlowPackage(time=t(0.35), K=t(K), R=t(np.eye(3)),
                         T=t(np.zeros(3)),
                         flow=t(rng.uniform(size=(2, height, width)) * width),
                         vis=t(np.ones((height, width)))),
        flow_valid=torch.tensor(True, device=device))

    k = 8
    alive = state.obj_alive.cpu().numpy()
    no = int(alive.sum())
    assert alive[:no].all()        # alive object Gaussians come first
    a_cap = max(1, params.obj_capacity // k)
    n_anchor = min(max(no // k, 1), a_cap)
    pts = params.obj_xyz[:no].cpu().numpy()
    anchors = rng.choice(no, n_anchor, replace=False)
    near = np.zeros((a_cap, k), np.int32)
    near[:n_anchor] = knn_indices(pts[anchors], pts, k)
    state = dataclasses.replace(
        state, obj_near_idx=torch.as_tensor(near, device=device),
        obj_near_valid=torch.as_tensor(np.arange(a_cap) < n_anchor,
                                       device=device))
    return batch, state


def make_step(cfg, capacity, backend=None, layout="gather"):
    from adgs_tpu_torch.train.config import OptimizationConfig
    from adgs_tpu_torch.train.step import make_train_step
    return make_train_step(cfg, OptimizationConfig(),
                           frame_gap=1.0 / FRAME_NUM,
                           scene_extent=SCENE_EXTENT,
                           cameras_extent=CAMERAS_EXTENT, capacity=capacity,
                           backend=backend, layout=layout)


def train_phase(step, start, cam, batch, rays, steps=STEPS):
    """The training path: `steps` steps from `start` (params, env,
    opt_state, state), each with CUDA-event stage marks recorded inside
    it. Returns each step's logs and marks and the launch counts."""
    import torch
    from adgs_tpu_torch import _kernels

    step(*start, cam, batch, rays, ITERATION)     # warm-up (allocator)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    p, e, o, s = start
    logs, marks = [], []
    for _ in range(steps):
        m = []
        p, e, o, s, lg = step(p, e, o, s, cam, batch, rays, ITERATION,
                              stage_marks=m)
        logs.append(lg)
        marks.append(m)
    torch.cuda.synchronize()
    return logs, marks, dict(_kernels.launches)


def check_train_logs(logs, capacity):
    import torch
    for i, lg in enumerate(logs):
        for k, v in lg.items():
            if k != "num_rendered" and not bool(torch.isfinite(v)):
                raise AssertionError(f"step {i}: {k} = {float(v)}")
        if int(lg["num_rendered"]) > capacity:
            raise AssertionError(f"step {i}: instance overflow "
                                 f"({int(lg['num_rendered'])} > {capacity})")


def _named_leaves(tr):
    import dataclasses
    from adgs_tpu_torch.train.optim import leaves
    names = [f.name for f in dataclasses.fields(tr.gaussians)] + ["env"]
    return list(zip(names, leaves(tr)))


def check_torch_backend(step, step_t, start, cam, batch, rays):
    """One step from `start` through the kernels and through the plain
    twins, held to tests/test_torch_train.py's bars."""
    import torch
    from adgs_tpu_torch.train.config import OptimizationConfig
    from adgs_tpu_torch.train.optim import TrainableState, leaves, lr_tree

    p, e, o, s = start
    args = (p, e, s, cam, batch, rays)
    lg_k = step.loss_and_grads(*args)
    lg_t = step_t.loss_and_grads(*args)
    for k in lg_k.logs:
        check_close(f"train {k} vs the torch backend", lg_k.logs[k],
                    lg_t.logs[k], 0.0, 1e-4)
    if not torch.equal(lg_k.num_rendered, lg_t.num_rendered):
        raise AssertionError("num_rendered disagrees with the torch backend")
    for (name, gk), (_, gt) in zip(_named_leaves(lg_k.grads),
                                   _named_leaves(lg_t.grads)):
        check_close(f"train grad {name} vs the torch backend", gk, gt,
                    2e-5, 5e-3)
    out_k = step(p, e, o, s, cam, batch, rays, ITERATION)
    out_t = step_t(p, e, o, s, cam, batch, rays, ITERATION)
    # Adam's first step is lr * g / |g|: where the gradient is rounding
    # noise its sign may flip and the parameter move by 2 lr
    lrs = leaves(lr_tree(OptimizationConfig(), SCENE_EXTENT, CAMERAS_EXTENT,
                         ITERATION))
    worst = 0.0
    for (name, pk), (_, pt), (_, gt), lr in zip(
            _named_leaves(TrainableState(out_k[0], out_k[1])),
            _named_leaves(TrainableState(out_t[0], out_t[1])),
            _named_leaves(lg_t.grads), lrs):
        bound = torch.where(gt.abs() < 2e-5, 2.0 * float(lr) + 1e-5,
                            torch.full_like(gt, 1e-5))
        diff = (pk - pt).abs()
        worst = max(worst, float(diff.max()))
        if not bool((diff <= bound).all()):
            raise AssertionError(f"updated {name} disagrees with the torch "
                                 f"backend: max |diff| {float(diff.max())}")
    log(f"  updated parameters vs the torch backend: max |diff| {worst:.3e} "
        "(atol 1e-5, 2 lr where |g| < 2e-5) ok")
    sk, st_ = out_k[3], out_t[3]
    for name in ("denom", "max_radii2d"):
        same = bool(torch.equal(getattr(sk, name), getattr(st_, name)))
        log(f"  stats {name} vs the torch backend: "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{name} disagrees with the torch backend")
    check_close("stats xyz_grad_accum vs the torch backend",
                sk.xyz_grad_accum, st_.xyz_grad_accum, 2e-5, 5e-3)
    return out_k


def check_repeat(step, start, cam, batch, rays, first,
                 what="repeat step"):
    """The same step again from the same inputs (or the step of another
    instance layout): every updated tensor must be bitwise equal (B4, B5,
    B8 and the regularizer's backward use no atomics). Returns the number
    of tensors compared."""
    import dataclasses
    import torch
    from adgs_tpu_torch.train.optim import TrainableState

    again = step(*start, cam, batch, rays, ITERATION)

    def tensors(out):
        p, e, o, s = out[:4]
        named = _named_leaves(TrainableState(p, e))
        named += [("m." + n, t) for n, t in _named_leaves(o.m)]
        named += [("v." + n, t) for n, t in _named_leaves(o.v)]
        named += [("state." + f.name, getattr(s, f.name))
                  for f in dataclasses.fields(s)]
        return named

    differ = []
    pairs = list(zip(tensors(first), tensors(again)))
    for (name, a), (_, b) in pairs:
        if not torch.equal(a, b):
            differ.append(f"{name} (max |diff| "
                          f"{float((a.float() - b.float()).abs().max()):.3e})")
    log(f"  {what}: {len(pairs)} updated tensors, "
        f"{len(pairs) - len(differ)} bitwise equal"
        + (f"; differ: {', '.join(differ)}" if differ else ""))
    # the one op on the path that PyTorch documents as nondeterministic on
    # CUDA: index_add_, the backward of the splines' index_select (it adds
    # to distinct control points); the tensors it feeds are among those
    fed = ("xyz_deform", "rotation_deform", "background_deform",
           "scene_shs_deform", "obj_shs_deform")
    log("  index_add_ (index_select's backward in the splines, documented "
        "nondeterministic on CUDA), difference of what it feeds: "
        + ", ".join(f"{n} {'DIFFERS' if any(n in d for d in differ) else 0}"
                    for n in fed))
    if differ:
        raise AssertionError(f"{what}: not bitwise equal")
    return len(pairs)


def profile_call(label, fn, args, top: int = 12) -> None:
    """torch.profiler over one call: the kernels with the most device
    time, and the device's busy share of the (profiled) wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, attr = device_events(prof)
    if not kernels:
        log(f"# profile of {label}: the profiler recorded no device time")
        return
    busy_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    log(f"# profile of {label}: wall {wall_ms:.3f} ms under the profiler, "
        f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{n_kernels} device kernels")
    for e in sorted(kernels, key=lambda e: -getattr(e, attr))[:top]:
        log(f"#   {getattr(e, attr) / 1e3:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:100]}")


def report_marks(what, marks) -> float:
    """Log the median ms per call (first mark to last) and the median ms
    per stage; returns the median."""
    from adgs_tpu_torch._stages import stage_ms
    per = [m[0][1].elapsed_time(m[-1][1]) for m in marks]
    span = marks[0][0][1].elapsed_time(marks[-1][-1][1])
    med = float(np.median(per))
    log(f"# ms per {what} (CUDA events from each call's first mark to its "
        f"last, calls enqueued back to back): median {med:.3f}, all "
        f"{[round(x, 3) for x in per]}; {len(marks)} in {span:.3f} ms "
        f"({span / len(marks):.3f} ms each)")
    stages = [stage_ms(m) for m in marks]
    med_stage = {k: float(np.median([st[k] for st in stages]))
                 for k in stages[0]}
    log(f"# ms per stage of a {what} (median over calls): "
        + json.dumps({k: round(v, 4) for k, v in med_stage.items()}))
    return med


def check_launched(path, launches, names) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path} path")


# ---------------------------------------------------------------------------
# 14. scene preparation: a street of known geometry written as a raw
# KITTI-MOT tracking layout and as a Waymo segment, prepared by the port's
# scripts on the card (each stage held to the port's CPU run on the same
# inputs), then trained on by cli.train
# ---------------------------------------------------------------------------
PREP_TIMESTAMPS = 28              # KITTI stereo timestamps (56 images)
PREP_SIZE = (1242, 375)           # KITTI image width x height
PREP_BEAMS, PREP_AZIMUTHS = 64, 1875   # an HDL-64E sweep: 120,000 returns
PREP_INCL = (2.0, -24.8)          # its beams' inclinations (degrees)
PREP_SS = 3                       # supersamples per axis of a rendered pixel
PREP_ITERS = 20                   # cli.train iterations on the written scene
PREP_ENV_RES = ENV_RES            # its sky's resolution
PREP_RECORD = 2                   # calls per stage held to the CPU run
WAYMO_FRAMES = 20
WAYMO_RI = (64, 2650)             # TOP range image rows x columns
WAYMO_IMAGE = (1920, 1280)        # FRONT camera width x height
WAYMO_FOCAL = 2055.0
WAYMO_MAX_RANGE = 75.0
WAYMO_SPEED = 10.0                # m/s; frames at 10 Hz, sweeps of 0.1 s
# the street: ground z = 0, facades at y = +-STREET up to FACADE_H along
# x in FACADE_X, end walls at x = WALLS, car-sized boxes (id k + 1) at
# (x + speed * t, y)
STREET, FACADE_H, WALLS = 6.0, 14.0, (-80.0, 230.0)
FACADE_X = (-80.0, PREP_TIMESTAMPS + 20.0)   # 20 m past the drive's end
BOXES = ((18.0, -3.5, 0.6), (30.0, 4.0, 0.0), (45.0, -4.5, 0.0),
         (60.0, 4.5, 0.0))        # x, y (m), speed (m per KITTI frame)
BOX_SIZE = (4.2, 1.8, 1.5)
IMU_H = 0.93                      # KITTI's IMU height over the ground
VELO_IN_IMU = (0.81, -0.32, 0.80)
STEREO_BASELINE = 0.54
SKY_RGB = (135.0, 190.0, 235.0)
CELL, DOT = 0.5, 0.35              # texture cell (m), dot radius / cell
# the triangulated static points: this share within this distance (m) of
# the street's static surfaces
PREP_NEAR_SHARE, PREP_NEAR_M = 0.9, 0.1


class StreetWorld:
    """Ray casting against the street (float64, on `dev`): the nearest hit
    of each ray, its surface and its id (-1 sky, 0 static, k box k), and a
    blocky colour hashed from 0.5 m cells (0.25 m on the boxes)."""

    def __init__(self, dev):
        import torch
        self.torch = torch
        self.dev = dev
        self.size = torch.tensor(BOX_SIZE, dtype=torch.float64, device=dev)

    def boxes(self, t):
        """[B, 2, 3] lower and upper corners at KITTI frame time t."""
        torch = self.torch
        c = torch.tensor([[x + v * t, y, BOX_SIZE[2] / 2]
                          for x, y, v in BOXES], dtype=torch.float64,
                         device=self.dev)
        return torch.stack([c - self.size / 2, c + self.size / 2], 1)

    def cast(self, o, d, t):
        """o, d [N, 3] float64 (d need not be unit): (distance along d
        [N], inf on a miss; surface [N]; id [N])."""
        torch = self.torch
        inf = torch.full(d.shape[:1], math.inf, dtype=torch.float64,
                         device=self.dev)
        best, surf = inf.clone(), torch.full_like(inf, -1, dtype=torch.long)

        def take(k, s, ok):
            ok = ok & (s > 1e-6) & (s < best)
            best[ok] = s[ok]
            surf[ok] = k

        s = -o[:, 2] / d[:, 2]
        take(0, s, d[:, 2] < 0)                               # ground
        for k, (axis, level, sign) in enumerate(
                ((1, STREET, 1), (1, -STREET, -1),
                 (0, WALLS[1], 1), (0, WALLS[0], -1)), start=1):
            s = (level - o[:, axis]) / d[:, axis]
            z = o[:, 2] + s * d[:, 2]
            ok = (sign * d[:, axis] > 0) & (z >= 0) & (z <= FACADE_H)
            if axis == 1:
                x = o[:, 0] + s * d[:, 0]
                ok &= (x >= FACADE_X[0]) & (x <= FACADE_X[1])
            take(k, s, ok)
        lohi = self.boxes(t)
        for b in range(len(BOXES)):
            t0 = (lohi[b, 0] - o) / d
            t1 = (lohi[b, 1] - o) / d
            near = torch.minimum(t0, t1).nan_to_num(-math.inf).amax(1)
            far = torch.maximum(t0, t1).nan_to_num(math.inf).amin(1)
            take(5 + b, near, (near <= far) & (far > 0))
        ident = torch.where(surf >= 5, surf - 4, 0)
        ident = torch.where(surf < 0, -1, ident)
        return best, surf, ident

    def colour(self, p, surf):
        """[N, 3] float64 colours in [0, 255] of hits p on surfaces surf:
        on the static surfaces one dark dot (0.1 m radius, hashed place and
        colour) in each 0.5 m cell of a plain background, whose centre is
        a well-defined point for a feature detector; blocky hashed cells
        of 0.25 m tinted by box on the boxes."""
        torch = self.torch
        cell = torch.where(surf[:, None] >= 5, 0.25, CELL)
        q = p / cell
        ij = torch.floor(q).long()
        f = q - ij
        a_ax = torch.where((surf == 3) | (surf == 4), 1, 0)
        b_ax = torch.where(surf == 0, 1, 2)
        a = ij.gather(1, a_ax[:, None])[:, 0]
        b = ij.gather(1, b_ax[:, None])[:, 0]
        fa = f.gather(1, a_ax[:, None])[:, 0]
        fb = f.gather(1, b_ax[:, None])[:, 0]
        b = torch.where(surf >= 5, b + ij[:, 1] * 7, b)
        h = (a * 73856093) ^ (b * 19349663) ^ ((surf + 3) * 83492791)
        h = (h * 2654435761) & 0xFFFFFFFF
        byte = [((h >> s) & 255).double() / 255.0 for s in (0, 8, 16, 24, 4)]
        rgb = torch.stack(byte[:3], 1)
        ground = torch.tensor([[150, 150, 150], [200, 185, 160],
                               [180, 190, 205], [170, 170, 170],
                               [170, 170, 170]], dtype=torch.float64,
                              device=self.dev)
        ca, cb = 0.25 + 0.5 * byte[3], 0.25 + 0.5 * byte[4]
        dot = (fa - ca) ** 2 + (fb - cb) ** 2 < DOT ** 2
        static = torch.where(dot[:, None], 20.0 + 90.0 * rgb,
                             ground[torch.clamp(surf, 0, 4)])
        box = torch.tensor([[230, 40, 40], [40, 200, 60], [60, 80, 230],
                            [230, 210, 40]], dtype=torch.float64,
                           device=self.dev)
        tint = box[torch.clamp(surf - 5, 0, len(BOXES) - 1)]
        out = torch.where(surf[:, None] >= 5, 0.6 * tint + 70.0 * rgb,
                          static)
        sky = torch.tensor(SKY_RGB, dtype=torch.float64, device=self.dev)
        return torch.where(surf[:, None] < 0, sky, out)

    def render(self, R, T, K, width, height, t, ss=1):
        """A pinhole view (world-to-camera R, T; K [3, 3]): uint8 image
        [H, W, 3] averaged over ss x ss samples a pixel, and at the pixel
        centres the id [H, W] and the camera depth [H, W] (inf on sky).
        Pixel (i, j) looks along the ray through (u, v) = (j, i)."""
        torch = self.torch
        dev = self.dev
        R = torch.as_tensor(R, dtype=torch.float64, device=dev)
        T = torch.as_tensor(T, dtype=torch.float64, device=dev)
        K = torch.as_tensor(K, dtype=torch.float64, device=dev)
        centre = -R.T @ T
        v, u = torch.meshgrid(torch.arange(height, dtype=torch.float64,
                                           device=dev),
                              torch.arange(width, dtype=torch.float64,
                                           device=dev), indexing="ij")

        def rays(du, dv):
            x = (u.reshape(-1) + du - K[0, 2]) / K[0, 0]
            y = (v.reshape(-1) + dv - K[1, 2]) / K[1, 1]
            dcam = torch.stack([x, y, torch.ones_like(x)], 1)
            return dcam @ R                                   # R^T dcam
        o = centre.expand(width * height, 3)
        img = torch.zeros((width * height, 3), dtype=torch.float64,
                          device=dev)
        offs = [(k + 0.5) / ss - 0.5 for k in range(ss)]
        for du in offs:
            for dv in offs:
                d = rays(du, dv)
                s, surf, _ = self.cast(o, d, t)
                img += self.colour(o + s[:, None] * d, surf)
        img = torch.round(img / (ss * ss)).clamp(0, 255).to(torch.uint8)
        s, _, ident = self.cast(o, rays(0.0, 0.0), t)
        return (img.view(height, width, 3), ident.view(height, width),
                s.view(height, width))

    def static_distance(self, p):
        """[N] distance of points p [N, 3] to the nearest static surface."""
        torch = self.torch
        z = p[:, 2]
        facade = torch.minimum((p[:, 1] - STREET).abs(),
                               (p[:, 1] + STREET).abs())
        facade = facade + (FACADE_X[0] - p[:, 0]).clamp(min=0) \
            + (p[:, 0] - FACADE_X[1]).clamp(min=0)
        walls = torch.minimum((p[:, 0] - WALLS[1]).abs(),
                              (p[:, 0] - WALLS[0]).abs())
        up = torch.where((z >= 0) & (z <= FACADE_H), 0.0,
                         torch.minimum(z.abs(), (z - FACADE_H).abs()))
        return torch.minimum(z.abs(), torch.minimum(facade, walls) + up)

    def box_of(self, p, t, tol=0.02):
        """[N] id of the box whose surface holds each point (within tol)
        at frame times t [N], 0 where none does."""
        torch = self.torch
        out = torch.zeros(len(p), dtype=torch.long, device=self.dev)
        for tt in torch.unique(t).tolist():
            sel = t == tt
            lohi = self.boxes(tt)
            for b in range(len(BOXES)):
                q = p[sel]
                inside = ((q >= lohi[b, 0] - tol)
                          & (q <= lohi[b, 1] + tol)).all(1)
                core = ((q > lohi[b, 0] + tol) & (q < lohi[b, 1] - tol)).all(1)
                idx = torch.nonzero(sel)[:, 0]
                out[idx[inside & ~core]] = b + 1
        return out


def kitti_oxts(n):
    """[n, 30] OXTS rows: the IMU at IMU_H over the ground at (0, 0),
    driving +x at 1 m a frame and weaving by +-0.4 m, heading along its
    path (lat/lon by the converter's mercator, scale 1 at latitude 0)."""
    r_earth = 6378137.0
    t = np.arange(n, dtype=np.float64)
    x, y = t, 0.4 * np.sin(t / 6.0)
    rows = np.zeros((n, 30))
    rows[:, 0] = 360.0 / np.pi * np.arctan(np.exp(y / r_earth)) - 90.0
    rows[:, 1] = x * 180.0 / (np.pi * r_earth)
    rows[:, 2] = IMU_H
    rows[:, 5] = np.arctan2(0.4 / 6.0 * np.cos(t / 6.0), 1.0)
    return rows


def kitti_calib():
    """(P2, P3, T_velo2cam, T_imu2velo): KITTI P2's focal; the velodyne
    centre at the left camera's (so each sweep sees what that camera
    sees), its axes the velodyne's (x forward, y left, z up)."""
    W, H = PREP_SIZE
    K = np.array([[FOCAL, 0, W / 2.0], [0, FOCAL, H / 2.0], [0, 0, 1.0]])
    P2 = K @ np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    P3 = K @ np.concatenate([np.eye(3), [[-STEREO_BASELINE], [0], [0]]], 1)
    velo2cam = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                         [0, 0, 0, 1.0]])
    imu2velo = np.eye(4)
    imu2velo[:3, 3] = -np.asarray(VELO_IN_IMU)
    return P2, P3, velo2cam, imu2velo


def kitti_poses(oxts):
    """Per frame the IMU-to-world matrix the converter builds from the OXTS
    rows (scripts/convert_kitti.py's chain, before its rebase)."""
    from adgs_tpu_torch.scripts.convert_kitti import rotation_from_rpy
    r_earth = 6378137.0
    scale = np.cos(oxts[0][0] * np.pi / 180)
    out = []
    for o in oxts:
        m = np.eye(4)
        m[:3, :3] = rotation_from_rpy(o[3], o[4], o[5])
        m[:3, 3] = [scale * r_earth * (np.pi * o[1]) / 180,
                    scale * r_earth * np.log(np.tan((np.pi * (90 + o[0]))
                                                    / 360)), o[2]]
        out.append(m)
    return out


def write_raw_kitti(root, world, seed, dev):
    """The raw KITTI-MOT tracking layout of scripts/convert_kitti.py for the
    street: PREP_TIMESTAMPS stereo PNGs, velodyne sweeps of PREP_BEAMS x
    PREP_AZIMUTHS returns, OXTS and calib. Returns the ground truth per
    image (world-to-camera RT [3, 4], id map, depth map, time) and the
    IMU-to-world matrix of frame 0."""
    import os
    import torch
    from PIL import Image
    rng = np.random.default_rng(seed)
    scene, part = "0001", "training"
    dirs = dict(
        left=os.path.join(root, "data_tracking_image_2", part, "image_02",
                          scene),
        right=os.path.join(root, "data_tracking_image_3", part, "image_03",
                           scene),
        oxts=os.path.join(root, "data_tracking_oxts", part, "oxts"),
        calib=os.path.join(root, "data_tracking_calib", part, "calib"),
        velo=os.path.join(root, "data_tracking_velodyne", part, "velodyne",
                          scene))
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    W, H = PREP_SIZE
    P2, P3, velo2cam, imu2velo = kitti_calib()
    K = P2[:, :3]
    oxts = kitti_oxts(PREP_TIMESTAMPS)
    np.savetxt(os.path.join(dirs["oxts"], scene + ".txt"), oxts)
    def row(label, m):
        return label + " " + " ".join(f"{v:.17g}" for v in m.ravel())
    lines = [row("P0:", P2), row("P1:", P2), row("P2:", P2), row("P3:", P3),
             row("R_rect", np.eye(3)), row("Tr_velo_cam", velo2cam[:3]),
             row("Tr_imu_velo", imu2velo[:3])]
    with open(os.path.join(dirs["calib"], scene + ".txt"), "w") as f:
        f.write("\n".join(lines))

    imu2cam = velo2cam @ imu2velo
    incl = np.deg2rad(np.linspace(PREP_INCL[0], PREP_INCL[1], PREP_BEAMS))
    az = np.linspace(np.pi, -np.pi, PREP_AZIMUTHS, endpoint=False)
    dirs_velo = torch.as_tensor(np.stack(np.broadcast_arrays(
        np.cos(incl)[:, None] * np.cos(az)[None],
        np.cos(incl)[:, None] * np.sin(az)[None],
        np.sin(incl)[:, None]), -1).reshape(-1, 3), device=dev)
    truth = []
    for t, imu2world in enumerate(kitti_poses(oxts)):
        name = f"{t:06d}.png"
        world2imu = np.linalg.inv(imu2world)
        for side, off, folder in (("left", 0.0, "left"),
                                  ("right", -STEREO_BASELINE, "right")):
            RT = np.concatenate([np.eye(3), [[off], [0], [0]]], 1) @ (
                imu2cam @ world2imu)
            img, ident, depth = world.render(RT[:, :3], RT[:, 3], K, W, H, t,
                                             PREP_SS)
            Image.fromarray(img.cpu().numpy()).save(
                os.path.join(dirs[folder], name), compress_level=1)
            truth.append(dict(RT=RT, ident=ident, depth=depth, t=t))
        velo2world = torch.as_tensor(imu2world @ np.linalg.inv(imu2velo),
                                     device=dev)
        o = velo2world[:3, 3].expand(len(dirs_velo), 3)
        d = dirs_velo @ velo2world[:3, :3].T
        s, _, _ = world.cast(o, d, t)
        if not bool(torch.isfinite(s).all()):
            raise AssertionError("a velodyne beam left the street")
        p_velo = dirs_velo * s[:, None]
        sweep = torch.cat([p_velo, torch.as_tensor(
            rng.uniform(size=(len(p_velo), 1)), device=dev)], 1)
        sweep.float().cpu().numpy().tofile(
            os.path.join(dirs["velo"], f"{t:06d}.bin"))
    return truth, kitti_poses(oxts)[0], scene


def prep_pseudo_labels(dst, truth, dev):
    """The external nets' outputs for the KITTI scene, from the world's
    ground truth, through the port's packagers: instance ids, sky masks,
    min-max normalised inverse depth, and point tracks of every object
    pixel of each train image to the train frames slide_window = 4
    timestamps away (the tracked point moves with its box; visible where
    it lies in the target image within 5% of the target's depth)."""
    import torch
    from adgs_tpu_torch.geometry import pseudo_labels as pk
    names = [f"{i:06d}" for i in range(len(truth))]
    pk.import_semantic_masks(dst, {
        n: torch.clamp(g["ident"], min=0).to(torch.int32).cpu().numpy()
        for n, g in zip(names, truth)})
    pk.import_semantic_masks(dst, {n: (g["ident"] < 0).cpu().numpy()
                                   for n, g in zip(names, truth)},
                             kind="sky")
    pk.import_depth_maps(dst, {
        n: torch.where(torch.isfinite(g["depth"]), 1.0 / g["depth"], 0.0)
        .cpu().numpy() for n, g in zip(names, truth)})

    W, H = PREP_SIZE
    K = torch.as_tensor(kitti_calib()[0][:, :3], device=dev)
    speed = torch.tensor([0.0] + [b[2] for b in BOXES],
                         dtype=torch.float64, device=dev)
    n_ts = len(truth) // 2
    val = set(range(4, n_ts, 4))                   # nvs-75
    train_idx = [i for i in range(len(truth)) if i // 2 not in val]
    step, window = 8, 4

    def track(src, q, tgt):
        g, h = truth[src], truth[tgt]
        qi = q.long()
        z = g["depth"][qi[:, 1], qi[:, 0]]
        ident = g["ident"][qi[:, 1], qi[:, 0]]
        RT = torch.as_tensor(g["RT"], device=dev)
        pc = torch.stack([(q[:, 0] - K[0, 2]) / K[0, 0] * z,
                          (q[:, 1] - K[1, 2]) / K[1, 1] * z, z], 1)
        pw = (pc - RT[:, 3]) @ RT[:, :3]
        pw[:, 0] += speed[ident] * (h["t"] - g["t"])
        RT2 = torch.as_tensor(h["RT"], device=dev)
        pc2 = pw @ RT2[:, :3].T + RT2[:, 3]
        uv = (pc2 @ K.T)[:, :2] / pc2[:, 2:]
        r = torch.round(uv).long()
        inside = ((pc2[:, 2] > 0) & (r[:, 0] >= 0) & (r[:, 0] < W)
                  & (r[:, 1] >= 0) & (r[:, 1] < H))
        rc = torch.where(inside[:, None], r, 0)
        seen = (h["depth"][rc[:, 1], rc[:, 0]] - pc2[:, 2]).abs() \
            < 0.05 * pc2[:, 2]
        return uv.cpu().numpy(), (inside & seen).float().cpu().numpy()

    tracks = {}
    for p, g in enumerate(train_idx):
        q = pk.queries_from_mask(truth[g]["ident"] > 0)
        if not len(q):
            continue
        tr = {"query": q.cpu().numpy()}
        if p // 2 < len(train_idx) // 2 - window:
            tr["fwd"], tr["fwd_vis"] = track(g, q, train_idx[p + step])
        if p // 2 >= window:
            tr["bwd"], tr["bwd_vis"] = track(g, q, train_idx[p - step])
        tracks[g] = tr
    return pk.package_scene_flow(dst, tracks=tracks, slide_window=window,
                                 split_mode="nvs-75", device=dev)


def waymo_extrinsics():
    """(TOP lidar extrinsic, its beam inclinations ascending, FRONT camera
    extrinsic, intrinsic [9]): the lidar yawed by 2.6 rad (its azimuth
    correction wraps), beams denser near the horizon."""
    lid = np.eye(4)
    lid[:2, :2] = [[np.cos(2.6), -np.sin(2.6)], [np.sin(2.6), np.cos(2.6)]]
    lid[:3, 3] = [1.43, 0.0, 2.18]
    s = np.linspace(0.0, 1.0, WAYMO_RI[0])
    incl = np.deg2rad(2.4 - 20.0 * (1.0 - s) ** 1.4)
    cam = np.eye(4)
    cam[:3, 3] = [1.5, 0.0, 2.0]
    W, H = WAYMO_IMAGE
    intr = np.array([WAYMO_FOCAL, WAYMO_FOCAL, W / 2.0, H / 2.0, 0, 0, 0, 0,
                     0])
    return lid, incl, cam, intr


def yaw_pose(yaw, xyz):
    m = np.eye(4)
    m[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    m[:3, 3] = xyz
    return m


# the segment's original world: the street yawed by 0.3 rad and moved
WAYMO_WORLD = yaw_pose(0.3, (1000.0, 500.0, 30.0))


def waymo_vehicle(tau):
    """Vehicle-to-street pose at time tau (s): driving +x at WAYMO_SPEED
    from x = 2, weaving by +-0.5 m, heading along its path."""
    x = 2.0 + WAYMO_SPEED * tau
    return yaw_pose(np.arctan2(0.5 * 0.8 * np.cos(0.8 * tau), WAYMO_SPEED),
                    (x, 0.5 * np.sin(0.8 * tau), 0.0))


def write_waymo_segment(path, world, seed, dev):
    """A Waymo segment of WAYMO_FRAMES frames of the street (packed
    MatrixFloat data): a TOP range image [64, 2650, 4] whose columns are
    swept over 0.1 s (per-pixel poses in the original world, returns beyond
    WAYMO_MAX_RANGE empty) and a FRONT JPEG. Returns the frame-0 vehicle
    pose in the original world."""
    import io
    import torch
    from PIL import Image
    from adgs_tpu_torch.data import lidar, tfrecord
    from adgs_tpu_torch.data import waymo_proto as wp
    rng = np.random.default_rng(seed + 1)
    lid, incl, cam, intr = waymo_extrinsics()
    rows, cols = WAYMO_RI
    W, H = WAYMO_IMAGE
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]])
    az = lidar.azimuths(cols, torch.as_tensor(lid, device=dev))
    inc = torch.as_tensor(incl[::-1].copy(), device=dev)
    d_sensor = torch.stack(torch.broadcast_tensors(
        torch.cos(az)[None] * torch.cos(inc)[:, None],
        torch.sin(az)[None] * torch.cos(inc)[:, None],
        torch.sin(inc)[:, None].expand(rows, cols)), -1)       # [R, C, 3]
    lid_t = torch.as_tensor(lid, device=dev)
    records = []
    for f in range(WAYMO_FRAMES):
        taus = f * 0.1 + (np.arange(cols) / cols - 0.5) * 0.1
        street = np.stack([waymo_vehicle(tau) for tau in taus])  # [C,4,4]
        st = torch.as_tensor(street, device=dev) @ lid_t
        o = st[:, :3, 3][None].expand(rows, cols, 3).reshape(-1, 3)
        d = (st[None, :, :3, :3] @ d_sensor[..., None])[..., 0].reshape(-1, 3)
        s, _, _ = world.cast(o, d, f)
        rng_img = torch.where(s <= WAYMO_MAX_RANGE, s, 0.0).view(rows, cols)
        ri = np.zeros((rows, cols, 4), np.float32)
        ri[..., 0] = rng_img.cpu().numpy()
        ri[..., 1] = rng.uniform(size=(rows, cols))
        orig = WAYMO_WORLD @ street                              # [C, 4, 4]
        pose = np.zeros((rows, cols, 6), np.float32)
        pose[..., 2] = np.arctan2(orig[:, 1, 0], orig[:, 0, 0])[None]
        pose[..., 3:] = orig[None, :, :3, 3]
        ego = WAYMO_WORLD @ waymo_vehicle(f * 0.1)
        RT = np.linalg.inv(ego @ cam @ lidar.OPENCV2DATASET)     # orig->cam
        RT = RT @ WAYMO_WORLD                                    # street->cam
        img, _, _ = world.render(RT[:3, :3], RT[:3, 3], K, W, H, f)
        buf = io.BytesIO()
        Image.fromarray(img.cpu().numpy()).save(buf, format="JPEG",
                                                quality=92)
        records.append(wp.encode_frame(
            pose=ego, timestamp_micros=100_000 * f,
            camera_calibrations=[dict(name=1, intrinsic=intr, extrinsic=cam,
                                      width=W, height=H)],
            laser_calibrations=[dict(name=wp.LASER_TOP,
                                     beam_inclinations=incl,
                                     beam_inclination_min=float(incl[0]),
                                     beam_inclination_max=float(incl[-1]),
                                     extrinsic=lid)],
            images=[dict(name=1, image=buf.getvalue())],
            lasers=[dict(name=wp.LASER_TOP, range_image=ri,
                         range_image_pose=pose)], packed=True))
    tfrecord.write_records(path, records)
    return WAYMO_WORLD @ waymo_vehicle(0.0)


class StageRecorder:
    """Wraps stage functions of the port so that their first PREP_RECORD
    calls on the card keep their inputs and outputs (copied to the host)
    and every call its seconds; `replay` runs the same function on the CPU
    on the kept inputs."""

    def __init__(self):
        self.calls, self.seconds, self._patches = {}, {}, []

    def wrap(self, owner, name, key=None):
        import torch
        key = key or name
        orig = getattr(owner, name)
        self._patches.append((owner, name, orig))
        self.calls[key] = []
        self.seconds[key] = 0.0

        def fn(*a, **k):
            keep = len(self.calls[key]) < PREP_RECORD
            if keep:
                inputs = (to_host(a), to_host(k))
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            self.seconds[key] += time.perf_counter() - t0
            if keep:
                self.calls[key].append((orig, inputs, to_host(out)))
            return out
        setattr(owner, name, fn)

    def restore(self):
        for owner, name, orig in reversed(self._patches):
            setattr(owner, name, orig)
        self._patches = []

    def replay(self, key):
        """[(card output, CPU output, inputs)] of the kept calls."""
        out = []
        for orig, (a, k), card in self.calls[key]:
            out.append((card, orig(*a, **k), (a, k)))
        return out


def to_host(x):
    """x with every tensor copied to the host and every device the CPU."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, torch.device):
        return torch.device("cpu")
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_host(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def check_ulp(name, card, cpu, rel=None):
    """float32: within one float32 ulp at the row's magnitude; float64:
    within 1e-9 relative at the row's magnitude (rel overrides)."""
    a, b = _np(card), _np(cpu)
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"{name}: {a.dtype} {a.shape} vs {b.dtype} "
                             f"{b.shape}")
    scale = np.maximum(np.abs(a), np.abs(b))
    if scale.ndim > 1:
        scale = scale.max(-1, keepdims=True)
    if a.dtype == np.float32 and rel is None:
        tol = np.spacing(scale.astype(np.float32)).astype(np.float64)
    else:
        tol = (1e-9 if rel is None else rel) * scale
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    if not (diff <= tol).all():
        raise AssertionError(f"{name}: {int((diff > tol).sum())} of "
                             f"{diff.size} values beyond tolerance, max "
                             f"{float(diff.max()):.3e}")
    return float(diff.max()) if diff.size else 0.0


def check_stage(rec, key, compare):
    """Replays the kept calls of a stage on the CPU and compares; returns
    the number of calls held."""
    pairs = rec.replay(key)
    if len(pairs) < min(PREP_RECORD, 1):
        raise AssertionError(f"stage {key} was never called")
    for i, (card, cpu, inputs) in enumerate(pairs):
        compare(f"{key} call {i}", card, cpu, inputs)
    log(f"#   {key}: {len(pairs)} calls held to the CPU run")
    return len(pairs)


def cmp_uv_mask(name, card, cpu, _):
    check_ulp(name + " uv", card[0], cpu[0])
    check_bitwise(name + " mask", card[1], cpu[1])


def cmp_colour(name, card, cpu, _):
    """The sweep's colours are float32 sums, each rounded, of float64 taps
    at coordinates the card's and the CPU's matmuls give to 1e-9: two
    roundings, so two float32 ulps (the taps themselves are held to 1e-9
    as bilinear_sample)."""
    a, b = _np(card[0]), _np(cpu[0])
    scale = np.maximum(np.abs(a), np.abs(b)).max(-1, keepdims=True)
    tol = 2 * np.spacing(scale.astype(np.float32)).astype(np.float64)
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    if not (diff <= tol).all():
        raise AssertionError(f"{name} colour: {int((diff > tol).sum())} "
                             "values beyond two float32 ulps")
    check_bitwise(name + " mask", card[1], cpu[1])


def cmp_project(name, card, cpu, _):
    check_ulp(name + " uv", card[0], cpu[0])
    check_ulp(name + " depth", card[1][:, None], cpu[1][:, None])
    check_bitwise(name + " mask", card[2], cpu[2])


def cmp_float(name, card, cpu, _):
    check_ulp(name, card, cpu)


def cmp_from_f32(name, card, cpu, _):
    """float64 values carried from float32 ones: one float32 ulp."""
    check_ulp(name, card, cpu, rel=2.4e-7)


def cmp_bits(name, card, cpu, _):
    check_bitwise(name, card, cpu)


def match_ratio_gap(a, b, qa):
    """|d0 / d1 - 0.8| of queries qa (float64 direct distances)."""
    import torch
    d = ((a[qa, None, :].double() - b[None].double()) ** 2).sum(-1).sqrt()
    d2 = torch.topk(d, 2, dim=1, largest=False).values
    return (d2[:, 0] / d2[:, 1] - 0.8).abs()


def cmp_matches(counter):
    """Match sets equal except queries whose ratio lies within 1e-5 of the
    0.8 cut (counted)."""
    def cmp(name, card, cpu, inputs):
        a, b = inputs[0][0], inputs[0][1]
        sa = {tuple(r) for r in _np(card).tolist()}
        sb = {tuple(r) for r in _np(cpu).tolist()}
        diff = sorted({q for q, _ in sa ^ sb})
        counter["matches"] += len(sa)
        if diff:
            gap = match_ratio_gap(a, b, diff) if len(b) > 1 else None
            if gap is None or bool((gap > 1e-5).any()):
                raise AssertionError(f"{name}: {len(diff)} queries match "
                                     "differently away from the ratio cut")
            counter["near_cut"] += len(diff)
    return cmp


def dlt_normal_matrices(obs, tracks, proj):
    """[M, 4, 4] float64 trace-normalised A^T A of each track (on the
    CPU), the matrix whose smallest eigenvector is its DLT point."""
    import torch
    track_of = torch.as_tensor(tracks.track_of)
    sel = track_of >= 0
    t_id = track_of[sel]
    P = proj.double()[obs.frame[sel]]
    xy = obs.xy[sel].double()
    r0 = xy[:, 0:1] * P[:, 2, :] - P[:, 0, :]
    r1 = xy[:, 1:2] * P[:, 2, :] - P[:, 1, :]
    ata = torch.zeros((tracks.n_tracks, 4, 4), dtype=torch.float64)
    ata.index_add_(0, t_id, r0[:, :, None] * r0[:, None, :])
    ata.index_add_(0, t_id, r1[:, :, None] * r1[:, None, :])
    d = torch.diagonal(ata, dim1=1, dim2=2).sum(1).clamp(min=1e-24)
    return ata / d[:, None, None]


def dlt_objective(A, xyz):
    """[M] h^T A h of the unit homogeneous points h ~ (xyz, 1)."""
    import torch
    h = torch.cat([xyz, torch.ones_like(xyz[:, :1])], 1)
    h = h / h.norm(dim=1, keepdim=True)
    return (h[:, None, :] @ A @ h[:, :, None])[:, 0, 0]


def prep_timed(seconds, key, fn):
    import torch
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds[key] = time.perf_counter() - t0
    return out


def prep_phase(seed, dev, card):
    """Phase 14 (see the module docstring). Returns a summary."""
    import os
    import shutil
    import tempfile
    import torch
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.cli import train as cli_train
    from adgs_tpu_torch.data import lidar
    from adgs_tpu_torch.data.ply import read_ply
    from adgs_tpu_torch.geometry import pseudo_labels as pk
    from adgs_tpu_torch.geometry import segment as seg
    from adgs_tpu_torch.geometry import triangulate as tri
    from adgs_tpu_torch.scripts import (convert_kitti, convert_waymo,
                                        segment_pcd, triangulate,
                                        validate_scene)

    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    world = StreetWorld(dev)
    card_s, cpu_s = {}, {}
    counts = dict(matches=0, near_cut=0)      # over the held pairs
    summary = {}
    W, H = PREP_SIZE
    log(f"# prep ({card}): raw KITTI-MOT {PREP_TIMESTAMPS} stereo "
        f"timestamps at {W}x{H}, sweeps of {PREP_BEAMS * PREP_AZIMUTHS} "
        f"returns; Waymo {WAYMO_FRAMES} frames, TOP {WAYMO_RI[0]}x"
        f"{WAYMO_RI[1]}, FRONT {WAYMO_IMAGE[0]}x{WAYMO_IMAGE[1]} JPEG")
    with tempfile.TemporaryDirectory(prefix="adgs_prep_") as tmp:
        raw = os.path.join(tmp, "raw")
        truth, imu0, scene = prep_timed(card_s, "write raw KITTI",
                                        lambda: write_raw_kitti(
                                            raw, world, seed, dev))
        kargs = [raw, None, scene, "--first_frame", "0", "--last_frame",
                 str(PREP_TIMESTAMPS - 1), "--use_color", "--seed",
                 str(seed)]
        # the converter on the CPU, then on the card with its stages kept
        cpu_root, root = os.path.join(tmp, "cpu"), os.path.join(tmp, "card")
        prep_timed(cpu_s, "convert_kitti", lambda: convert_kitti.main(
            [a or cpu_root for a in kargs] + ["--device", "cpu"]))
        rec = StageRecorder()
        for name in ("project_sweep", "bilinear_sample", "colour_sweep"):
            rec.wrap(convert_kitti, name)
        try:
            prep_timed(card_s, "convert_kitti", lambda: convert_kitti.main(
                [a or root for a in kargs] + ["--device", str(dev)]))
        finally:
            rec.restore()
        dst = os.path.join(root, scene)
        check_stage(rec, "project_sweep", cmp_uv_mask)
        check_stage(rec, "bilinear_sample", cmp_float)
        check_stage(rec, "colour_sweep", cmp_colour)
        compare_prep_files(os.path.join(cpu_root, scene), dst)

        # pseudo labels, then object tagging, then triangulation
        rec = StageRecorder()
        rec.wrap(pk, "queries_from_mask")
        rec.wrap(pk, "tracks_to_flow")
        try:
            written = prep_timed(card_s, "pseudo labels",
                                 lambda: prep_pseudo_labels(dst, truth, dev))
        finally:
            rec.restore()
        check_stage(rec, "queries_from_mask", cmp_bits)
        check_stage(rec, "tracks_to_flow", cmp_bits)
        summary["flow packages"] = len(written)

        rec = StageRecorder()
        rec.wrap(seg, "tag_points_one_frame")
        try:
            prep_timed(card_s, "segment_pcd", lambda: segment_pcd.main(
                [dst, "--device", str(dev)]))
        finally:
            rec.restore()
        check_stage(rec, "tag_points_one_frame", cmp_bits)
        summary["tags"] = check_tags(dst, truth, imu0, world)

        shutil.copytree(dst, os.path.join(tmp, "cpu_tri"),
                        ignore=shutil.ignore_patterns("flow", "depth"))
        prep_timed(cpu_s, "triangulate", lambda: triangulate.main(
            [os.path.join(tmp, "cpu_tri"), "--window", "4", "--device",
             "cpu"]))
        rec = StageRecorder()
        for name in ("detect_features", "match_descriptors", "build_tracks",
                     "triangulate_tracks", "filter_tracks"):
            rec.wrap(tri, name)
        try:
            prep_timed(card_s, "triangulate", lambda: triangulate.main(
                [dst, "--window", "4", "--device", str(dev)]))
        finally:
            rec.restore()
        summary["triangulate seconds"] = {k: round(v, 3) for k, v in
                                          rec.seconds.items()}
        check_stage(rec, "match_descriptors", cmp_matches(counts))
        summary.update(check_dlt(rec, dst, imu0, world))
        a = read_ply(os.path.join(tmp, "cpu_tri", "colmap-75.ply"))
        b = read_ply(os.path.join(dst, "colmap-75.ply"))
        check_bitwise("colmap-75 colours (card vs CPU run)",
                      *(torch.as_tensor(np.stack([v["red"], v["green"],
                                                  v["blue"]]))
                        for v in (b, a)))
        summary["held matches"] = counts["matches"]
        summary["near_cut"] = counts["near_cut"]

        # exits non-zero (SystemExit) on any problem with the contract
        prep_timed(card_s, "validate_scene", lambda: validate_scene.main(
            [dst, "--device", str(dev)]))

        # cli.train on the written scene
        probe = TrainProbe()
        model = os.path.join(tmp, "model")
        _kernels.reset_launches()
        try:
            prep_timed(card_s, "cli.train", lambda: cli_train.main(
                ["-s", dst, "-m", model, "-c",
                 os.path.join(here, "configs", "kitti-75.py"),
                 "--iterations", str(PREP_ITERS), "--env_resolution",
                 str(PREP_ENV_RES), "--seed", str(seed), "--device",
                 str(dev)]))
        finally:
            probe.restore()
            probe.trainer = None
        launches = dict(_kernels.launches)
        check_launched("cli.train on the prepared scene", launches,
                       TRAINING_KERNELS)
        summary["train launches"] = launches
        losses = torch.stack([s[2] for s in probe.steps]).cpu().numpy()
        if len(losses) != PREP_ITERS or not np.isfinite(losses).all():
            raise AssertionError(f"cli.train on the prepared scene: losses "
                                 f"{losses}")
        summary["train losses"] = [round(float(x), 6) for x in losses]
        summary["train seconds"] = {k: round(v, 3)
                                    for k, v in probe.seconds.items()}
        ply = read_ply(os.path.join(dst, "points3d-75.ply"))
        summary["points3d-75"] = len(ply["x"])
        shutil.rmtree(root)
        shutil.rmtree(cpu_root)

        # Waymo
        seg_path = os.path.join(tmp, "segment.tfrecord")
        pose0 = prep_timed(card_s, "write Waymo segment",
                           lambda: write_waymo_segment(seg_path, world, seed,
                                                       dev))
        summary["segment MB"] = round(os.path.getsize(seg_path) / 2 ** 20, 1)
        wargs = [seg_path, None, "--use_color", "--use_depth", "--seed",
                 str(seed)]
        rec = StageRecorder()
        rec.wrap(convert_waymo, "frame_points")
        for name in ("range_image_to_points", "project_points",
                     "sample_colors_aligned", "lidar_depth_map"):
            rec.wrap(lidar, name)
        try:
            prep_timed(card_s, "convert_waymo", lambda: convert_waymo.main(
                [a or os.path.join(tmp, "waymo") for a in wargs]
                + ["--device", str(dev)]))
        finally:
            rec.restore()
        check_stage(rec, "range_image_to_points", cmp_float)
        check_stage(rec, "frame_points", cmp_from_f32)
        check_stage(rec, "project_points", cmp_project)
        check_stage(rec, "sample_colors_aligned", cmp_float)
        check_stage(rec, "lidar_depth_map", cmp_bits)
        summary["waymo"] = check_waymo(os.path.join(tmp, "waymo"), pose0,
                                       world)
    summary["card seconds"] = {k: round(v, 3) for k, v in card_s.items()}
    summary["cpu seconds"] = {k: round(v, 3) for k, v in cpu_s.items()}
    summary["phase seconds"] = round(time.perf_counter() - t_phase, 3)
    log(f"# prep ({card}): " + json.dumps(summary))
    for k in cpu_s:
        log(f"# prep ({card}): {k}: card {card_s[k]:.3f} s, CPU "
            f"{cpu_s[k]:.3f} s (the port's CPU run on the same machine)")
    return summary


def compare_prep_files(cpu_dst, card_dst):
    """The converter's files written on the card against its CPU run's:
    poses.npz and the PLYs' times bitwise, xyz within one float32 ulp at the
    point's magnitude, colours within 1 of 255 (a float32 ulp of the
    colour may cross an integer)."""
    import os
    import torch
    from adgs_tpu_torch.data.ply import read_ply
    with np.load(os.path.join(cpu_dst, "poses.npz")) as a, \
            np.load(os.path.join(card_dst, "poses.npz")) as b:
        for k in a.files:
            check_bitwise(f"poses.npz {k}", torch.as_tensor(b[k]),
                          torch.as_tensor(a[k]))
    for split in ("25", "50", "75"):
        a = read_ply(os.path.join(cpu_dst, f"points3d-{split}.ply"))
        b = read_ply(os.path.join(card_dst, f"points3d-{split}.ply"))
        check_bitwise(f"points3d-{split} t", torch.as_tensor(b["t"]),
                      torch.as_tensor(a["t"]))
        check_ulp(f"points3d-{split} xyz",
                  *(np.stack([v["x"], v["y"], v["z"]], 1) for v in (b, a)))
        for c in ("red", "green", "blue"):
            d = np.abs(b[c].astype(int) - a[c].astype(int))
            if d.max() > 1:
                raise AssertionError(f"points3d-{split} {c}: {d.max()}")


def check_tags(dst, truth, imu0, world):
    """Every object box's points, and only those, carry its id after
    segment_pcd: on the points whose sampled id in every train view of
    their timestamp that sees them is their own box's (0 for the static
    world), the tag is exact; the others (silhouettes, and ground seen by
    the left camera but hidden from the right by a box) are counted."""
    import os
    import torch
    from adgs_tpu_torch.data.ply import fetch_point_cloud
    dev = world.dev
    pts, _, t, obj = fetch_point_cloud(os.path.join(dst, "points3d-75.ply"))
    p_conv = torch.as_tensor(pts, device=dev).double()
    imu0 = torch.as_tensor(imu0, device=dev)
    p = p_conv @ imu0[:3, :3].T + imu0[:3, 3]           # the street's frame
    t = torch.as_tensor(t, device=dev)
    obj = torch.as_tensor(obj, device=dev).long()
    gt = world.box_of(p, t.double())
    W, H = PREP_SIZE
    with np.load(os.path.join(dst, "poses.npz")) as m:
        R, T = m["R"], m["T"]
    K = torch.as_tensor(kitti_calib()[0][:, :3], device=dev)
    clean = torch.ones(len(p), dtype=torch.bool, device=dev)
    seen_any = torch.zeros(len(p), dtype=torch.bool, device=dev)
    for i, g in enumerate(truth):
        sel = t == g["t"]
        cam = p_conv[sel] @ torch.as_tensor(R[i], device=dev).T \
            + torch.as_tensor(T[i], device=dev)
        uvw = cam @ K.T
        z = torch.where(uvw[:, 2] > 0, uvw[:, 2], 1.0)
        px, py = uvw[:, 0] / z, uvw[:, 1] / z
        view = (uvw[:, 2] > 0) & (px > 0) & (px < W) & (py > 0) & (py < H)
        ix = torch.round(px * (W - 1) / W).long().clamp(0, W - 1)
        iy = torch.round(py * (H - 1) / H).long().clamp(0, H - 1)
        seen = torch.clamp(g["ident"][iy, ix], min=0)
        idx = torch.nonzero(sel)[:, 0]
        clean[idx[view & (seen != gt[sel])]] = False
        seen_any[idx[view]] = True
    clean &= seen_any
    bad = clean & (obj != gt)
    n_box = [int((clean & (gt == k)).sum()) for k in range(1, len(BOXES) + 1)]
    out = dict(points=len(p), tagged=int((obj > 0).sum()),
               checked=int(clean.sum()), not_checked=int((~clean).sum()),
               not_checked_tagged=int((~clean & (obj > 0)).sum()),
               box_points_checked=n_box)
    log(f"#   segment_pcd: {json.dumps(out)}")
    if int(bad.sum()):
        raise AssertionError(f"segment_pcd: {int(bad.sum())} checked points "
                             "carry another id than their box's")
    if min(n_box) == 0:
        raise AssertionError("segment_pcd: a box has no checked points")
    return out


def check_dlt(rec, dst, imu0, world):
    """The DLT and the filters on the card against the CPU on the same
    inputs: valid and keep flags bitwise; points within 1e-9 relative,
    except tracks (counted, with their eigenvalue gaps) whose smallest
    eigenvectors the two eigensolvers place differently: there the card's
    point must minimise the DLT objective h^T A h as closely as the CPU's
    (to 1e-13, the trace normalised to 1); the written static points on
    the street's static surfaces (PREP_NEAR_SHARE within PREP_NEAR_M)."""
    import os
    import torch
    from adgs_tpu_torch.data.ply import fetch_point_cloud
    (card_xyz, card_valid), (cpu_xyz, cpu_valid), (a, _) = \
        rec.replay("triangulate_tracks")[0]
    obs, tracks, proj = a
    check_bitwise("triangulate_tracks valid", card_valid, cpu_valid)
    # points beyond 1e-9 relative must minimise the DLT's objective as
    # well as the CPU's do: their eigenvalue gap leaves them unfixed
    scale = torch.maximum(card_xyz.abs(), cpu_xyz.abs()).amax(1)
    off = ((card_xyz - cpu_xyz).abs().amax(1) > 1e-9 * scale) & cpu_valid
    A = dlt_normal_matrices(obs, tracks, proj)[off]
    excess = (dlt_objective(A, card_xyz[off])
              - dlt_objective(A, cpu_xyz[off]))
    w = torch.linalg.eigvalsh(A)
    gap = (w[:, 1] - w[:, 0]) if len(w) else w
    excess_max = float(excess.abs().max()) if len(excess) else 0.0
    if excess_max > 1e-13:
        raise AssertionError(f"triangulate_tracks: {int(off.sum())} points "
                             "beyond 1e-9 relative, and the card's do not "
                             "minimise the DLT objective to 1e-13 "
                             f"({excess_max:.3e})")
    card_keep, cpu_keep, _ = rec.replay("filter_tracks")[0]
    check_bitwise("filter_tracks keep", card_keep, cpu_keep)
    n_obs = int((torch.as_tensor(tracks.track_of) >= 0).sum())
    xyz, _, _, _ = fetch_point_cloud(os.path.join(dst, "colmap-75.ply"))
    imu0 = torch.as_tensor(imu0, device=world.dev)
    p = torch.as_tensor(xyz, device=world.dev).double() @ imu0[:3, :3].T \
        + imu0[:3, 3]
    dist = world.static_distance(p)
    near = float((dist < PREP_NEAR_M).double().mean()) if len(p) else 0.0
    out = dict(keypoints=int(obs.offset[-1]), matched_observations=n_obs,
               tracks=tracks.n_tracks, valid=int(card_valid.sum()),
               kept=int(card_keep.sum()), written=len(xyz),
               off_1e9=int(off.sum()),
               off_1e9_max_rel=float(((card_xyz - cpu_xyz).abs().amax(1)
                                      / scale)[off].max()) if int(off.sum())
               else 0.0,
               off_1e9_objective_excess=excess_max,
               off_1e9_max_gap=float(gap.max()) if len(gap) else None,
               near_static_surfaces=round(near, 4),
               median_distance_m=float(dist.median()) if len(p) else None)
    log(f"#   triangulate: {json.dumps(out)}")
    if near < PREP_NEAR_SHARE:
        raise AssertionError(f"triangulate: {near:.4f} of the static points "
                             f"within {PREP_NEAR_M} m of the known surfaces "
                             f"(< {PREP_NEAR_SHARE})")
    return out


def check_waymo(dst, pose0, world):
    """The Waymo converter's cloud lies on the street (every point within
    0.01 m of a surface: the rolling-shutter poses undone), with the
    reader contract's files."""
    import os
    import torch
    from adgs_tpu_torch.data.ply import fetch_point_cloud
    with np.load(os.path.join(dst, "cameras.npz")) as m:
        n_img, is_val = len(m["R"]), m["is_val_list"]
    pts, _, t, _ = fetch_point_cloud(os.path.join(dst, "points3d.ply"))
    back = torch.as_tensor(np.linalg.inv(WAYMO_WORLD) @ pose0,
                           device=world.dev)
    p = torch.as_tensor(pts, device=world.dev).double() @ back[:3, :3].T \
        + back[:3, 3]
    dist = torch.minimum(world.static_distance(p),
                         box_distance(world, p, torch.as_tensor(
                             t, device=world.dev).double()))
    out = dict(images=n_img, val=int(is_val.sum()), points=len(pts),
               max_distance_m=float(dist.max()),
               depth_maps=len(os.listdir(os.path.join(dst, "lidar_depth"))))
    log(f"#   convert_waymo: {json.dumps(out)}")
    if out["max_distance_m"] > 0.01 or out["depth_maps"] != WAYMO_FRAMES:
        raise AssertionError(f"convert_waymo: {out}")
    return out


def box_distance(world, p, t):
    """[N] distance of points to the nearest box surface at frame times t
    (KITTI frames: Waymo frame f uses the boxes of time f)."""
    import torch
    out = torch.full((len(p),), math.inf, dtype=torch.float64,
                     device=world.dev)
    for tt in torch.unique(t).tolist():
        sel = t == tt
        lohi = world.boxes(tt)
        for b in range(len(BOXES)):
            q = p[sel]
            c = (lohi[b, 0] + lohi[b, 1]) / 2
            h = (lohi[b, 1] - lohi[b, 0]) / 2
            d = (q - c).abs() - h
            outside = d.clamp(min=0).norm(dim=1)
            inside = d.amax(1).clamp(max=0).abs()
            out[sel] = torch.minimum(out[sel], outside + inside)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import adgs_tpu_torch  # noqa: F401  (fails outside a checkout)
    from adgs_tpu_torch import _kernels

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    build_s = _kernels.build_all()
    sources = list(dict.fromkeys(_kernels.SOURCES.values()))
    log(f"# build: {len(_kernels.SOURCES)} kernels from {len(sources)} "
        f"sources in {build_s:.1f} s")
    for src in sources:
        for line in _kernels.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {src}: {line.strip()}")

    kernels = run(dev, args.seed, card)
    log(f"# card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev, seed: int, card: str = "no card") -> list:
    """Phases 3-13 on `dev` (`card`: the card's name and power limit, for
    the trainer's and the gate's lines); returns the kernels line's
    entries."""
    import torch
    from adgs_tpu_torch.render import make_staged_render_fn
    from adgs_tpu_torch.train.optim import TrainableState, init_adam

    # 3. scene
    t0 = time.perf_counter()
    cfg, params, state, env, rays, cams = build_scene(
        dev, seed, N_GAUSS, WIDTH, HEIGHT, ENV_RES)
    reqs = requests(cams, FRAMES)
    train_cam = cams[0].at_time(TRAIN_TIME)
    capacity, nr = size_capacity(cfg, params, state, reqs + [train_cam])
    batch, train_state = train_inputs(dev, seed, params, state, WIDTH,
                                      HEIGHT)
    n_alive = int(state.alive.sum())
    log(f"# scene: {params.capacity} slots ({n_alive} alive, "
        f"{int(state.obj_alive.sum())} object), frame {WIDTH}x{HEIGHT}, "
        f"sky {tuple(env.grid.shape)}, max num_rendered {nr}, capacity "
        f"{capacity}, {int(train_state.obj_near_valid.sum())} KNN groups of "
        f"{train_state.obj_near_idx.shape[1]}, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # 4. the serving path
    torch.cuda.reset_peak_memory_stats()
    outs, marks, serve_launches = serve_phase(cfg, params, state, env, rays,
                                              reqs, capacity)
    log(f"# served {len(outs)} frames; launches {serve_launches}")
    check_launched("serving", serve_launches, SERVING_KERNELS)
    for i, out in enumerate(outs):
        if int(out["num_rendered"]) > capacity:
            raise AssertionError(f"frame {i}: instance overflow "
                                 f"({int(out['num_rendered'])} > {capacity})")
    check_outputs(outs, reqs, WIDTH, HEIGHT)
    plain = make_staged_render_fn(cfg, capacity=capacity, backend="torch")(
        reqs[0], params, state, env, rays)
    for k in ("render", "foreground", "background", "depth", "img_opacity"):
        check_close(f"frame 0 {k} vs the torch backend", outs[0][k],
                    plain[k], 1e-4, 1e-4)
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del outs, plain

    # 5. cli.render from a saved checkpoint, both layouts
    cli = cli_phase(cfg, params, state, env, cams, camera_poses(), seed, dev)
    check_launched("cli.render (gather)", cli["gather"][1], SERVING_KERNELS)
    check_launched("cli.render (rows)", cli["rows"][1],
                   SERVING_KERNELS + ("pad_lanes",))
    if cli["gather"][1]["pad_lanes"]:
        raise AssertionError("B6 launched by the gather layout")
    for layout, (res, _) in cli.items():
        log(f"# cli.render FPS, layout {layout}: train "
            f"{res['train']['FPS']:.3f}, test {res['test']['FPS']:.3f}")

    # 6. serving in both layouts, in turns (gather, rows, ...)
    ab = {"gather": [], "rows": []}
    for i in range(AB_ROUNDS):
        for layout in ab:
            _, m, lc = serve_phase(cfg, params, state, env, rays, reqs,
                                   capacity, layout)
            log(f"# A/B round {i}, {layout} layout: median "
                f"{np.median([x[0][1].elapsed_time(x[-1][1]) for x in m]):.3f}"
                f" ms/frame over {len(m)} requests")
            check_launched(f"serving ({layout})", lc, SERVING_KERNELS
                           + (("pad_lanes",) if layout == "rows" else ()))
            if layout == "gather" and lc["pad_lanes"]:
                raise AssertionError("B6 launched by the gather layout")
            ab[layout] += m

    # 7. the training path
    step = make_step(cfg, capacity)
    start = (params, env, init_adam(TrainableState(params, env)),
             train_state)
    torch.cuda.reset_peak_memory_stats()
    logs, train_marks, launches = train_phase(step, start, train_cam, batch,
                                              rays)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"# trained {len(logs)} steps; launches {launches}")
    check_launched("training", launches, TRAINING_KERNELS)
    check_train_logs(logs, capacity)
    log("# losses per step: " + json.dumps(
        [round(float(lg["total_loss"]), 6) for lg in logs]) + "; last "
        + json.dumps({k: round(float(v), 6) for k, v in logs[-1].items()}))
    first = check_torch_backend(step, make_step(cfg, capacity, "torch"),
                                start, train_cam, batch, rays)
    check_repeat(step, start, train_cam, batch, rays, first)
    step_rows = make_step(cfg, capacity, layout="rows")
    check_repeat(step_rows, start, train_cam, batch, rays, first,
                 what="rows-layout step vs gather-layout step")
    del first

    # 8. training in both layouts, in turns
    train_ab = {"gather": [], "rows": []}
    for i in range(AB_ROUNDS):
        for layout, st in (("gather", step), ("rows", step_rows)):
            lg, m, lc = train_phase(st, start, train_cam, batch, rays,
                                    steps=3)
            log(f"# A/B round {i}, {layout} layout: median "
                f"{np.median([x[0][1].elapsed_time(x[-1][1]) for x in m]):.3f}"
                f" ms/step over {len(m)} steps")
            check_train_logs(lg, capacity)
            check_launched(f"training ({layout})", lc, TRAINING_KERNELS
                           + (("pad_lanes",) if layout == "rows" else ()))
            train_ab[layout] += m
            if layout == "rows":
                rows_bwd_launches = lc["composite_bwd"]

    # 9. the trainer: cli.train at full width, then cli.render on its
    # checkpoint; after the timed paths, so that its grown model does
    # not reach them, and its tensors are freed before the next phase
    trainer_phase(cams, seed, dev, card)

    # 10. the quality gate (and kernel parity at its shapes), before the
    # profiler sessions of the next phases
    gate = gate_phase(seed, dev, card)

    # 11. kernel parity at the slices' shapes, after the timed paths (the
    # profiler sessions of the kernels' device times run here)
    log("# kernel parity")
    rec = kernel_phase(cfg, params, state, env, rays, reqs[0], capacity,
                       seed)
    backward_kernel_phase(rec, cfg, params, train_state, env, rays,
                          train_cam, batch, capacity, seed)
    segment_sum_cases(dev, seed)

    # 12. the lab (E1, E2)
    log("# lab: adgs_tpu_torch.exp.lab_rowmajor at its defaults")
    lab_recs, lab_launches = lab_phase(dev, seed)
    log(f"# lab launches {lab_launches}")
    check_launched("lab", lab_launches, LAB_KERNELS)
    for r in lab_recs.values():
        r["launches"] = lab_launches[r["kernel"]]
    rec.update(lab_recs)

    rec["pad_lanes"]["launches"] = cli["rows"][1]["pad_lanes"]
    rec["composite_fwd"]["launches"] = serve_launches["composite_fwd"]
    rec["composite_fwd_rows"]["launches"] = cli["rows"][1]["composite_fwd"]
    rec["composite_bwd_rows"]["launches"] = rows_bwd_launches

    # 13. times
    report_marks("frame", marks)
    log(f"# peak device memory: serving {serve_peak_gb:.2f} GB, training "
        f"{train_peak_gb:.2f} GB")
    report_marks("training step", train_marks)
    for layout, m in ab.items():
        report_marks(f"frame, {layout} layout (A/B, {AB_ROUNDS} x "
                     f"{FRAMES} requests)", m)
    for layout, m in train_ab.items():
        report_marks(f"training step, {layout} layout (A/B, {AB_ROUNDS} x 3 "
                     "steps)", m)
    profile_call("one request", make_staged_render_fn(cfg, capacity=capacity),
                 (reqs[1], params, state, env, rays))
    profile_call("one training step", step,
                 start + (train_cam, batch, rays, ITERATION))
    kernels = []
    # one entry per record: B5 has two, one for each set of rows it sums;
    # B3 and B4 one per instance layout; E2 one per variant of the lab.
    # launches: the training path's, or those of the path the record names
    for key, r in rec.items():
        name = r.get("kernel", key)
        meta = KERNELS[name]
        t_bytes = r["bytes"] / HBM_BYTES_S * 1e3
        t_ops = r["flops"] / FP32_FLOP_S * 1e3
        entry = dict(
            name=name, id=meta["id"], route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=r.get("launches", launches[name]),
            serve_launches=serve_launches[name],
            gate_launches=gate["launches"][name],
            max_abs_err=r["max_abs_err"], max_abs_diff=r["max_abs_err"],
            ms=r["ms"], kernel_ms=r["ms"], device_ms=r["device_ms"],
            plain_ms=r["plain_ms"], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"],
            library_device_ms=r["library_device_ms"])
        if "use" in r:
            entry["use"] = r["use"]
        kernels.append(entry)
        log(f"# {meta['id']} {r.get('use', name)}: {r['ms']:.4f} ms "
            f"(device {fmt_ms(r['device_ms'])}), bound "
            f"{entry['bound_ms']:.4f} ({entry['bound_by']}), library "
            f"{fmt_ms(r['library_ms'])} (device "
            f"{fmt_ms(r['library_device_ms'])}), plain {r['plain_ms']:.4f}")
    missing = set(KERNELS) - {k["name"] for k in kernels}
    if missing:
        raise AssertionError(f"no parity record for {sorted(missing)}")
    pairs = rec["composite_fwd"]["pairs"]
    log(f"# B3 pairs at ch=4: {int(pairs.hit)} composited, "
        f"{int(pairs.gated)} gated or stopping, of which {int(pairs.culled)} "
        "culled (never evaluated)")
    pairs = rec["composite_bwd"]["pairs"]
    log(f"# B4 pairs replayed at ch=8: {int(pairs.hit)} composited, "
        f"{int(pairs.gated)} gated or stopping")
    log(f"# B7 distinct tapped cells: {rec['grid_sample']['distinct_cells']}")

    # 14. scene preparation, then cli.train on the scene it wrote
    prep_phase(seed, dev, card)
    return kernels


if __name__ == "__main__":
    sys.exit(main())
