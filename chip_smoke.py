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
     kernel launched; one frame held to the plain twins (the same render
     under adgs_tpu_torch._kernels.plain()) at 1e-4;
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
     the same step under _kernels.plain(), every twin, Adam's included
     (logs 1e-4, gradients rtol 5e-3 atol 2e-5, updated parameters as
     tests/test_torch_train.py, statistics); one
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
     16, 33, 98), each case launched twice and bitwise equal, and timed
     at the train cells' patterns (b5_train_pattern: the compositing
     backward's 2,007,040 slots with their run of 700,832 empty ones at
     0.66 M and 1.48 M rows of D 16, the KNN rows with 306,208 in segment
     0 at D 89 and 137); in the rows
     instance layout (ADGS_RM=1), B6 lane pad bitwise against its twin
     and F.pad, B3 and B4 bitwise against their gather layout; A1 Adam
     (csrc/adam.cu, one launch over every leaf) bitwise its plain twin on
     a training step's gradients (its leaves whose pointers are off 16
     bytes logged), and over three steps, each from its own outputs, at
     both train cells' leaf shapes (port_bench/scene.py sizes(spec, 2):
     487,170,135 and 555,065,344 floats, the 3x8192x8192 sky; KITTI from
     step 5251, Waymo from step 1), on the sharded update's slices (rank
     1 of 2, the sky's on axis 1, made contiguous; also bitwise the full
     update's slice), and on odd, empty and unaligned leaves; its time
     beside its 28-byte-a-float bound, its twin and torch._fused_adam_.
     This phase and the next run after the timed paths, so that their
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
15. multi-device (adgs_tpu_torch.parallel): ranks started by
     parallel/launch.py, over gloo on one card (NCCL refuses two ranks on
     one GPU), this process the single-device reference. The full-width
     step model of phases 3-8 with tile D = 2: slab mode with the
     primitive exchange on and off, each held to make_train_step on the
     same inputs at tests/test_parallel.py's bars (every log term rtol
     1e-4, gradients rtol 5e-3 atol 1e-6, updated scene_xyz rtol 1e-3
     atol 1e-7, denom bitwise), every training kernel launched on every
     rank, both ranks' updates bitwise equal; gathered mode's logs within
     rtol 2e-5 atol 1e-7 of slab mode's; each rank's ms/step and peak
     memory (ranks sharing one card: not a scaling figure); the camera
     batch {"data": 2, "tile": 1} at the same width (loss the mean of two
     single-device steps at rtol 1e-4, denom their sum at atol 1e-5); the
     2-D mesh {"data": 2, "tile": 2} on four ranks at the gate's shapes
     (gradients against the singles' mean); cli.train --devices 2 on a
     1242x375 KITTI-format scene for 20 iterations (densify, opacity
     reset, KNN refresh, exchange- and instance-capacity growths forced;
     every loss finite and equal across ranks, a bitwise replica check
     after every densify, files by rank 0 alone, cli.render of its
     checkpoint within 1/255 of rank 0's in-memory render); the D = 2
     step over NCCL where there are two cards. The kernels line's
     multi_launches are the D = 2 slab step's launches on rank 0.
Phases 3-15 are `run(device, seed)`, which a CPU rehearsal can call at a
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
    "adam": dict(id="A1", source="adgs_tpu_torch/csrc/adam.cu",
                 replaces="none (XLA fuses adgs_tpu/train/optim.py:121)"),
    "preprocess": dict(id="P1", source="adgs_tpu_torch/csrc/preprocess.cu",
                       replaces="none (XLA fuses "
                                "adgs_tpu/raster/preprocess.py:48)"),
    "preprocess_bwd": dict(id="P2",
                           source="adgs_tpu_torch/csrc/preprocess.cu",
                           replaces="none (XLA fuses the VJP of "
                                    "adgs_tpu/raster/preprocess.py:48)"),
    "deform": dict(id="T1", source="adgs_tpu_torch/csrc/deform.cu",
                   replaces="none (XLA fuses "
                            "adgs_tpu/models/gaussians.py:326)"),
    "deform_bwd": dict(id="T2", source="adgs_tpu_torch/csrc/deform.cu",
                       replaces="none (XLA fuses the VJP of "
                                "adgs_tpu/models/gaussians.py:326)"),
}
SERVING_KERNELS = ("deform", "preprocess", "compact_live", "expand",
                   "composite_fwd", "grid_sample")
TRAINING_KERNELS = ("deform", "deform_bwd", "preprocess", "preprocess_bwd",
                    "compact_live", "expand", "composite_fwd",
                    "composite_bwd", "segment_sum", "grid_sample",
                    "grid_sample_bwd", "adam")
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
    event at all, or only some: a session whose count of device events is
    not a whole multiple of `calls` (each call launches the same work) is
    run again, up to `sessions` in all, and None is returned if none
    records them all."""
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
        if kernels and sum(e.count for e in kernels) % calls == 0:
            return sum(getattr(e, attr) for e in kernels) / 1e3 / calls
    log("  (the profiler recorded no whole session of device time in "
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
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.models.gaussians import activated_scaling, deform
    from adgs_tpu_torch.raster.binning import bin_gaussians
    from adgs_tpu_torch.raster.preprocess import preprocess
    from adgs_tpu_torch.render import settings_for_camera
    st = settings_for_camera(cam, cfg.sh_degree)
    pkg, _ = deform(params, state, cfg, cam.time)
    prep = preprocess(pkg["xyz"], activated_scaling(params), pkg["rotation"],
                      pkg["opacity"], pkg["shs"], st, active_mask=state.alive)
    with _kernels.plain():
        return st, prep, bin_gaussians(prep, st, capacity)


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


# the train cells' slots (port_bench/scene.py sizes(spec, 2)): the scene
# block, its alive part, the object block, its alive part
B5_SCENE_SLOTS, B5_SCENE_ALIVE = 1_400_832, 700_000
B5_OBJ_SLOTS, B5_OBJ_ALIVE = 606_208, 300_000
B5_KNN_K = 8              # members of a KNN group


def b5_train_pattern(rng, kind: str, rows_used: int = 0):
    """(R, bounds [n+1] int32) of B5 at a train cell's shape, from the
    numpy Generator rng. "composite": the compositing backward over the
    slots [scene | object], each block alive then dead, so the dead scene
    slots are a run of 700,832 empty segments in the middle and the dead
    object slots a tail at bounds[n]; each alive slot takes a geometric
    count of rows (mean rows_used / alive: 0.66 M or 1.48 M in all) and
    the rows end at 92% of R, as the instance capacity leaves them.
    "knn": the KNN group gather's rows, one per member of the object
    block's anchors (obj slots / 8 groups of 8), the valid ones (alive /
    8) on random alive values and the rest on value 0 (ops/knn.py), over
    n = the object slots."""
    if kind == "composite":
        alive = B5_SCENE_ALIVE + B5_OBJ_ALIVE
        p = 1.0 / (1.0 + rows_used / alive)
        lens = np.zeros(B5_SCENE_SLOTS + B5_OBJ_SLOTS, np.int64)
        tiles = rng.geometric(p, size=alive) - 1
        lens[:B5_SCENE_ALIVE] = tiles[:B5_SCENE_ALIVE]
        lens[B5_SCENE_SLOTS:B5_SCENE_SLOTS + B5_OBJ_ALIVE] = \
            tiles[B5_SCENE_ALIVE:]
        bounds = np.concatenate([[0], np.cumsum(lens)])
        return int(math.ceil(bounds[-1] / CAP_HEADROOM)), \
            bounds.astype(np.int32)
    valid = B5_OBJ_ALIVE // B5_KNN_K * B5_KNN_K
    ids = np.concatenate([rng.integers(0, B5_OBJ_ALIVE, size=valid),
                          np.zeros(B5_OBJ_SLOTS - valid, np.int64)])
    ids.sort()
    bounds = np.searchsorted(ids, np.arange(B5_OBJ_SLOTS + 1))
    return B5_OBJ_SLOTS, bounds.astype(np.int32)


# B5's records at the train cells' patterns: (key, kind, rows_used, D)
B5_TRAIN_CASES = (
    ("segment_sum_composite_0.66M", "composite", 660_000, 16),
    ("segment_sum_composite_1.48M", "composite", 1_480_000, 16),
    ("segment_sum_knn_89", "knn", 0, 89),
    ("segment_sum_knn_137", "knn", 0, 137),
)


def segment_sum_cases(dev, seed) -> dict:
    """B5's synthetic cases, for D in 1, 3, 16, 33, 98: one segment of
    100,000 rows among 50,000 segments of 0-3 rows; every segment empty
    (bounds[0] = bounds[n] inside the rows); bounds[0] > 0 with bounds[n]
    < R; rows N(0,1) from the seed. Then the train cells' patterns
    (B5_TRAIN_CASES), each checked and timed: returns their records."""
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
    recs = {}
    for key, kind, used, D in B5_TRAIN_CASES:
        R, b = b5_train_pattern(rng, kind, used)
        lens = np.diff(b)
        owner = torch.as_tensor(np.repeat(np.arange(len(lens)), lens),
                                device=dev)
        recs[key] = segment_sum_record(
            f"B5 D={D}, {key}", rows(R, D), tensor(b), owner,
            f"train cells' {kind} pattern")
        recs[key]["kernel"] = "segment_sum"
    return recs


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
    # point at value 0): its blocks in parallel, then the carries' levels
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
        median_step_ms_no_densify=float(np.median(plain)),
        step_ms=[round(s[1], 3) for s in probe.steps],
        losses=[round(float(x), 6) for x in losses],
        densify=probe.densify, resets=probe.resets,
        refreshes=probe.refreshes, knn_recall=probe.recall,
        gaussian_growths=probe.grows, instance_growths=probe.instance_grows,
        peak_gb=peak_gb, cli_render=res)
    log(f"# trainer ({card}): " + json.dumps(summary))
    log(f"# trainer ({card}): median "
        f"{summary['median_step_ms_no_densify']:.3f} ms/step over "
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
        steps=len(probe.steps),
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
    log(f"# quality gate ({card}): median "
        f"{summary['median_step_ms_no_densify']:.3f} ms/step over "
        f"{len(plain)} "
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


def make_step(cfg, capacity, layout="gather"):
    from adgs_tpu_torch.train.config import OptimizationConfig
    from adgs_tpu_torch.train.step import make_train_step
    return make_train_step(cfg, OptimizationConfig(),
                           frame_gap=1.0 / FRAME_NUM,
                           scene_extent=SCENE_EXTENT,
                           cameras_extent=CAMERAS_EXTENT, capacity=capacity,
                           layout=layout)


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


def check_plain_step(step, start, cam, batch, rays):
    """One step from `start` through the kernels and again under
    _kernels.plain() (every twin, Adam's included), held to
    tests/test_torch_train.py's bars."""
    import torch
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.train.config import OptimizationConfig
    from adgs_tpu_torch.train.optim import TrainableState, leaves, lr_tree

    p, e, o, s = start
    args = (p, e, s, cam, batch, rays)
    lg_k = step.loss_and_grads(*args)
    with _kernels.plain():
        lg_t = step.loss_and_grads(*args)
    for k in lg_k.logs:
        check_close(f"train {k} vs the plain step", lg_k.logs[k],
                    lg_t.logs[k], 0.0, 1e-4)
    if not torch.equal(lg_k.num_rendered, lg_t.num_rendered):
        raise AssertionError("num_rendered disagrees with the plain step")
    for (name, gk), (_, gt) in zip(_named_leaves(lg_k.grads),
                                   _named_leaves(lg_t.grads)):
        check_close(f"train grad {name} vs the plain step", gk, gt,
                    2e-5, 5e-3)
    out_k = step(p, e, o, s, cam, batch, rays, ITERATION)
    with _kernels.plain():
        out_t = step(p, e, o, s, cam, batch, rays, ITERATION)
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
            raise AssertionError(f"updated {name} disagrees with the plain "
                                 f"step: max |diff| {float(diff.max())}")
    log(f"  updated parameters vs the plain step: max |diff| {worst:.3e} "
        "(atol 1e-5, 2 lr where |g| < 2e-5) ok")
    sk, st_ = out_k[3], out_t[3]
    for name in ("denom", "max_radii2d"):
        same = bool(torch.equal(getattr(sk, name), getattr(st_, name)))
        log(f"  stats {name} vs the plain step: "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{name} disagrees with the plain step")
    check_close("stats xyz_grad_accum vs the plain step",
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
# 11b. Adam: adam_update_kernel (csrc/adam.cu) bitwise its plain twin
# ---------------------------------------------------------------------------
# The train cells' padded leaves: port_bench/scene.py sizes(spec, 2) of
# each configuration (1,000,000 Gaussians, 30% object, capacities doubled
# by the first densify), SH degree 3, the 3 x ENV_RES^2 sky.
ADAM_CAPACITY = (1_400_832, 606_208)          # scene, object slots
ADAM_CONFIGS = (("kitti-75", 52, True), ("waymo", 100, False))
ADAM_ODD = (0, 1, 3, 5, 4097, 16385, 3 * 16384 + 2)   # floats of odd leaves
ADAM_STEPS = 3
ADAM_START = 5250         # the train cells' first iteration
ADAM_DEAD = 0.3           # share of each Gaussian block's slots left dead
ADAM_OPS = 13             # f32 operations an element (csrc/adam.cu)


def adam_leaf_shapes(frame_num: int, background: bool) -> list:
    """leaves() shapes of a configuration's model: order_args xyz [None, 5,
    0, 6, 0, 0], rotation [0, 0, 0, 0, None, 5], shs [0, 0, 0, 6, 0, 0],
    background as xyz or all zero (the reader fills None with frame_num //
    3)."""
    third = frame_num // 3
    c_xyz, c_rot, c_shs = third + 12, third, 12
    c_bg = third + 12 if background else 0
    ns, no = ADAM_CAPACITY
    block = lambda n: [(n, 3), (n, 1, 3), (n, 15, 3), (n, 3), (n, 4),
                       (n, 1), (n, 3, c_shs)]
    return (block(ns) + block(no)
            + [(no, 3, c_xyz), (no, 4, c_rot), (no, 2), (1, 3, c_bg),
               (3, ENV_RES, ENV_RES)])


def adam_dead(x):
    """x with the rows of its dead slots zeroed: the last ADAM_DEAD of a
    Gaussian leaf's first axis (not of the sky's three channels)."""
    if x.dim() > 1 and x.shape[0] in ADAM_CAPACITY:
        x[int(x.shape[0] * (1 - ADAM_DEAD)):] = 0.0
    return x


def adam_inputs(gen, dev, shapes):
    """Random p, m, v (v >= 0) of the shapes, the moments zero on the dead
    slots."""
    import torch
    ps = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    ms = [adam_dead(1e-2 * torch.randn(s, generator=gen, device=dev))
          for s in shapes]
    vs = [adam_dead(1e-4 * torch.randn(s, generator=gen, device=dev) ** 2)
          for s in shapes]
    return ps, ms, vs


def adam_grads(gen, dev, shapes):
    """N(0, 1e-2) gradients, zero on the dead slots, a few exact zeros and
    subnormals among the live ones."""
    import torch
    out = []
    for s in shapes:
        g = adam_dead(1e-2 * torch.randn(s, generator=gen, device=dev))
        flat = g.view(-1)
        flat[::1009] = 0.0
        flat[7::2003] = 1e-40
        out.append(g)
    return out


def adam_chain(what, gen, dev, ps, ms, vs, lrs, steps=ADAM_STEPS,
               count0=ADAM_START):
    """`steps` Adam steps of the kernel (under the sync debug mode's
    "error": no synchronize) and of its plain twin, each from its own
    previous outputs, on fresh gradients a step: p', m', v' bitwise equal
    after every step. Returns the last step's inputs."""
    import torch
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.train import optim as topt
    shapes = [tuple(p.shape) for p in ps]
    count = torch.tensor(count0, dtype=torch.int32)
    kern = twin = (ps, ms, vs)
    for i in range(steps):
        gs = adam_grads(gen, dev, shapes)
        count, bc1, bc2 = topt.next_count(count)
        before = _kernels.launches["adam"]
        kern_in = kern
        # the launch reads no value back from the card
        torch.cuda.set_sync_debug_mode("error")
        try:
            kern = topt.adam_leaves(kern[0], gs, kern[1], kern[2], lrs, bc1,
                                    bc2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        twin = topt.adam_leaves_torch(twin[0], gs, twin[1], twin[2], lrs,
                                      bc1, bc2)
        torch.cuda.synchronize()
        launched = _kernels.launches["adam"] - before
        want = 1 if sum(p.numel() for p in ps) else 0
        if launched != want:
            raise AssertionError(f"{what}: {launched} launches, not {want}")
        check_bitwise(f"A1 {what}, step {i + 1} (count {int(count)}): "
                      "p', m', v' vs the twin", tuple(sum(kern, [])),
                      tuple(sum(twin, [])))
    return kern_in[0], gs, kern_in[1], kern_in[2], bc1, bc2


def adam_phase(dev, seed: int, real=None) -> dict:
    """A1 at both train configurations' leaf shapes, on odd and empty
    leaves, an unaligned leaf and the sharded slices, each over
    ADAM_STEPS steps bitwise its twin; `real` = (trainables, grads,
    opt_state) of a training step: that step's update bitwise the twin's,
    and which of its leaves run one float at a time. Times at the KITTI
    shapes: the kernel (CUDA events, device), its byte bound, the twin,
    and torch._fused_adam_ (one learning rate; a yardstick the port never
    calls)."""
    import torch
    from adgs_tpu_torch.train import optim as topt
    from adgs_tpu_torch.train.config import OptimizationConfig
    from adgs_tpu_torch.parallel.shard import _shard_axis
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    lrs = topt.leaves(topt.lr_tree(OptimizationConfig(), SCENE_EXTENT,
                                   CAMERAS_EXTENT, ADAM_START))
    if real is not None:
        tr, grads, st = real
        ps, gs = topt.leaves(tr), topt.leaves(grads)
        ms, vs = topt.leaves(st.m), topt.leaves(st.v)
        # the outputs are fresh, so an input off 16 bytes decides
        alone = [i for i, grp in enumerate(zip(ps, gs, ms, vs))
                 if any(t.data_ptr() % 16 for t in grp)]
        log(f"# A1 on a training step: {len(ps)} leaves, "
            f"{sum(p.numel() for p in ps)} floats; leaves one float at a "
            f"time: {alone}")
        _, bc1, bc2 = topt.next_count(st.count)
        check_bitwise("A1 on the training step's gradients vs the twin",
                      tuple(sum(topt.adam_leaves(ps, gs, ms, vs, lrs, bc1,
                                                 bc2), [])),
                      tuple(sum(topt.adam_leaves_torch(ps, gs, ms, vs, lrs,
                                                       bc1, bc2), [])))
        del tr, grads, st, ps, gs, ms, vs
    rec = None
    for name, frame_num, background in ADAM_CONFIGS:
        shapes = adam_leaf_shapes(frame_num, background)
        ps, ms, vs = adam_inputs(gen, dev, shapes)
        n = sum(p.numel() for p in ps)
        log(f"# A1 at {name}'s leaves: {len(shapes)} leaves, {n} floats "
            f"(sky {shapes[-1]}, background_deform {shapes[17]})")
        # KITTI from the cells' step count, Waymo from Adam's first step
        # (bias corrections far from 1)
        p, g, m, v, bc1, bc2 = adam_chain(
            name, gen, dev, ps, ms, vs, lrs,
            count0=ADAM_START if rec is None else 0)
        if rec is None:
            # the sharded update's slices (rank 1 of 2), made contiguous as
            # sharded_adam_update makes them, bitwise the full update's
            full = topt.adam_leaves(p, g, m, v, lrs, bc1, bc2)
            for i in (0, len(p) - 1):
                ax = _shard_axis(p[i], 2)
                per = p[i].shape[ax] // 2

                def part(x):
                    return x.narrow(ax, per, per).contiguous()

                got = topt.adam_leaves([part(p[i])], [part(g[i])],
                                       [part(m[i])], [part(v[i])],
                                       [lrs[i]], bc1, bc2)
                twin = topt.adam_leaves_torch(
                    [part(p[i])], [part(g[i])], [part(m[i])], [part(v[i])],
                    [lrs[i]], bc1, bc2)
                check_bitwise(f"A1 sharded slice of leaf {i} {shapes[i]} "
                              f"(axis {ax}) vs the twin and the full update",
                              tuple(sum(got, []) + sum(got, [])),
                              tuple(sum(twin, [])
                                    + [part(o[i]) for o in full]))
            del full

            def kernel():
                return topt.adam_leaves(p, g, m, v, lrs, bc1, bc2)

            def plain():
                return topt.adam_leaves_torch(p, g, m, v, lrs, bc1, bc2)

            t = times(kernel, 10)
            plain_ms = cuda_ms(plain, iters=3)
            rec = dict(kernel="adam", max_abs_err=0.0, plain_ms=plain_ms,
                       bytes=28 * n, flops=ADAM_OPS * n,
                       use=f"{name}: 19 leaves, {n} floats", **t)
            lib = adam_library(p, g, m, v)
            if lib is not None:
                rec.update(library_ms=cuda_ms(lib, iters=10),
                           library_device_ms=device_ms(lib))
            log(f"# A1 {name}: card {rec['ms']:.4f} ms, device "
                f"{fmt_ms(rec['device_ms'])}, bound "
                f"{28 * n / HBM_BYTES_S * 1e3:.4f} (28 B a float at 3.35 "
                f"TB/s), plain {plain_ms:.4f}, torch._fused_adam_ "
                f"{fmt_ms(rec['library_ms'])} (device "
                f"{fmt_ms(rec['library_device_ms'])})")
        del ps, ms, vs, p, g, m, v
        torch.cuda.empty_cache()

    # odd and empty leaves, and unaligned ones (one float at a time)
    shapes = [(k,) for k in ADAM_ODD]
    ps, ms, vs = adam_inputs(gen, dev, shapes)
    base = [torch.randn(4100, generator=gen, device=dev) for _ in range(3)]
    base[1].mul_(1e-2)
    base[2].pow_(2).mul_(1e-4)
    ps.append(base[0][1:])     # p and v 4 bytes off 16: no float4 body
    ms.append(base[1][:4099])
    vs.append(base[2][1:])
    adam_chain("odd and empty leaves, one unaligned", gen, dev, ps, ms, vs,
               lrs[:len(ps)], count0=0)
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# 11c. the EWA preprocess: P1 and P2 (csrc/preprocess.cu) against the plain
# version and P2's twin
# ---------------------------------------------------------------------------
PREP_SLOTS = sum(ADAM_CAPACITY)    # the train cells' 2,007,040 slots
PREP_CAMERAS = {"kitti-75": (1242, 375, 721.5377),
                "waymo": (1920, 1280, 2055.0),
                "nuscenes": (1600, 900, 1266.4)}
# f32 operations a slot, counted low: P1's geometry and, for a visible
# slot, its SH colour; P2's chain for a slot with a gradient
PREP_FWD_OPS, PREP_SH_OPS, PREP_BWD_OPS = 150, 100, 400


def preprocess_inputs(dev, seed: int, n: int, cam: str):
    """Settings and Gaussians before one of the cells' cameras: 30% of the
    slots dead (as the capacity-padded blocks), a sixteenth behind the
    camera, a sixteenth off to the side past the frustum clamp, a sixteenth
    below the 1/255 gate, a sixteenth of colours clamped at 0, SH 3."""
    import torch
    from adgs_tpu_torch.core.camera import Camera
    from adgs_tpu_torch.render import settings_for_camera
    width, height, focal = PREP_CAMERAS[cam]
    rng = np.random.default_rng(seed + 23)
    z = rng.uniform(1.0, 60.0, n)
    tx, ty = width / (2 * focal), height / (2 * focal)
    p = np.stack([rng.uniform(-1.1, 1.1, n) * tx * z,
                  rng.uniform(-1.1, 1.1, n) * ty * z, z], -1)
    q = n // 16
    p[:q, 2] = rng.uniform(-5.0, 0.19, q)
    p[q:2 * q, 0] = rng.choice([-1, 1], q) * 3.0 * tx * p[q:2 * q, 2]
    R, T = camera_poses()[1]
    g = dict(means3d=(p - T) @ R,
             scales=np.exp(rng.normal(-2.5, 0.6, (n, 3))),
             rotations=rng.normal(size=(n, 4)),
             opacities=rng.uniform(0.02, 0.99, n),
             shs=rng.normal(0.0, 0.3, (n, 16, 3)))
    g["rotations"] /= np.linalg.norm(g["rotations"], axis=-1, keepdims=True)
    g["opacities"][2 * q:3 * q] = 0.003
    g["shs"][3 * q:4 * q, 0] = -3.0
    dead = rng.random(n) < ADAM_DEAD
    g["means3d"][dead] = 0.0
    g["scales"][dead] = 1.0
    g["rotations"][dead] = (1.0, 0.0, 0.0, 0.0)
    g["opacities"][dead] = 1.0 / (1.0 + math.exp(15.0))
    cam_ = Camera.create(R=R, T=T, fovx=2 * math.atan(width / (2 * focal)),
                         fovy=2 * math.atan(height / (2 * focal)),
                         width=width, height=height, device=dev)
    t = {k: torch.as_tensor(v.astype(np.float32), device=dev)
         for k, v in g.items()}
    return (settings_for_camera(cam_, 3), t,
            torch.as_tensor(~dead, device=dev))


def sh_order_units(got, want, t, st, vis) -> float:
    """The largest |P1 - plain| of rgb on the visible slots, in units of
    2^-24 (sum_k |b_k sh_k| + 0.5): both sum the same K rounded terms, in
    another order, which moves each sum by at most ~K such units."""
    from adgs_tpu_torch.core import sh as sh_lib
    d = t["means3d"] - st.campos
    u = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    b = sh_lib.sh_basis(st.sh_degree, u)
    mag = (b[:, :, None].abs() * t["shs"][:, :b.shape[1]].abs()).sum(1)
    units = (got - want).abs() / ((mag + 0.5) * 2.0 ** -24)
    return float(units[vis].max())


def preprocess_phase(dev, seed: int) -> dict:
    """P1 at each train cell's camera over PREP_SLOTS slots: every output
    bitwise the plain version's but rgb, which on visible slots lies within
    2K units of its SH sum's rounding (sh_order_units) and is 0 elsewhere;
    P2 with N(0, 1) cotangents on the visible slots (a step's gradient
    reaches no other) within 1e-6 of its twin, the worst leaf by norm, and
    zeros elsewhere. Records at the KITTI camera: card and device ms, the
    byte bound (each input and output byte once, the SH rows only where a
    slot needs them), the plain version's ms (P1: preprocess_torch; P2: its
    twin) and the largest absolute error over the three cameras."""
    import torch
    from adgs_tpu_torch.raster import preprocess as prep
    n = PREP_SLOTS
    recs = {}
    p1_err = p2_err = 0.0
    for cam in PREP_CAMERAS:
        st, t, active = preprocess_inputs(dev, seed, n, cam)
        so = torch.zeros((n, 2), device=dev)
        args = (t["means3d"], t["scales"], t["rotations"], t["opacities"],
                t["shs"], st)
        kw = dict(screen_offset=so, active_mask=active)
        got = prep.preprocess(*args, **kw)
        want = prep.preprocess_torch(*args, **kw)
        vis = want.visible
        n_vis = int(vis.sum())
        for f in ("rect_min", "rect_max", "tiles_touched", "visible",
                  "radii", "mean2d", "depth", "conic", "extent"):
            check_bitwise(f"P1 {cam} {f} vs the plain version",
                          getattr(got, f), getattr(want, f))
        units = sh_order_units(got.rgb, want.rgb, t, st, vis)
        err = float((got.rgb[vis] - want.rgb[vis]).abs().max())
        off = int(torch.count_nonzero(got.rgb[~vis]))
        p1_err = max(p1_err, err)
        log(f"  P1 {cam} rgb vs the plain version: {err:.3e} at most on the "
            f"visible slots, {units:.2f} units of its SH sum's rounding "
            f"(limit 32), {off} nonzero off them")
        if units > 32 or off:
            raise AssertionError(f"P1 {cam} rgb: {units} units, {off} off")
        gen = torch.Generator(device=dev).manual_seed(seed + 29)
        cots = [torch.randn(s, generator=gen, device=dev)
                * (vis[:, None] if len(s) == 2 else vis)
                for s in ((n, 2), (n,), (n, 3), (n, 3))]
        bwd = prep._preprocess_bwd(t["means3d"], t["scales"], t["rotations"],
                                   t["shs"], st, *cots, want.radii)
        twin = prep.preprocess_bwd_torch(t["means3d"], t["scales"],
                                         t["rotations"], t["shs"], st, *cots,
                                         radii=want.radii)
        errs = [float((a - b).norm() / b.norm()) for a, b in zip(bwd, twin)]
        p2_err = max(p2_err, *(float((a - b).abs().max())
                                for a, b in zip(bwd, twin)))
        zeros = all(int(torch.count_nonzero(a[~vis])) == 0 for a in bwd)
        log(f"# P1/P2 at {cam}: {n} slots, {n_vis} visible; P2 vs its twin "
            f"by leaf (means, scales, rotations, shs) {errs}, zeros off the "
            f"visible slots {zeros}")
        if max(errs) > 1e-6 or not zeros:
            raise AssertionError(f"P2 at {cam}: {errs}, zeros {zeros}")
        if not recs:
            ins = (t["means3d"], t["scales"], t["rotations"], t["shs"], so,
                   t["opacities"], active, st)
            bwd_args = (t["means3d"], t["scales"], t["rotations"], t["shs"],
                        st, *cots, want.radii)
            fwd_t = times(lambda: prep._preprocess_fwd(*ins), 20)
            bwd_t = times(lambda: prep._preprocess_bwd(*bwd_args), 20)
            plain_ms = cuda_ms(lambda: prep.preprocess_torch(*args, **kw), 3)
            twin_ms = cuda_ms(lambda: prep.preprocess_bwd_torch(*bwd_args),
                              3)
            # P1: 53 B of geometry in and 69 B out a slot, 192 B of SH a
            # visible slot; P2: 36 B of gradients and 4 B of radius in and
            # 232 B out a slot, 40 B of geometry and 192 B of SH a slot
            # with a gradient
            recs["preprocess"] = dict(
                kernel="preprocess", plain_ms=plain_ms,
                bytes=122 * n + 192 * n_vis,
                flops=PREP_FWD_OPS * n + PREP_SH_OPS * n_vis,
                use=f"{cam}: {n} slots, {n_vis} visible, SH 3", **fwd_t)
            recs["preprocess_bwd"] = dict(
                kernel="preprocess_bwd", plain_ms=twin_ms,
                bytes=272 * n + 232 * n_vis,
                flops=PREP_BWD_OPS * n_vis,
                use=f"{cam}: {n} slots, {n_vis} with a gradient", **bwd_t)
            for key, r in recs.items():
                log(f"# {KERNELS[key]['id']} {cam}: card {r['ms']:.4f} ms, "
                    f"device {fmt_ms(r['device_ms'])}, bound "
                    f"{r['bytes'] / HBM_BYTES_S * 1e3:.4f} ({r['bytes']} B "
                    f"at 3.35 TB/s), plain {r['plain_ms']:.4f}")
        del t, got, want, bwd, twin, cots
        torch.cuda.empty_cache()
    recs["preprocess"]["max_abs_err"] = p1_err
    recs["preprocess_bwd"]["max_abs_err"] = p2_err
    return recs


# ---------------------------------------------------------------------------
# 11d. the temporal deformation: T1 and T2 (csrc/deform.cu) against the
# plain version and autograd through it
# ---------------------------------------------------------------------------
DEFORM_CONFIGS = {   # order arguments, frames (port_bench/configs)
    "kitti-75": (KITTI_75, 52),
    "waymo": (dict(KITTI_75, background=[0, 0, 0, 0, 0, 0]), 100)}
DEFORM_TIMES = (0.4137, 0.4329)    # the camera's time, the flow time
# f32 operations a slot, counted low: T1's scene slot (colour trajectory,
# normalization, sigmoid) and object slot (xyz at two times, the order-5
# quaternion chain, the time mask); T2's are about twice those
DEFORM_SCENE_OPS, DEFORM_OBJ_OPS = 100, 1000
# T1's outputs must be bitwise the plain version's; T2's leaves within this
# of autograd through it (relative, the worst leaf by norm)
DEFORM_BWD_GAP = 1e-5


def deform_inputs(dev, seed: int, cfg_name: str):
    """A model at the train cells' capacity (ADAM_CAPACITY) under one
    configuration, ADAM_DEAD of each block dead (zero trajectories, identity
    rotations, as the capacity padding), the live slots' trajectories
    N(0, 0.3) so that every term moves; and N(0, 1) gradients of the five
    outputs. Returns (config, gs_time, t, flow_time, leaves, grads)."""
    import torch
    from adgs_tpu_torch.models import gaussians as gm
    orders, frames = DEFORM_CONFIGS[cfg_name]
    cfg = gm.GaussianConfig.from_order_args(orders, frame_num=frames)
    ns, no = ADAM_CAPACITY
    k = (cfg.sh_degree + 1) ** 2
    gen = torch.Generator(device=dev).manual_seed(seed + 31)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    shapes = {"scene_xyz": (ns, 3), "scene_shs_dc": (ns, 1, 3),
              "scene_shs_rest": (ns, k - 1, 3), "scene_rotation": (ns, 4),
              "scene_opacity": (ns, 1),
              "scene_shs_deform": (ns, 3, cfg.shs.param_count),
              "obj_xyz": (no, 3), "obj_shs_dc": (no, 1, 3),
              "obj_shs_rest": (no, k - 1, 3), "obj_rotation": (no, 4),
              "obj_opacity": (no, 1),
              "obj_shs_deform": (no, 3, cfg.shs.param_count),
              "xyz_deform": (no, 3, cfg.xyz.param_count),
              "rotation_deform": (no, 4, cfg.rotation.param_count),
              "gs_time_sigma": (no, 2),
              "background_deform": (1, 3, cfg.background.param_count)}
    leaves = {name: rnd(*shape, scale=0.3 if len(shape) == 3 else 1.0)
              for name, shape in shapes.items()}
    leaves["gs_time_sigma"] = leaves["gs_time_sigma"] * 0.5 - 3.0
    for block, n in (("scene", ns), ("obj", no)):
        dead = torch.rand(n, generator=gen, device=dev) < ADAM_DEAD
        names = [x for x in shapes if x.startswith(block)]
        if block == "obj":
            names += ["xyz_deform", "rotation_deform", "gs_time_sigma"]
        for name in names:
            leaves[name][dead] = 0.0
        leaves[f"{block}_rotation"][dead, 0] = 1.0
        leaves[f"{block}_opacity"][dead] = -15.0
    gs_time = torch.rand(no, generator=gen, device=dev)
    t, ft = (torch.tensor(x, device=dev) for x in DEFORM_TIMES)
    n = ns + no
    grads = [rnd(n, 3), rnd(n, 3), rnd(n, 4), rnd(n, k, 3), rnd(n, 1)]
    return (cfg, gs_time, t, ft,
            tuple(leaves[x] for x in gm.DEFORM_LEAVES), grads)


def deform_bytes(cfg, ns: int, no: int, k: int) -> tuple[int, int]:
    """T1's and T2's bytes at DEFORM_TIMES, each input byte read once and
    each output byte written once: the columns a slot's trajectories read
    at either time, the rows the outputs and the leaves' gradients fill."""
    def cols(b, times):
        used = set()
        for t in times:
            if b.bspline_ctrl:
                iv = b.bspline_ctrl - b.bspline_order
                s = min(max(math.floor(t * iv), 0), iv - 1)
                used.update(range(s, s + b.bspline_order + 1))
            used.update(range(b.bspline_ctrl,
                              b.bspline_ctrl + b.poly_order + 2 * b.fft_order))
            if b.quat_ctrl and t == times[0]:
                iv = b.quat_ctrl - b.quat_order
                s = min(max(math.floor(t * iv), 0), iv - 1)
                q0 = b.param_count - b.quat_ctrl
                used.update(range(q0 + s, q0 + s + b.quat_order + 1))
        return len(used)

    two, one = DEFORM_TIMES, DEFORM_TIMES[:1]
    shs_in = 3 * cols(cfg.shs, one)
    scene_in = 3 + 3 * k + 4 + 1 + shs_in
    obj_in = scene_in + 3 * cols(cfg.xyz, two) + 4 * cols(cfg.rotation, one) \
        + 2 + 1
    out = 3 + 3 + 4 + 3 * k + 1
    t1 = 4 * (ns * (scene_in + out) + no * (obj_in + out))
    grads_in = 3 + 3 + 4 + 3 * k + 1
    scene_g = 3 + 4 + 3 * k + 1 + 3 * cfg.shs.param_count
    obj_g = 3 + 3 * k + 1 + 3 * cfg.shs.param_count + 3 * cfg.xyz.param_count \
        + 4 * cfg.rotation.param_count + 2
    scene_read = 4 + 1
    obj_read = 4 * cols(cfg.rotation, one) + 1 + 2 + 1
    t2 = 4 * (ns * (grads_in + scene_read + scene_g)
              + no * (grads_in + obj_read + obj_g))
    return t1, t2


def ulps(a, b) -> int:
    """The largest distance in float32 units of the last place between two
    tensors of the same shape (0 where both are equal, -0 and +0 too)."""
    import torch
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def deform_phase(dev, seed: int) -> dict:
    """T1 and T2 at the train cells' 2,007,040 slots under kitti-75's and
    waymo's deformation: every T1 output (with the flow-time xyz) bitwise
    the plain version's, every T2 leaf within DEFORM_BWD_GAP of autograd
    through it (None exactly where that gives none), each bitwise on a
    repeated launch. Records at kitti-75: card and device ms, the byte
    bound, the plain version's ms (T2: autograd through it, its forward
    included) and the largest absolute error over both configurations."""
    import torch
    from adgs_tpu_torch.models import gaussians as gm
    recs = {}
    t1_err = t2_err = 0.0
    for name in DEFORM_CONFIGS:
        cfg, gs_time, t, ft, leaves, grads = deform_inputs(dev, seed, name)
        got = gm._deform_fwd(cfg, gs_time, t, ft, leaves)
        want = gm.deform_fwd_torch(cfg, gs_time, t, ft, leaves)
        again = gm._deform_fwd(cfg, gs_time, t, ft, leaves)
        dist = {}
        for out, a, b, c in zip(("xyz", "rotation", "shs", "opacity",
                                 "flow xyz"), got, want, again):
            check_bitwise(f"T1 {name} {out} on a repeated launch", a, c)
            dist[out] = ulps(a, b)
            t1_err = max(t1_err, float((a - b).abs().max()))
        log(f"# T1 {name} vs the plain version, ulps by output: {dist}")
        if any(dist.values()):
            raise AssertionError(f"T1 {name}: {dist}")
        needs = [True] * len(leaves)
        bwd = gm._deform_bwd(cfg, gs_time, t, ft, leaves, grads, needs)
        twin = gm.deform_bwd_torch(cfg, gs_time, t, ft, leaves, grads, needs)
        again = gm._deform_bwd(cfg, gs_time, t, ft, leaves, grads, needs)
        gaps = {}
        for leaf, a, b, c in zip(gm.DEFORM_LEAVES, bwd, twin, again):
            if (a is None) != (b is None):
                raise AssertionError(f"T2 {name} {leaf}: a gradient where "
                                     "autograd gives none, or none where "
                                     "it gives one")
            if a is None:
                continue
            check_bitwise(f"T2 {name} {leaf} on a repeated launch", a, c)
            gaps[leaf] = float((a - b).norm() / b.norm().clamp_min(1e-30))
            t2_err = max(t2_err, float((a - b).abs().max()))
        log(f"# T2 {name} vs autograd through the plain version, by leaf: "
            + json.dumps({k: f"{v:.2e}" for k, v in gaps.items()}))
        if max(gaps.values()) > DEFORM_BWD_GAP:
            raise AssertionError(f"T2 {name}: {gaps}")
        if not recs:
            ns, no = ADAM_CAPACITY
            k = leaves[2].shape[1] + 1
            t1_bytes, t2_bytes = deform_bytes(cfg, ns, no, k)
            args = (cfg, gs_time, t, ft, leaves)
            fwd_t = times(lambda: gm._deform_fwd(*args), 20)
            bwd_t = times(lambda: gm._deform_bwd(*args, grads, needs), 20)
            plain_ms = cuda_ms(lambda: gm.deform_fwd_torch(*args), 3)
            twin_ms = cuda_ms(lambda: gm.deform_bwd_torch(*args, grads,
                                                          needs), 3)
            recs["deform"] = dict(
                kernel="deform", plain_ms=plain_ms, bytes=t1_bytes,
                flops=DEFORM_SCENE_OPS * ns + DEFORM_OBJ_OPS * no,
                use=f"{name}: {ns} scene and {no} object slots, the flow "
                    "xyz too", **fwd_t)
            recs["deform_bwd"] = dict(
                kernel="deform_bwd", plain_ms=twin_ms, bytes=t2_bytes,
                flops=2 * (DEFORM_SCENE_OPS * ns + DEFORM_OBJ_OPS * no),
                use=f"{name}: {ns} scene and {no} object slots, the flow "
                    "xyz too", **bwd_t)
            for key, r in recs.items():
                log(f"# {KERNELS[key]['id']} {name}: card {r['ms']:.4f} ms, "
                    f"device {fmt_ms(r['device_ms'])}, bound "
                    f"{r['bytes'] / HBM_BYTES_S * 1e3:.4f} ({r['bytes']} B "
                    f"at 3.35 TB/s), plain {r['plain_ms']:.4f}")
        del leaves, grads, got, want, again, bwd, twin
        torch.cuda.empty_cache()
    recs["deform"]["max_abs_err"] = t1_err
    recs["deform_bwd"]["max_abs_err"] = t2_err
    return recs


def adam_library(p, g, m, v):
    """torch._fused_adam_ over the same leaves (in place on copies, one
    learning rate, eps inside its own formula): a yardstick of what one
    PyTorch call takes, or None where this PyTorch has none."""
    import torch
    fused = getattr(torch, "_fused_adam_", None)
    if fused is None:
        log("  (torch._fused_adam_ is not in this PyTorch)")
        return None
    pc, mc, vc = ([x.clone() for x in xs] for xs in (p, m, v))
    steps = [torch.ones((), device=x.device) for x in p]

    def lib():
        fused(pc, list(g), mc, vc, [], steps, lr=1e-3, beta1=0.9,
              beta2=0.999, weight_decay=0.0, eps=1e-15, amsgrad=False,
              maximize=False)

    return lib


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


# ---------------------------------------------------------------------------
# 15. multi-device: the port's sharded training (adgs_tpu_torch.parallel)
# in ranks spawned by parallel/launch.py, over gloo on the one card (NCCL
# refuses two ranks on one GPU) and over NCCL where there are two cards;
# this process stays the single-device reference
# ---------------------------------------------------------------------------
MULTI_D = 2                       # tile ranks of the full-width step
MULTI_TIME_B = 0.25               # the second camera's time (data axis)
MULTI_TIMED = 1                   # timed slab steps a rank
MULTI_MESH = dict(n=6000, width=256, height=160, env_res=512)  # the gate's
MULTI_TRAIN_ITERS = 20
MULTI_TRAIN_POINTS = (100_000, 300_000)   # scene points, object points
MULTI_TRAIN_ENV = 2048            # the trainer run's sky resolution
MULTI_TRAIN_EXCHANGE = 8192       # exchange rows a pair: grown on overflow
MULTI_TRAIN_CAPACITY = 65536      # a slab's instances: grown on overflow
MULTI_TIMEOUT = 900               # seconds a spawn may take
SHARD_GRAD = dict(rtol=5e-3, atol=1e-6)   # tests/test_parallel.py's bars


def _to(x, dev):
    """x (a tensor, or a dataclass / NamedTuple / dict / list of them)
    on `dev`."""
    import dataclasses
    import torch
    if torch.is_tensor(x):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to(v, dev) for v in x])
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_config():
    from adgs_tpu_torch.models import gaussians as gm
    return gm.GaussianConfig.from_order_args(KITTI_75, frame_num=FRAME_NUM,
                                             sh_degree=3, use_time_mask=True)


def single_refs(step, start, cams, batch, rays, grads: str):
    """The single-device step from `start` on each camera: its logs,
    updated scene_xyz and statistics, on the host, then those of the
    camera batch (the loss mean, the statistics' sums). grads: "first"
    keeps the first camera's gradients, "mean" the batch's (the cameras'
    mean)."""
    import torch
    p, e, o, s = start
    out, gsum = [], None
    for i, cam in enumerate(cams):
        lg = step.loss_and_grads(p, e, s, cam, batch, rays)
        new = step(p, e, o, s, cam, batch, rays, ITERATION)
        g = [x for _, x in _named_leaves(lg.grads)]
        if grads == "mean":
            gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
        out.append(dict(
            logs={k: float(v) for k, v in lg.logs.items()},
            grads=[x.cpu() for x in g] if grads == "first" and i == 0
            else None,
            scene_xyz=new[0].scene_xyz.cpu(),
            denom=new[3].denom.cpu(), max_radii2d=new[3].max_radii2d.cpu(),
            xyz_grad_accum=new[3].xyz_grad_accum.cpu()))
        del lg, new, g
    base = dict(denom=s.denom.cpu(), xyz_grad_accum=s.xyz_grad_accum.cpu(),
                max_radii2d=s.max_radii2d.cpu())
    # B cameras a step: B reference iterations' worth of statistics
    out.append(dict(
        loss=float(np.mean([r["logs"]["total_loss"] for r in out])),
        denom=base["denom"] + sum(r["denom"] - base["denom"] for r in out),
        xyz_grad_accum=base["xyz_grad_accum"] + sum(
            r["xyz_grad_accum"] - base["xyz_grad_accum"] for r in out),
        max_radii2d=torch.stack([r["max_radii2d"] for r in out]).amax(0),
        grads=None if gsum is None else [(x / len(cams)).cpu()
                                         for x in gsum]))
    return out


def _rank_log(lines, msg):
    lines.append(msg)
    print(msg, flush=True)


def _close(lines, name, got, want, rtol, atol):
    """allclose of a rank's tensor against the reference (on the host
    when it is large), logged; raises where it fails."""
    import torch
    want = want.to(got.device)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = torch.allclose(got, want, rtol=rtol, atol=atol)
    if not ok:
        _rank_log(lines, f"  {name}: max |diff| {err:.3e} (rtol {rtol:g}, "
                         f"atol {atol:g}) FAIL")
        raise AssertionError(f"{name} disagrees with the single-device step")
    return err


def _hold_step(lines, what, lg, new, ref, logs_ref=True):
    """A sharded step (gradients `lg`, update `new`) held to the
    single-device reference `ref` at tests/test_parallel.py's bars."""
    import torch
    if logs_ref:
        for k, v in ref["logs"].items():
            if k == "num_rendered":
                continue
            got = float(lg.logs[k])
            if not np.isclose(got, v, rtol=1e-4, atol=0.0):
                raise AssertionError(f"{what} {k}: {got} vs {v}")
    worst = 0.0
    for (name, g), want in zip(_named_leaves(lg.grads), ref["grads"]):
        worst = max(worst, _close(lines, f"{what} grad {name}", g, want,
                                  **SHARD_GRAD))
    xyz = _close(lines, f"{what} updated scene_xyz", new[0].scene_xyz,
                 ref["scene_xyz"], 1e-3, 1e-7)
    if not torch.equal(new[3].denom, ref["denom"].to(new[3].denom.device)):
        raise AssertionError(f"{what}: denom not bitwise the reference's")
    _rank_log(lines, f"  {what}: total_loss {float(lg.logs['total_loss']):.6f}"
                     f" (single {ref['logs']['total_loss']:.6f}), gradients "
                     f"max |diff| {worst:.3e}, scene_xyz {xyz:.3e}, denom "
                     "bitwise")


def _replicas(new, what):
    from adgs_tpu_torch.parallel.mesh import check_replicas
    from adgs_tpu_torch.train.optim import TrainableState, leaves
    p, e, o, s = new[:4]
    check_replicas(leaves(TrainableState(p, e)) + leaves(o.m) + leaves(o.v)
                   + [s.denom, s.xyz_grad_accum, s.max_radii2d], what)


class collective_timers:
    """Wraps the collectives that parallel/ calls to add up the host
    seconds inside each (the device synchronized before and after), by
    name; `restore` puts them back."""

    def __init__(self, dev):
        import torch.distributed as dist
        from adgs_tpu_torch.parallel import collectives as cc
        self.seconds = {}
        self._put = []
        for owner, name in ((dist, "all_reduce"),
                            (dist, "all_to_all_single"),
                            (dist, "batch_isend_irecv"), (dist, "all_gather"),
                            (cc, "_gather_into"), (cc, "_reduce_scatter")):
            real = getattr(owner, name)
            self._put.append((owner, name, real))
            setattr(owner, name, self._timed(name.strip("_"), real, dev))

    def _timed(self, name, real, dev):
        def fn(*a, **k):
            _sync(dev)
            t0 = time.perf_counter()
            res = real(*a, **k)
            if isinstance(res, list):
                for w in res:
                    w.wait()
                res = []
            _sync(dev)
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0)
            return res
        return fn

    def restore(self):
        for owner, name, real in self._put:
            setattr(owner, name, real)


def multi_step_rank(path: str, backend: str, device: str = "cuda",
                    cases: str = "all") -> dict:
    """A rank of the full-width sharded step (tile D = 2: slab mode with
    the exchange on and off, gathered mode; then the camera batch on
    {"data": 2, "tile": 1}), held to the single-device reference that the
    parent wrote to `path` with the scene. cases "tile": the first only."""
    import torch
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.parallel.data_parallel import (stack_batches,
                                                       stack_cameras)
    from adgs_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from adgs_tpu_torch.parallel.shard import make_sharded_train_step
    from adgs_tpu_torch.train.config import OptimizationConfig
    from adgs_tpu_torch.train.optim import TrainableState, init_adam

    initialize_multihost(backend)
    mesh = make_mesh({"tile": MULTI_D}, device)
    dev, rank = mesh.device, mesh.rank
    lines = [f"rank {rank} on {dev} ({backend})"]
    data = torch.load(path, map_location="cpu", weights_only=False)
    sc, refs = _to(data["scene"], dev), data["refs"]
    params, env, state = sc["params"], sc["env"], sc["state"]
    batch, rays, cams = sc["batch"], sc["rays"], sc["cams"]
    opt_state = init_adam(TrainableState(params, env))
    cfg = step_config()
    cuda = dev.type == "cuda"

    def make(m, loss_mode="slab", exchange=True, data_axis=None):
        return make_sharded_train_step(
            cfg, OptimizationConfig(), frame_gap=1.0 / FRAME_NUM,
            scene_extent=SCENE_EXTENT, cameras_extent=CAMERAS_EXTENT,
            mesh=m, capacity=sc["capacity"], loss_mode=loss_mode,
            primitive_exchange=exchange, data_axis=data_axis)

    def run(step, cam, b, r):
        _kernels.reset_launches()
        lg = step.loss_and_grads(params, env, state, cam, b, r)
        new = step.update(params, env, opt_state, state, lg, ITERATION)
        _sync(dev)
        return lg, new, dict(_kernels.launches)

    out = dict(rank=rank, device=str(dev), backend=backend)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    slab_logs = {}
    for exchange in (True, False):
        what = f"slab, exchange {'on' if exchange else 'off'}"
        step = make(mesh, exchange=exchange)
        lg, new, launches = run(step, cams[0], batch, rays)
        if cuda:
            missing = [k for k in TRAINING_KERNELS if launches[k] <= 0]
            if missing:
                raise AssertionError(f"{what}: {missing} not launched")
        _hold_step(lines, what, lg, new, refs[0])
        _replicas(new, what)
        _rank_log(lines, f"  {what}: launches {launches}; "
                         f"{sum(launches.values())} in all; the {MULTI_D} "
                         "ranks' updates bitwise equal")
        out[f"launches_{'exchange' if exchange else 'gather'}"] = launches
        slab_logs[exchange] = {k: float(v) for k, v in lg.logs.items()}
        del lg, new
        if cases == "tile":
            break
    if cases == "tile":
        return out
    glg, gnew, _ = run(make(mesh, "gathered", True), cams[0], batch, rays)
    for k, v in slab_logs[True].items():
        # splat_instances: the slab path's sum over the slabs, which the
        # gathered path does not log
        if k in ("num_rendered", "exchange_overflow", "splat_instances"):
            continue
        if not np.isclose(v, float(glg.logs[k]), rtol=2e-5, atol=1e-7):
            raise AssertionError(f"slab vs gathered {k}: {v} vs "
                                 f"{float(glg.logs[k])}")
    _replicas(gnew, "gathered")
    _rank_log(lines, "  slab vs gathered (exchange on): every log term "
                     "within rtol 2e-5, atol 1e-7")
    del glg, gnew

    # ms/step of the slab step with the exchange, each rank by itself,
    # then the same steps with the seconds inside the collectives counted
    step = make(mesh)
    import torch.distributed as dist
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(MULTI_TIMED):
        res = step(params, env, opt_state, state, cams[0], batch, rays,
                   ITERATION)
    _sync(dev)
    out["ms_per_step"] = (time.perf_counter() - t0) / MULTI_TIMED * 1e3
    out["loss_timed"] = float(res[4]["total_loss"])
    del res
    spent = collective_timers(dev)
    try:
        for _ in range(MULTI_TIMED):
            step(params, env, opt_state, state, cams[0], batch, rays,
                 ITERATION)
        _sync(dev)
    finally:
        spent.restore()
    out["collective_ms"] = {k: v / MULTI_TIMED * 1e3
                            for k, v in spent.seconds.items()}
    _rank_log(lines, f"  collectives a step (host ms, synchronized): "
                     + json.dumps({k: round(v, 3) for k, v in
                                   out["collective_ms"].items()}))
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9

    # the camera batch: {"data": 2, "tile": 1}, a camera a rank
    dmesh = make_mesh({"data": 2, "tile": 1}, device)
    stacked = (stack_cameras(cams), stack_batches([batch, batch]),
               torch.stack([rays, rays]))
    lg, new, launches = run(make(dmesh, data_axis="data"), *stacked)
    ref = refs[-1]
    loss = float(lg.logs["total_loss"])
    if not np.isclose(loss, ref["loss"], rtol=1e-4, atol=0.0):
        raise AssertionError(f"camera batch loss {loss} vs the mean of two "
                             f"single-device steps {ref['loss']}")
    den = _close(lines, "camera batch denom", new[3].denom, ref["denom"],
                 0.0, 1e-5)
    _close(lines, "camera batch max_radii2d", new[3].max_radii2d,
           ref["max_radii2d"], 0.0, 1e-4)
    acc = _close(lines, "camera batch xyz_grad_accum",
                 new[3].xyz_grad_accum, ref["xyz_grad_accum"], 2e-3, 1e-6)
    _replicas(new, "camera batch")
    _rank_log(lines, f"  camera batch {{data: 2, tile: 1}}: loss {loss:.6f} "
                     f"(mean of singles {ref['loss']:.6f}), denom sum "
                     f"{den:.1e}, xyz_grad_accum {acc:.3e}; launches "
                     f"{launches}; updates bitwise equal")
    out["launches_batch"] = launches
    out["lines"] = lines
    return out


def multi_mesh_rank(path: str, backend: str, device: str = "cuda") -> dict:
    """A rank of the 2-D mesh {"data": 2, "tile": 2} at the gate's shapes,
    held to the mean of two single-device steps."""
    import torch
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.parallel.data_parallel import (stack_batches,
                                                       stack_cameras)
    from adgs_tpu_torch.parallel.mesh import initialize_multihost, make_mesh
    from adgs_tpu_torch.parallel.shard import make_sharded_train_step
    from adgs_tpu_torch.train.config import OptimizationConfig
    from adgs_tpu_torch.train.optim import TrainableState, init_adam

    initialize_multihost(backend)
    mesh = make_mesh({"data": 2, "tile": 2}, device)
    dev = mesh.device
    lines = [f"rank {mesh.rank} on {dev} ({backend}), coords {mesh.coords}"]
    data = torch.load(path, map_location="cpu", weights_only=False)
    sc, ref = _to(data["scene"], dev), data["refs"][-1]
    params, env, state = sc["params"], sc["env"], sc["state"]
    step = make_sharded_train_step(
        step_config(), OptimizationConfig(), frame_gap=1.0 / FRAME_NUM,
        scene_extent=SCENE_EXTENT, cameras_extent=CAMERAS_EXTENT, mesh=mesh,
        capacity=sc["capacity"], primitive_exchange=True, data_axis="data")
    opt_state = init_adam(TrainableState(params, env))
    _kernels.reset_launches()
    args = (stack_cameras(sc["cams"]),
            stack_batches([sc["batch"], sc["batch"]]),
            torch.stack([sc["rays"], sc["rays"]]))
    lg = step.loss_and_grads(params, env, state, *args)
    new = step.update(params, env, opt_state, state, lg, ITERATION)
    _sync(dev)
    launches = dict(_kernels.launches)
    if dev.type == "cuda":
        missing = [k for k in TRAINING_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"2-D mesh: {missing} not launched")
    loss = float(lg.logs["total_loss"])
    if not np.isclose(loss, ref["loss"], rtol=1e-4, atol=0.0):
        raise AssertionError(f"2-D mesh loss {loss} vs {ref['loss']}")
    worst = 0.0
    for (name, g), want in zip(_named_leaves(lg.grads), ref["grads"]):
        worst = max(worst, _close(lines, f"2-D mesh grad {name}", g, want,
                                  **SHARD_GRAD))
    den = _close(lines, "2-D mesh denom", new[3].denom, ref["denom"], 0.0,
                 1e-5)
    _replicas(new, "2-D mesh")
    _rank_log(lines, f"  2-D mesh: loss {loss:.6f} (mean of singles "
                     f"{ref['loss']:.6f}), gradients max |diff| {worst:.3e} "
                     f"against the singles' mean, denom sum {den:.1e}; "
                     f"launches {launches}; the 4 ranks' updates bitwise "
                     "equal")
    return dict(rank=mesh.rank, lines=lines, launches=launches)


def multi_trainer_rank(argv: list) -> dict:
    """A rank of cli.train --devices 2 under this launcher (its ranks join
    the group from WORLD_SIZE, as under torchrun): every step's loss, the
    densify, reset, refresh and growth events, the replica checks; rank 0
    also renders test frame 0 in memory at full SH degree."""
    import torch
    from adgs_tpu_torch.cli import render as cli_render
    from adgs_tpu_torch.cli import train as cli_train
    from adgs_tpu_torch.parallel import shard
    from adgs_tpu_torch.render import make_staged_render_fn
    from adgs_tpu_torch.train import densify as densify_lib
    from adgs_tpu_torch.train import trainer as trainer_mod

    ev = dict(densify=0, reset=0, refresh=0, exchange=[], instance=[],
              losses=[], step_s=[])
    real_make = shard.make_sharded_train_step

    def make_step(*a, **k):
        step = real_make(*a, **k)

        def counted(*sa, **sk):
            t0 = time.perf_counter()
            res = step(*sa, **sk)
            ev["losses"].append(float(res[4]["total_loss"]))
            ev["step_s"].append(time.perf_counter() - t0)
            return res
        return counted

    def counting(name, fn):
        def wrapped(*a, **k):
            ev[name] += 1
            return fn(*a, **k)
        return wrapped

    T = trainer_mod.Trainer
    real_ex, real_inst = T._grow_exchange_capacity, \
        T._maybe_grow_instance_capacity
    real_refresh = T.refresh_near_idx

    def grow_ex(self):
        before = self.exchange_capacity
        real_ex(self)
        ev["exchange"].append((self.iteration, before,
                               self.exchange_capacity))

    def grow_inst(self, nr):
        before = self.capacity
        real_inst(self, nr)
        if self.capacity != before:
            ev["instance"].append((self.iteration, before, self.capacity))

    def refresh(self):
        ev["refresh"] += 1
        real_refresh(self)

    class QuietLogger(trainer_mod.MetricsLogger):
        # TensorBoard's PNG panels cost ~10 s an evaluation at 1242x375
        def __init__(self, model_path):
            super().__init__(model_path, use_tensorboard=False)

    shard.make_sharded_train_step = make_step
    densify_lib.densify_and_prune = counting(
        "densify", densify_lib.densify_and_prune)
    densify_lib.reset_opacity = counting("reset", densify_lib.reset_opacity)
    T._grow_exchange_capacity = grow_ex
    T._maybe_grow_instance_capacity = grow_inst
    T.refresh_near_idx = refresh
    trainer_mod.MetricsLogger = QuietLogger
    t0 = time.perf_counter()
    tr = cli_train.main(argv)
    seconds = time.perf_counter() - t0
    out = dict(ev, rank=tr.mesh.rank, main=tr.is_main,
               logger=type(tr.logger).__name__,
               replica_checks=tr.replica_checks, iteration=tr.iteration,
               seconds=seconds, step_ms=1e3 * float(np.median(
                   ev["step_s"][1:] or ev["step_s"])),
               alive=int(tr.state.num_scene) + int(tr.state.num_obj),
               capacity=tr.capacity, render_capacity=tr.render_capacity)
    if tr.device.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(tr.device) / 1e9
    if tr.is_main:
        cfg = tr.config
        fn = make_staged_render_fn(cfg, active_sh_degree=cfg.sh_degree,
                                   inv_depth=tr.inv_depth,
                                   capacity=tr.render_capacity,
                                   layout=tr.layout)
        cam, _, _ = tr._get_frame("test", 0)
        rays = tr._rays_for(cam, tr.scene.test_frames[0].cam_id)
        img = fn(cam, tr.params, tr.state, tr.env, rays)
        out["render"] = cli_render._to_uint8(torch.clamp(img["render"], 0,
                                                         1))
        out["num_rendered"] = int(img["num_rendered"])
    return out


def _print_rank_logs(workdir, world):
    import os
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.log")
        if os.path.exists(path):
            for line in open(path).read().splitlines():
                if line.startswith(("rank ", "  ")):
                    log(f"#   [rank {r}] {line.strip()}")


def multi_phase(seed, dev, card, cfg, params, env, rays, cams, batch,
                train_state, capacity) -> dict:
    """Phase 15 (see the module docstring). Returns a summary with the
    D = 2 step's launches on rank 0."""
    import gc
    import os
    import tempfile
    import torch
    from PIL import Image
    from adgs_tpu_torch.cli import render as cli_render
    from adgs_tpu_torch.parallel.launch import call_ranks
    from adgs_tpu_torch.train.optim import TrainableState, init_adam

    t_phase = time.perf_counter()
    shared = f"{card}; ranks sharing one card over gloo, not a scaling figure"
    summary = {}
    here = os.path.dirname(os.path.abspath(__file__))
    device = "cuda" if dev.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory(prefix="adgs_multi_") as tmp:
        # the full-width step model of phases 3-8, and its single-device
        # references on two cameras
        t0 = time.perf_counter()
        step = make_step(cfg, capacity)
        start = (params, env, init_adam(TrainableState(params, env)),
                 train_state)
        two = [cams[0].at_time(TRAIN_TIME), cams[1].at_time(MULTI_TIME_B)]
        refs = single_refs(step, start, two, batch, rays, grads="first")
        path = os.path.join(tmp, "step.pt")
        torch.save(dict(scene=_to(dict(
            params=params, env=env, state=train_state, batch=batch,
            rays=rays, cams=two, capacity=capacity), "cpu"), refs=refs),
            path)
        del refs, start, step
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        summary["reference s"] = time.perf_counter() - t0
        log(f"# multi-device ({shared}): the references and the scene "
            f"file in {summary['reference s']:.1f} s")

        t0 = time.perf_counter()
        wd = os.path.join(tmp, "step")
        res = call_ranks("chip_smoke:multi_step_rank", MULTI_D,
                         dict(path=path, backend="gloo", device=device),
                         timeout=MULTI_TIMEOUT, workdir=wd)
        summary["tile and batch s"] = time.perf_counter() - t0
        _print_rank_logs(wd, MULTI_D)
        summary["launches"] = res[0]["launches_exchange"]
        summary["ms_per_step"] = [r["ms_per_step"] for r in res]
        summary["collective_ms"] = [r["collective_ms"] for r in res]
        summary["peak_gb"] = [r.get("peak_gb") for r in res]
        if len({r["loss_timed"] for r in res}) != 1:
            raise AssertionError("the ranks' timed losses differ")
        log(f"# multi-device ({shared}): tile D = {MULTI_D} slab step at "
            f"{WIDTH}x{HEIGHT}, {params.capacity} Gaussian slots, the 3x"
            f"{ENV_RES}^2 sky: ms/step "
            f"per rank {[round(x, 3) for x in summary['ms_per_step']]}, "
            "of which in the collectives (host ms, synchronized) "
            f"{[round(sum(c.values()), 3) for c in summary['collective_ms']]}"
            f", peak GB per rank {summary['peak_gb']}; spawn, checks and "
            f"times {summary['tile and batch s']:.1f} s")

        if torch.cuda.device_count() >= 2 and device == "cuda":
            t0 = time.perf_counter()
            wd = os.path.join(tmp, "nccl")
            call_ranks("chip_smoke:multi_step_rank", MULTI_D,
                       dict(path=path, backend="nccl", device=device,
                            cases="tile"), timeout=MULTI_TIMEOUT, workdir=wd)
            _print_rank_logs(wd, MULTI_D)
            log(f"# multi-device: the D = {MULTI_D} step over NCCL on two "
                f"cards held to the reference in "
                f"{time.perf_counter() - t0:.1f} s")
        else:
            log(f"# multi-device: the NCCL path was not run "
                f"({torch.cuda.device_count()} card)")
        os.remove(path)

        # the 2-D mesh at the gate's shapes, four ranks
        t0 = time.perf_counter()
        m = MULTI_MESH
        mcfg, mp, mstate, menv, mrays, mcams = build_scene(
            dev, seed + 5, m["n"], m["width"], m["height"], m["env_res"])
        mbatch, mstate = train_inputs(dev, seed + 5, mp, mstate, m["width"],
                                      m["height"])
        mtwo = [mcams[0].at_time(TRAIN_TIME), mcams[1].at_time(MULTI_TIME_B)]
        mcap, _nr = size_capacity(mcfg, mp, mstate, mtwo)
        mstep = make_step(mcfg, mcap)
        mrefs = single_refs(mstep, (mp, menv, init_adam(TrainableState(
            mp, menv)), mstate), mtwo, mbatch, mrays, grads="mean")
        path = os.path.join(tmp, "mesh.pt")
        torch.save(dict(scene=_to(dict(
            params=mp, env=menv, state=mstate, batch=mbatch, rays=mrays,
            cams=mtwo, capacity=mcap), "cpu"), refs=mrefs), path)
        del mrefs, mstep, mp, menv, mstate, mbatch
        wd = os.path.join(tmp, "mesh")
        mres = call_ranks("chip_smoke:multi_mesh_rank", 4,
                          dict(path=path, backend="gloo", device=device),
                          timeout=MULTI_TIMEOUT, workdir=wd)
        _print_rank_logs(wd, 4)
        summary["mesh s"] = time.perf_counter() - t0
        log(f"# multi-device ({shared}): 2-D mesh {{data: 2, tile: 2}} at "
            f"{m['width']}x{m['height']}, {m['n']} Gaussians, 3x"
            f"{m['env_res']}^2 sky: held to the singles in "
            f"{summary['mesh s']:.1f} s; rank 0 launches "
            f"{mres[0]['launches']}")

        # the trainer: cli.train --devices 2 on a KITTI-format scene
        t0 = time.perf_counter()
        scene = os.path.join(tmp, "scene")
        model = os.path.join(tmp, "model")
        pts, obj = train_scene_points(seed, cams, *MULTI_TRAIN_POINTS)
        write_cli_scene(scene, seed, camera_poses(), WIDTH, HEIGHT, pts, obj)
        del pts, obj
        n = str(MULTI_TRAIN_ITERS)
        argv = (["-s", scene, "-m", model, "--seed", str(seed), "--device",
                 device, "-c", os.path.join(here, "configs/kitti-75.py"),
                 "--sh_degree", "3", "--env_resolution",
                 str(MULTI_TRAIN_ENV), "--iterations", n,
                 "--densification_interval", "5", "--densify_from_iter", "0",
                 "--opacity_reset_interval", "10",
                 "--near_idx_reset_interval", "5", "--test_iterations", n,
                 "--save_iterations", n, "--devices", str(MULTI_D),
                 "--capacity", str(MULTI_TRAIN_CAPACITY),
                 "--exchange_capacity", str(MULTI_TRAIN_EXCHANGE)]
                + TRAIN_GRAD_ARGS)
        log("# multi-device trainer: cli.train " + " ".join(argv[8:]))
        wd = os.path.join(tmp, "train")
        tres = call_ranks("chip_smoke:multi_trainer_rank", MULTI_D,
                          dict(argv=argv), timeout=MULTI_TIMEOUT,
                          workdir=wd)
        summary["trainer s"] = time.perf_counter() - t0
        r0 = tres[0]
        for r in tres:
            if (len(r["losses"]) != MULTI_TRAIN_ITERS
                    or not np.isfinite(r["losses"]).all()):
                raise AssertionError(f"rank {r['rank']} losses {r['losses']}")
            if r["losses"] != r0["losses"]:
                raise AssertionError("the ranks' losses differ")
            if not (r["densify"] and r["reset"] and r["refresh"]
                    and r["exchange"] and r["instance"]):
                raise AssertionError(f"rank {r['rank']}: an event did not "
                                     f"fire: {json.dumps({k: r[k] for k in ('densify', 'reset', 'refresh', 'exchange', 'instance')})}")
            if r["replica_checks"] != r["densify"]:
                raise AssertionError("a densify went without its replica "
                                     "check")
        if [r["main"] for r in tres] != [True] + [False] * (MULTI_D - 1) or \
                tres[1]["logger"] != "_NoLogger":
            raise AssertionError("a rank other than 0 had a file logger")
        recs = [json.loads(ln) for ln in open(os.path.join(
            model, "metrics.jsonl"))]
        steps = [x["step"] for x in recs if "total_loss" in x]
        if steps != list(range(10, MULTI_TRAIN_ITERS + 1, 10)):
            raise AssertionError(f"metrics.jsonl's training lines {steps}: "
                                 "not rank 0's alone")
        its = sorted(os.listdir(os.path.join(model, "point_cloud")))
        snaps = [f for f in os.listdir(model) if f.startswith("snapshot")]
        if its != [f"iteration_{MULTI_TRAIN_ITERS}"] or snaps:
            raise AssertionError(f"checkpoints {its}, snapshots {snaps}")
        cli_render.main(["-m", model, "--skip_train", "--device", device])
        png = np.asarray(Image.open(os.path.join(
            model, "test", f"ours_{MULTI_TRAIN_ITERS}", "renders",
            "00000.png")))
        diff = np.abs(png.astype(np.int32) - r0["render"].astype(np.int32))
        if png.shape != r0["render"].shape or diff.max() > 1:
            raise AssertionError("cli.render of rank 0's checkpoint differs "
                                 "from its in-memory render by more than "
                                 "1/255")
        summary["trainer"] = {k: r0[k] for k in (
            "densify", "reset", "refresh", "exchange", "instance",
            "replica_checks", "alive", "capacity", "render_capacity",
            "seconds", "step_ms")}
        summary["trainer"]["losses"] = [round(x, 6) for x in r0["losses"]]
        summary["trainer"]["peak_gb"] = [r.get("peak_gb") for r in tres]
        log(f"# multi-device trainer ({shared}): " + json.dumps(
            summary["trainer"]))
        log(f"# multi-device trainer: every loss finite and equal on both "
            f"ranks, {r0['replica_checks']} densifies each followed by a "
            "bitwise replica check, files by rank 0 alone, test frame 0 by "
            f"cli.render within {int(diff.max())}/255 of rank 0's memory; "
            f"{summary['trainer s']:.1f} s")
    summary["phase s"] = time.perf_counter() - t_phase
    log(f"# multi-device phase: {summary['phase s']:.1f} s")
    return summary


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
    from adgs_tpu_torch import _kernels
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
    for name in ("preprocess", "deform"):
        if serve_launches[name] != len(reqs):
            raise AssertionError(f"{KERNELS[name]['id']}: "
                                 f"{serve_launches[name]} launches in "
                                 f"{len(reqs)} requests")
    for i, out in enumerate(outs):
        if int(out["num_rendered"]) > capacity:
            raise AssertionError(f"frame {i}: instance overflow "
                                 f"({int(out['num_rendered'])} > {capacity})")
    check_outputs(outs, reqs, WIDTH, HEIGHT)
    with _kernels.plain():
        plain = make_staged_render_fn(cfg, capacity=capacity)(
            reqs[0], params, state, env, rays)
    for k in ("render", "foreground", "background", "depth", "img_opacity"):
        check_close(f"frame 0 {k} vs the plain render", outs[0][k],
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
    for name in ("adam", "preprocess", "preprocess_bwd", "deform",
                 "deform_bwd"):
        if launches[name] != len(logs):
            raise AssertionError(f"{KERNELS[name]['id']}: {launches[name]} "
                                 f"launches in {len(logs)} training steps")
    check_train_logs(logs, capacity)
    log("# losses per step: " + json.dumps(
        [round(float(lg["total_loss"]), 6) for lg in logs]) + "; last "
        + json.dumps({k: round(float(v), 6) for k, v in logs[-1].items()}))
    first = check_plain_step(step, start, train_cam, batch, rays)
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
    rec.update(segment_sum_cases(dev, seed))
    # 11b. Adam (A1) on a step's gradients and at the train cells' shapes
    lg = step.loss_and_grads(params, env, train_state, train_cam, batch, rays)
    rec["adam"] = adam_phase(dev, seed, real=(TrainableState(params, env),
                                              lg.grads, start[2]))
    del lg
    # 11c. P1 and P2 at the train cells' slot count
    rec.update(preprocess_phase(dev, seed))
    # 11d. T1 and T2 at the train cells' slot count
    rec.update(deform_phase(dev, seed))

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
    # one entry per record: B5 one for each set of rows it sums (the
    # step's two, the train cells' four patterns);
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

    # 15. multi-device: ranks over torch.distributed
    multi = multi_phase(seed, dev, card, cfg, params, env, rays, cams, batch,
                        train_state, capacity)
    for entry in kernels:
        entry["multi_launches"] = multi["launches"].get(entry["name"], 0)
    log("# multi_launches (the D = 2 slab step, rank 0): " + json.dumps(
        {k: v for k, v in multi["launches"].items() if v}))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
