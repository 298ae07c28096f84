#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (adgs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero before the last line is printed):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles every kernel of csrc/ (one nvcc per source, in
     parallel) and prints the build seconds and ptxas resource use;
  3. scene: the KITTI-75 model at full width (~1M Gaussians, 30% object
     Gaussians, log-scales shrunk by log(0.3)), a 1242x375 frame and a
     3x8192x8192 sky grid, all made from --seed;
  4. kernel parity at the slice's shapes, each kernel against its plain
     PyTorch twin on the same inputs: B2 live compaction and B1 expansion
     bitwise, B3 compositing 1e-4 at ch=4 and ch=8, B7 sky sample 1e-6;
  5. the serving path: 8 requests through make_staged_render_fn
     (two camera poses, times spread over [0, 1]) with the launch counts
     reset just before; every output finite, no overflow, every kernel
     launched; one frame held to the "torch" backend at 1e-4;
  6. times with CUDA events: ms per frame and ms per stage, both read from
     events recorded inside the served requests themselves, a
     torch.profiler view of one request (top device ops, device busy
     share), and one JSON line ({"kernels": [...]}) with each kernel's
     time, its plain twin's, its bound and, for B7, torch's own
     grid_sample.
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
FRAMES = 8                # requests served on the main path
CAP_HEADROOM = 0.92       # instance capacity = num_rendered / 0.92
HBM_BYTES_S = 3.35e12     # H100 SXM memory rate
FP32_FLOP_S = 67e12       # H100 SXM f32 rate outside the tensor cores
# camera +z -> world +x: a horizon-looking pose (the sky on the equator)
HORIZON = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)

KERNELS = {
    "compact_live": dict(id="B2", source="adgs_tpu_torch/csrc/compact.cu",
                         replaces="adgs_tpu/raster/pallas/expand.py:309"),
    "expand": dict(id="B1", source="adgs_tpu_torch/csrc/expand.cu",
                   replaces="adgs_tpu/raster/pallas/expand.py:81"),
    "composite_fwd": dict(id="B3", source="adgs_tpu_torch/csrc/composite.cu",
                          replaces="adgs_tpu/raster/pallas/render.py:555"),
    "grid_sample": dict(id="B7", source="adgs_tpu_torch/csrc/grid_sample.cu",
                        replaces="adgs_tpu/ops/grid_sample.py:192"),
}


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


def yaw(rad: float) -> np.ndarray:
    c, s = math.cos(rad), math.sin(rad)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def build_scene(device, seed: int, n: int, width: int, height: int,
                env_res: int):
    """The KITTI-75 model from a numpy seed: (config, params, state, env,
    rays, cameras). Points lie 6-14 units ahead of the camera (world +x)."""
    import dataclasses
    import torch
    from scipy.spatial import cKDTree
    from adgs_tpu_torch.core.camera import Camera
    from adgs_tpu_torch.models import gaussians as gm
    from adgs_tpu_torch.models.env_map import EnvironmentMap, camera_rays

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 4.0
    pts[:, 0] = rng.uniform(-2.0, 6.0, size=n)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    obj_id = (rng.random(n) < 0.3).astype(np.float32)
    times = rng.uniform(size=n).astype(np.float32)
    dist, _ = cKDTree(pts).query(pts, k=4, workers=-1)
    d2 = np.mean(dist[:, 1:] ** 2, axis=1).astype(np.float32)

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
    poses = [(HORIZON, np.array([0.0, 0.0, 8.0])),
             (HORIZON @ yaw(0.15), np.array([0.5, -0.3, 8.0]))]
    cams = [Camera.create(R=R, T=T, fovx=fovx, fovy=fovy, width=width,
                          height=height, device=device) for R, T in poses]
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


def kernel_phase(cfg, params, state, env, rays, cam, capacity):
    """Each kernel against its plain twin at the slice's shapes; returns
    per-kernel records (error, times, bound)."""
    import torch
    import torch.nn.functional as F
    from adgs_tpu_torch.models.gaussians import deformed_xyz, obj_mask
    from adgs_tpu_torch.raster import binning as bl
    from adgs_tpu_torch.raster import render as rl
    from adgs_tpu_torch.raster.composite import depth_feature
    from adgs_tpu_torch.models.env_map import direction_to_angles
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
        ms=cuda_ms(lambda: bl.compact_live(*cargs), iters=20),
        plain_ms=cuda_ms(lambda: bl.compact_live_torch(*cargs), iters=5),
        bytes=n * 28 + n * 32, flops=0, library_ms=None)

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
    R = key_k.numel()
    rec["expand"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: bl.expand(*args), iters=20),
        plain_ms=cuda_ms(lambda: bl.expand_torch(*args), iters=5),
        bytes=k * 32 + R * 12, flops=0, library_ms=None)

    # B3: compositing, ch=4 (serving) and ch=8 (+flow +semantic)
    opac = torch.where(prep.visible, prep.opacity,
                       torch.zeros_like(prep.opacity))
    log_op = torch.log(torch.clamp(opac, min=rl.OP_FLOOR))
    feats4 = torch.cat([prep.rgb, depth_feature(prep.depth, True)[:, None]], -1)
    flow = deformed_xyz(params, cfg, cam.time + 0.01)
    feats8 = torch.cat([feats4, flow, obj_mask(params).float()[:, None]], -1)
    err = 0.0
    for ch, feats in ((8, feats8), (4, feats4)):
        packed, _ = rl.pack_gaussian_rows(prep.mean2d, prep.conic, log_op,
                                          feats)
        cargs = (packed, ch, binning.gauss_id, binning.tile_start,
                 binning.tile_count, st.grid_x)
        bk, tk = rl.composite_fwd(*cargs)
        bp, tp, pairs = rl.composite_fwd_torch(*cargs, count_pairs=True)
        err = max(err, check_close(f"B3 composite ch={ch} blended", bk, bp,
                                   1e-4, 1e-4),
                  check_close(f"B3 composite ch={ch} final_t", tk, tp,
                              1e-4, 1e-4))
    # times at the serving width (ch=4, the last packed above)
    T = binning.tile_start.shape[0]
    rec["composite_fwd"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rl.composite_fwd(*cargs), iters=20),
        plain_ms=cuda_ms(lambda: rl.composite_fwd_torch(*cargs), iters=2),
        bytes=packed.numel() * 4 + R * 4 + T * 8 + T * 5 * 256 * 4,
        flops=int(pairs) * (16 + 2 * 4), library_ms=None,
        pairs=int(pairs))

    # B7: sky sample on the full grid at the frame's coords, 1e-6
    world = rays @ cam.world_view[:3, :3].T
    world = world / torch.linalg.vector_norm(world, dim=-1, keepdim=True)
    ang = direction_to_angles(world)
    coords = (ang * ang.new_tensor([1.0 / math.pi, 2.0 / math.pi])).contiguous()
    grid = env.grid
    sk = gs.grid_sample(grid, coords)
    sp = gs.grid_sample_torch(grid, coords)
    err = check_close("B7 grid_sample", sk, sp, 1e-6)
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
        ms=cuda_ms(lambda: gs.grid_sample(grid, coords), iters=50),
        plain_ms=cuda_ms(lambda: gs.grid_sample_torch(grid, coords), iters=10),
        library_ms=cuda_ms(lambda: F.grid_sample(
            grid[None], coords[None], align_corners=True,
            padding_mode="zeros"), iters=50),
        bytes=npix * 8 + C * npix * 4 + cells.numel() * C * 4,
        flops=npix * (12 + 8 * C), distinct_cells=int(cells.numel()))
    return rec


def serve_phase(cfg, params, state, env, rays, reqs, capacity):
    """The main path: every request through make_staged_render_fn, with
    CUDA-event stage marks recorded inside each request. Returns the
    outputs, each request's marks (adgs_tpu_torch._stages) and the launch
    counts."""
    import torch
    from adgs_tpu_torch import _kernels
    from adgs_tpu_torch.render import make_staged_render_fn

    fn = make_staged_render_fn(cfg, capacity=capacity)
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


def profile_request(fn, args, top: int = 12) -> None:
    """torch.profiler over one request: the kernels with the most device
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
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    # device-side events only (kernels, copies): the CPU ops that launched
    # them carry the same time again
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and getattr(e, attr) > 0]
    if not kernels:
        log("# profile: the profiler recorded no device time")
        return
    busy_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    log(f"# profile of one request: wall {wall_ms:.3f} ms under the "
        f"profiler, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}"
        f"%), {n_kernels} device kernels")
    for e in sorted(kernels, key=lambda e: -getattr(e, attr))[:top]:
        log(f"#   {getattr(e, attr) / 1e3:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:100]}")


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
    from adgs_tpu_torch._stages import stage_ms
    from adgs_tpu_torch.render import compute_binning, make_staged_render_fn

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
    log(f"# build: {len(_kernels.SOURCES)} kernels in {build_s:.1f} s")
    for name in _kernels.SOURCES:
        for line in _kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {name}: {line.strip()}")

    # 3. scene
    t0 = time.perf_counter()
    cfg, params, state, env, rays, cams = build_scene(
        dev, args.seed, N_GAUSS, WIDTH, HEIGHT, ENV_RES)
    reqs = requests(cams, FRAMES)
    capacity, nr = size_capacity(cfg, params, state, reqs)
    n_alive = int(state.alive.sum())
    log(f"# scene: {params.capacity} slots ({n_alive} alive, "
        f"{int(state.obj_alive.sum())} object), frame {WIDTH}x{HEIGHT}, "
        f"sky {tuple(env.grid.shape)}, max num_rendered {nr}, capacity "
        f"{capacity}, built in {time.perf_counter() - t0:.1f} s")

    # 4. kernel parity at the slice's shapes
    log("# kernel parity")
    rec = kernel_phase(cfg, params, state, env, rays, reqs[0], capacity)

    # 5. the serving path
    torch.cuda.reset_peak_memory_stats()
    outs, marks, launches = serve_phase(cfg, params, state, env, rays, reqs,
                                        capacity)
    log(f"# served {len(outs)} frames; launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    for i, cam in enumerate(reqs):
        # overflow is read from a fresh binning of the same request
        b = compute_binning(cam, params, state, cfg, capacity=capacity)
        if bool(b.overflow):
            raise AssertionError(f"frame {i}: instance overflow "
                                 f"({int(b.num_rendered)} > {capacity})")
    check_outputs(outs, reqs, WIDTH, HEIGHT)
    plain = make_staged_render_fn(cfg, capacity=capacity, backend="torch")(
        reqs[0], params, state, env, rays)
    for k in ("render", "foreground", "background", "depth", "img_opacity"):
        check_close(f"frame 0 {k} vs the torch backend", outs[0][k],
                    plain[k], 1e-4, 1e-4)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # 6. times
    frame_ms = [m[0][1].elapsed_time(m[-1][1]) for m in marks]
    span_ms = marks[0][0][1].elapsed_time(marks[-1][-1][1])
    log(f"# ms per frame (CUDA events from each request's first mark to its "
        f"last, requests enqueued back to back): median "
        f"{float(np.median(frame_ms)):.3f}, all "
        f"{[round(x, 3) for x in frame_ms]}; {len(marks)} requests in "
        f"{span_ms:.3f} ms ({span_ms / len(marks):.3f} ms each); peak "
        f"device memory {peak_gb:.2f} GB")
    stages = [stage_ms(m) for m in marks]
    mean_stage = {k: float(np.mean([s[k] for s in stages]))
                  for k in stages[0]}
    log("# ms per stage (CUDA events in render(), mean over requests): "
        + json.dumps({k: round(v, 4) for k, v in mean_stage.items()}))
    profile_request(make_staged_render_fn(cfg, capacity=capacity),
                    (reqs[1], params, state, env, rays))
    kernels = []
    for name, meta in KERNELS.items():
        r = rec[name]
        t_bytes = r["bytes"] / HBM_BYTES_S * 1e3
        t_ops = r["flops"] / FP32_FLOP_S * 1e3
        entry = dict(
            name=name, id=meta["id"], route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=r["max_abs_err"], max_abs_diff=r["max_abs_err"],
            ms=r["ms"], kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"])
        kernels.append(entry)
    log(f"# B3 (instance, pixel) pairs evaluated: "
        f"{rec['composite_fwd']['pairs']}; B7 distinct tapped cells: "
        f"{rec['grid_sample']['distinct_cells']}")
    log(f"# card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
