"""Scaling harness: pixels/s of the sharded train step at 1, 2, ..., D
ranks (the port's counterpart of scripts/bench_scaling.py).

    python -m adgs_tpu_torch.scripts.bench_scaling [--devices 1 2 4 8]
        [--n_gauss 200000] [--width 512] [--height 256] [--iters 5]
        [--force_cpu_devices N] [--no-exchange] [--dist_backend gloo]

Each count D runs D local ranks (parallel/launch.py) of the slab-mode
sharded step (parallel/shard.py) on one scene made from a seed: a
warm-up step that sizes the per-slab instance capacity from the largest
slab's num_rendered, then `iters` timed steps. One JSON line a count:
pixels/s, the efficiency against linear scaling from the smallest count,
ms/step, each rank's peak device memory, and `structural`.

On one card per rank this measures scaling. --force_cpu_devices N runs
the counts up to N as gloo CPU ranks, and on the card a count above the
number of cards puts several gloo ranks on one card: both validate the
sharded program's structure, and their numbers are structural, not a
scaling figure (`structural` true in the line).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .._device import resolve_device

ORDER = dict(xyz=[None, 5, 0, 6, 0, 0], rotation=[0, 0, 0, 0, None, 5],
             shs=[0, 0, 0, 6, 0, 0], background=[0, 0, 0, 0, 0, 0])


def build_scene(n_points: int, width: int, height: int, device,
                seed: int = 0, quantum: int = 4096):
    """The JAX harness's scene (__graft_entry__._build_scene): points
    around the view axis, 30% object Gaussians, a camera 8 units back,
    and a 256^2 sky. Returns (config, params, state, camera, env,
    rays)."""
    from ..core.camera import Camera
    from ..models import gaussians as gm
    from ..models.env_map import EnvironmentMap, camera_rays
    from ..ops import knn

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n_points, 3)).astype(np.float32) * 4.0
    pts[:, 2] = rng.uniform(-2.0, 6.0, size=n_points)
    cols = rng.uniform(size=(n_points, 3)).astype(np.float32)
    obj_id = (rng.random(n_points) < 0.3).astype(np.float32)
    times = rng.uniform(size=n_points).astype(np.float32)
    cfg = gm.GaussianConfig.from_order_args(ORDER, frame_num=60,
                                            sh_degree=3)
    params, state = gm.create_from_pcd(
        pts, cols, obj_id, times, cfg, knn.mean_knn_sq_dist(pts),
        capacity_quantum=quantum, device=device)
    params = gm.set_init_time_sigma(params, 1.0 / 60)
    cam = Camera.create(R=np.eye(3), T=np.array([0.0, 0.0, 8.0]), fovx=1.2,
                        fovy=0.9, width=width, height=height, time=0.3,
                        device=device)
    env = EnvironmentMap.create(256, device=device)
    rays = torch.as_tensor(camera_rays(cam.focal_x, height, width),
                           dtype=torch.float32, device=device)
    return cfg, params, state, cam, env, rays


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_bench(n_gauss: int, width: int, height: int, iters: int,
               exchange: bool, device: str, backend: str) -> dict:
    """One rank of one count: the timed steps' seconds and its peak
    memory."""
    import torch.distributed as dist
    from ..parallel.mesh import initialize_multihost, make_mesh
    from ..parallel.shard import make_sharded_train_step
    from ..train.config import OptimizationConfig
    from ..train.losses import FrameBatch
    from ..train.optim import TrainableState, init_adam

    initialize_multihost(backend)
    mesh = make_mesh({"tile": dist.get_world_size()}, device)
    dev = mesh.device
    cfg, params, state, cam, env, rays = build_scene(n_gauss, width, height,
                                                     dev)
    opt = OptimizationConfig(lambda_flow=0.0, lambda_obj=0.0,
                             lambda_reg=0.0, lambda_sigma_reg=0.0)
    z = torch.zeros((height, width), device=dev)
    batch = FrameBatch(image=torch.zeros((3, height, width), device=dev),
                       depth=torch.ones_like(z), sky=z, semantic=z)
    opt_state = init_adam(TrainableState(params, env))

    def make(capacity):
        return make_sharded_train_step(
            cfg, opt, frame_gap=1 / 60, scene_extent=20.0,
            cameras_extent=10.0, mesh=mesh, capacity=capacity,
            primitive_exchange=exchange)

    # the per-SLAB instance capacity, sized from the largest slab's count
    # as the trainer sizes it: a full-scene capacity would make every rank
    # pay the whole frame's integer pipeline at any D
    capacity = 1 << 16
    out = make(capacity)(params, env, opt_state, state, cam, batch, rays,
                         1, active_sh_degree=1)
    nr = int(out[-1]["num_rendered"])
    capacity = max(4096, -(-int(nr / 0.8) // 4096) * 4096)
    step = make(capacity)
    step(params, env, opt_state, state, cam, batch, rays, 1,
         active_sh_degree=1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(params, env, opt_state, state, cam, batch, rays, 1,
                   active_sh_degree=1)
    _sync(dev)
    dist.barrier()
    dt = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    loss = float(out[-1]["total_loss"])
    dist.destroy_process_group()
    return dict(seconds=dt, num_rendered=nr, capacity=capacity,
                peak_gb=peak, loss=loss)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", nargs="+", type=int, default=None)
    p.add_argument("--n_gauss", type=int, default=200_000)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--force_cpu_devices", type=int, default=0)
    p.add_argument("--exchange", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="primitive-exchange routing (per-rank work scales "
                        "~1/D); --no-exchange measures the all-gather "
                        "tier")
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None)
    args = p.parse_args(argv)

    from ..parallel.launch import call_ranks
    cpu = bool(args.force_cpu_devices)
    device = "cpu" if cpu else None
    if not cpu:
        resolve_device(None)          # the card, or a RuntimeError
    available = args.force_cpu_devices if cpu else torch.cuda.device_count()
    counts = args.devices or sorted({1, 2, available})
    kind = ("CPU" if cpu else torch.cuda.get_device_name(0))
    results = {}
    for d in counts:
        if cpu and d > available:
            print(f"# skipping {d} devices (have {available})",
                  file=sys.stderr)
            continue
        shared = cpu or d > available
        backend = args.dist_backend or ("gloo" if shared else "nccl")
        ranks = call_ranks(
            "adgs_tpu_torch.scripts.bench_scaling:rank_bench", d,
            dict(n_gauss=args.n_gauss, width=args.width, height=args.height,
                 iters=args.iters, exchange=args.exchange, device=device,
                 backend=backend), timeout=3600)
        dt = max(r["seconds"] for r in ranks)
        pix_s = args.height * args.width * args.iters / dt
        results[d] = pix_s
        base = min(results)
        eff = pix_s / (results[base] * d / base)
        print(f"# devices {d}: per-slab num_rendered "
              f"{max(r['num_rendered'] for r in ranks)}, capacity "
              f"{ranks[0]['capacity']}, backend {backend}", file=sys.stderr)
        print(json.dumps({
            "devices": d, "pixels_per_sec": pix_s,
            "efficiency_vs_linear": eff,
            "ms_per_step": dt / args.iters * 1e3,
            "peak_gb": [r["peak_gb"] for r in ranks],
            "loss": ranks[0]["loss"], "device": kind,
            "cards": 0 if cpu else available,
            # CPU ranks, or ranks sharing a card: the program's structure,
            # not a scaling figure
            "structural": shared}), flush=True)


if __name__ == "__main__":
    main()
