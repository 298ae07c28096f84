"""Serving traffic of a camera rig: `render`'s closed loop (drivers/render.py,
whose functions this driver calls) with a frame equal to one rig. A frame
is every camera of the configuration's `rig_request` at one time, served
by one call of `make_staged_render_fn`'s function, and complete when all
the rig's RGB images are in page-locked host memory.

A round holds each timestamp's rig and `interp_frames` rigs of
`cli.render --mode time`: the middle training timestamp's cameras at
times i / interp_frames, in an order drawn from the seed. The model is
the benchmark's; the instance capacity is sized as `render` sizes it, the
largest over every camera of the round.

The run records `run.data["driver"] = "render"`, so that the render
readers apply unchanged, with a frame meaning a rig:
  - `stage_marks`: one dict a frame, each stage summed over the rig's
    cameras (the marks are renamed per camera first, since `stage_ms`
    keeps one value a name);
  - `frame_bound_s`: the least time of a rig frame's work: each camera's
    `roofline.render_frame_bound` summed, less the copies of the
    parameters' reads and the deformation's operations beyond the first,
    since the rig deforms once;
  - `render_ms_per_frame` and `render_p95_ms` count rig frames.

The compared frames' cameras are each rendered on their own by the plain
reference (reference/render_rig_ref.py) and judged by `judge.render` over
all their images. A traffic may set `window_frames`: the window then
closes after that many frames instead of after `--seconds`.

The control (the reference in TF32 against the reference in float32, on
the compared frames of a seed; on a card):

    python3 -m port_bench.drivers.render_rig --workload <cell> --seeds 1 2
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from collections import Counter

import numpy as np
import torch

from .. import scene
from ..harness import sync, window_halves_ms
from ..reference import render_rig_ref
from .render import sample


def rig_cameras(spec: dict) -> list:
    """The reader-order places of the cameras of `rig_request`, in the
    order it names them."""
    names = [c.get("camera") for c in scene.rig(spec)]
    return [names.index(name) for name in spec["rig_request"]]


def traffic_rigs(spec: dict, traffic: dict, seed: int) -> list:
    """[[View] of one rig] of one round of the loop: each timestamp's
    cameras, and the middle training timestamp's cameras at times
    i / interp_frames, in an order drawn from the seed (every seed serves
    the same rigs)."""
    vs = scene.views(spec)
    n_cam = int(spec["num_cam"])
    places = rig_cameras(spec)
    rigs = [[vs[t + c] for c in places] for t in range(0, len(vs), n_cam)]
    train = [r for r in rigs if not r[0].is_test]
    fixed = train[len(train) // 2]
    n = int(traffic["interp_frames"])
    frames = rigs + [[v._replace(time=i / n) for v in fixed]
                     for i in range(n)]
    order = np.random.default_rng(int(seed) + 3).permutation(len(frames))
    return [frames[i] for i in order]


def rig_stage_ms(marks: list) -> dict:
    """Device ms of each stage of a rig frame, summed over its cameras."""
    from adgs_tpu_torch._stages import stage_ms
    seen: Counter = Counter()
    named = []
    for name, ev in marks:
        named.append((f"{name}.{seen[name]}", ev))
        seen[name] += 1
    out: dict = {}
    for key, ms in stage_ms(named).items():
        stage = key.rsplit(".", 1)[0]
        out[stage] = out.get(stage, 0.0) + ms
    return out


def run(run):
    from adgs_tpu_torch.core.camera import Camera
    from adgs_tpu_torch.models.env_map import EnvironmentMap, camera_rays
    from adgs_tpu_torch.models.gaussians import (GaussianConfig,
                                                 GaussianParams,
                                                 GaussianState)
    from adgs_tpu_torch.render import compute_binning, make_staged_render_fn
    from .. import tracing

    spec, traffic, dev = run.spec, run.traffic, run.device
    run.phase("imports")
    w = scene.make_weights(spec, run.seed, dev,
                           capacity_factor=int(traffic["capacity_factor"]))
    params = GaussianParams(**{name: w[name] for name in scene.LEAVES})
    zeros = torch.zeros(params.capacity, dtype=torch.float32, device=dev)
    state = GaussianState(
        scene_alive=w["scene_alive"], obj_alive=w["obj_alive"],
        gs_time=w["gs_time"], max_radii2d=zeros, xyz_grad_accum=zeros,
        denom=zeros,
        obj_near_idx=torch.zeros((1, 1), dtype=torch.int32, device=dev),
        obj_near_valid=torch.zeros((1,), dtype=torch.bool, device=dev))
    env = EnvironmentMap(grid=w["env"])
    del w
    run.phase("weights")
    cfg = GaussianConfig.from_order_args(
        spec["order_args"], scene.scene_frame_num(spec), 3,
        sh_degree=int(spec["sh_degree"]), use_time_mask=True)
    rigs = traffic_rigs(spec, traffic, run.seed)
    cams = [[Camera.create(R=v.R, T=v.T, fovx=v.fovx, fovy=v.fovy,
                           width=v.width, height=v.height, time=v.time,
                           device=dev) for v in rig] for rig in rigs]
    # each camera's sky rays, keyed by cam_id as cli.render keys them
    rays = {}
    by_cam = {}
    for rig, rig_cams in zip(rigs, cams):
        for v, c in zip(rig, rig_cams):
            if v.cam_id not in rays:
                rays[v.cam_id] = torch.as_tensor(
                    camera_rays(c.focal_x, c.height, c.width),
                    dtype=torch.float32, device=dev)
            nr = int(compute_binning(c, params, state, cfg,
                                     capacity=1 << 10).num_rendered)
            by_cam[v.cam_id] = max(by_cam.get(v.cam_id, 0), nr)
    rig_rays = [[rays[v.cam_id] for v in rig] for rig in rigs]
    nr = max(by_cam.values())
    cap = scene.instance_capacity(nr)
    run.phase("cameras and capacity")
    run.data.update(instance_capacity=cap, max_num_rendered=nr,
                    max_num_rendered_by_camera=[by_cam[c]
                                                for c in sorted(by_cam)])
    fn = make_staged_render_fn(cfg, active_sh_degree=int(spec["sh_degree"]),
                               capacity=cap)
    keep = set(sample(traffic, run.seed))
    recorder = tracing.LaunchRecorder().install() if run.trace else None

    # each rig's images go to one of two page-locked host buffers, in turns
    # (drivers/render.py's reasons)
    n_cam = len(rigs[0])
    hosts = [torch.empty((n_cam, 3, int(spec["height"]), int(spec["width"])),
                         pin_memory=dev.type == "cuda") for _ in range(2)]

    def frame(i, marks=None):
        k = i % len(rigs)
        outs = fn(cams[k], params, state, env, rig_rays[k],
                  stage_marks=marks)
        host = hosts[i % 2]
        for slot, out in zip(host, outs):
            slot.copy_(torch.clamp(out["render"], 0.0, 1.0))
        return host

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(int(traffic["warmup_frames"])):
        frame(i)
    sync(dev)
    run.phase("warm-up")
    limit = traffic.get("window_frames")
    kept, lat, ends, marks_ms = {}, [], [], []
    t_win = time.perf_counter()
    run.setup_s = t_win - run.t_start
    i = 0
    while limit is None or i < int(limit):
        marks = [] if run.trace and dev.type == "cuda" else None
        t0 = time.perf_counter()
        img = frame(i, marks)
        t1 = time.perf_counter()
        if limit is None and t1 - t_win > run.seconds:
            break
        lat.append(t1 - t0)
        ends.append(t1)
        if marks is not None:
            marks_ms.append(rig_stage_ms(marks))
        if i in keep:
            kept[i] = img.clone()
        i += 1
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if ends:
        kept[len(ends) - 1] = hosts[(len(ends) - 1) % 2].clone()
    prof_out = None
    if run.trace:
        tracing.warm_up()
        after = range(i + 1, i + 1 + int(traffic["profile_frames"]))
        recorder.mode = "count"
        with tracing.profiled() as prof_out:
            for j in after:
                frame(j)
        recorder.mode = "keep"
        for j in after:
            frame(j)
        recorder.mode = None
    n = len(ends)
    if n == 0:
        raise RuntimeError("no frame completed inside the window")
    run.attempted, run.failed = n, 0
    run.memory_peak_bytes = peak
    run.e2e["render_ms_per_frame"] = (1e3 * (ends[-1] - t_win) / n, "ms")
    run.e2e["render_p95_ms"] = (1e3 * float(np.percentile(lat, 95)), "ms")
    run.data.update(driver="render", window_frames=n, stage_marks=marks_ms,
                    window_halves_ms=window_halves_ms(t_win, ends))
    if run.trace:
        run.data["window_frame_s"] = list(np.diff([t_win] + ends))
        record_trace(run, prof_out or {}, recorder, state, n_cam)
        recorder.uninstall()
    del fn, params, state, env, zeros, rays, rig_rays, cams
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    compare(run, rigs, kept, n, keep)
    run.data["reference_s"] = time.perf_counter() - t_ref


def record_trace(run, out, recorder, state, n_cam: int):
    """drivers/render.py's record_trace for rig frames: the B3 launches of
    the kept pass come camera after camera, so camera k's pairs are every
    n_cam-th from k, and its sky cells those of the k-th B7 launch."""
    from .. import bounds, roofline
    run.data["trace"] = out
    if out.get("window_s"):
        run.busy_s, run.window_s = out["busy_s"], out["window_s"]
        run.breakdown = dict(device_ops=out["device_ops"],
                             idle_gaps=out["idle_gaps"])
    if not recorder.launches:
        return
    sky = [r for r in recorder.launches if r["id"] == "B7"][:n_cam]
    cells = [bounds.sky_cells(r["grid_shape"], r["coords"]) for r in sky]
    kb = bounds.launch_bounds(recorder.launches)
    recorder.launches.clear()
    run.data["kernel_bound_s"] = {k: v for k, v in kb.items()
                                  if k != "pairs"}
    run.data["kernel_launches"] = dict(recorder.counts)
    pairs = kb["pairs"]
    if len(pairs) < n_cam or len(cells) < n_cam:
        return
    sz = scene.sizes(run.spec, int(run.traffic["capacity_factor"]))
    pixels = int(run.spec["height"]) * int(run.spec["width"])
    ns, no = int(state.num_scene), int(state.num_obj)
    model = (ns, no, sz.sh_k, sz.c_shs, sz.c_xyz, sz.c_rot, sz.c_bg)
    nbytes = flops = 0
    for k in range(n_cam):
        own = pairs[k::n_cam]
        hit, gated, culled, ch = (sum(p[i] for p in own) / len(own)
                                  for i in range(4))
        nb, fl = roofline.render_frame_bound(*model, pixels, cells[k], hit,
                                             gated, culled, ch, 3)
        nbytes += nb
        flops += fl
    nbytes -= (n_cam - 1) * 4 * roofline.trainable_floats(*model, 0)
    flops -= (n_cam - 1) * roofline.deform_ops(*model)
    run.data["frame_bound_s"] = roofline.bound_s(nbytes, flops)


def compare(run, rigs, kept, n, keep):
    """The sampled rig frames and the last against the plain reference's
    renders of each of their cameras (judge.render over all their
    images); a sampled frame that never came fails."""
    from .. import judge
    frames = sorted(i for i in kept if i < n)
    ref = render_rig_ref.render(run.spec, run.traffic, run.seed, run.device,
                                [rigs[i % len(rigs)] for i in frames])
    got = judge.render([img for i in frames for img in kept[i]], ref)
    if any(i >= n for i in keep):
        got = {k: float("inf") for k in got}
    for name, value in got.items():
        run.check(name, value, run.cell["limits"][name])
    run.data["compared_frames"] = len(frames)


def control_numbers(spec: dict, traffic: dict, seed: int, dev) -> dict:
    """The control's numbers for one seed: the reference in TF32 against
    the reference in float32 on the seed's sampled rig frames."""
    from .. import judge
    rigs = traffic_rigs(spec, traffic, seed)
    picked = [rigs[i % len(rigs)] for i in sample(traffic, seed)]
    ref = render_rig_ref.render(spec, traffic, seed, dev, picked)
    low = render_rig_ref.render(spec, traffic, seed, dev, picked, tf32=True)
    return judge.render(low, ref)


def main(argv=None) -> int:
    from .. import harness
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a card", file=sys.stderr)
        return 3
    cell, spec, traffic = harness.cell_files(args.workload)
    limits = cell["limits"]
    for seed in args.seeds:
        got = control_numbers(spec, traffic, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got, "limits": limits,
                          "fails": any(got[k] > limits[k] for k in limits
                                       if k in got)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
