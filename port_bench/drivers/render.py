"""Serving traffic: one client in a closed loop, frames back to back
through `make_staged_render_fn`, each complete when its RGB image is on
the host (as `cli.render` needs it before writing a PNG).

The cameras: the scene's images in reader order, then `interp_frames`
frames of `cli.render --mode time` (one training camera, drawn as it
draws it, at times i / interp_frames), round and round. The model is the
benchmark's, at the configuration's SH degree, with the instance
capacity sized over those cameras as the trainer's guard sizes it.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import scene
from ..harness import sync, window_halves_ms
from ..reference import render_ref


def traffic_views(spec: dict, traffic: dict, seed: int) -> list:
    """[View] of one round of the loop: the scene's images and the time
    frames of the middle training camera, in an order drawn from the seed
    (every seed serves the same frames)."""
    vs = scene.views(spec)
    train = [v for v in vs if not v.is_test]
    fixed = train[len(train) // 2]
    n = int(traffic["interp_frames"])
    frames = vs + [fixed._replace(time=i / n) for i in range(n)]
    order = np.random.default_rng(int(seed) + 3).permutation(len(frames))
    return [frames[i] for i in order]


def sample(traffic: dict, seed: int) -> list:
    """The frames whose images are compared: drawn from the seed among the
    first `sample_within`, which every window completes."""
    rng = np.random.default_rng(int(seed) + 2)
    return sorted(int(i) for i in rng.choice(int(traffic["sample_within"]),
                                             int(traffic["sample_frames"]),
                                             replace=False))


def run(run):
    from adgs_tpu_torch.core.camera import Camera
    from adgs_tpu_torch._stages import stage_ms
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
    views = traffic_views(spec, traffic, run.seed)
    cams = [Camera.create(R=v.R, T=v.T, fovx=v.fovx, fovy=v.fovy,
                          width=v.width, height=v.height, time=v.time,
                          device=dev) for v in views]
    # each camera's sky rays, as cli.render keys them by cam_id
    rays = {}
    by_cam = {}
    for v, c in zip(views, cams):
        if v.cam_id not in rays:
            rays[v.cam_id] = torch.as_tensor(
                camera_rays(c.focal_x, c.height, c.width),
                dtype=torch.float32, device=dev)
        nr = int(compute_binning(c, params, state, cfg, capacity=1 << 10)
                 .num_rendered)
        by_cam[v.cam_id] = max(by_cam.get(v.cam_id, 0), nr)
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

    # each image goes to one of two page-locked host buffers, in turns (a
    # fresh pageable tensor a frame would time the host's page faults;
    # two, so that the last frame of the window is still there after the
    # frame that closes it)
    hosts = [torch.empty((3, cams[0].height, cams[0].width),
                         pin_memory=dev.type == "cuda") for _ in range(2)]

    def frame(i, marks=None):
        k = i % len(cams)
        out = fn(cams[k], params, state, env, rays[views[k].cam_id],
                 stage_marks=marks)
        host = hosts[i % 2]
        host.copy_(torch.clamp(out["render"], 0.0, 1.0))
        return host

    # the memory peak: from the warm-up to the window's close
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(int(traffic["warmup_frames"])):
        frame(i)
    sync(dev)
    run.phase("warm-up")
    kept, lat, ends, marks_ms = {}, [], [], []
    t_win = time.perf_counter()
    run.setup_s = t_win - run.t_start
    i = 0
    while True:
        marks = [] if run.trace and dev.type == "cuda" else None
        t0 = time.perf_counter()
        img = frame(i, marks)
        t1 = time.perf_counter()
        if t1 - t_win > run.seconds:
            break
        lat.append(t1 - t0)
        ends.append(t1)
        if marks is not None:
            marks_ms.append(stage_ms(marks))
        if i in keep:
            kept[i] = img.clone()
        i += 1
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if ends:
        kept[len(ends) - 1] = hosts[(len(ends) - 1) % 2].clone()
    prof_out = None
    if run.trace:
        # after the window: trace the next frames, counting the kernels'
        # launches, then render them again unprofiled, keeping the
        # kernels' inputs for their bounds
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
        record_trace(run, prof_out or {}, recorder, state)
        recorder.uninstall()
    del fn, params, state, env, zeros, rays, cams
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    compare(run, views, kept, n, keep)
    run.data["reference_s"] = time.perf_counter() - t_ref


def record_trace(run, out, recorder, state):
    from .. import bounds, roofline
    run.data["trace"] = out
    if out.get("window_s"):
        run.busy_s, run.window_s = out["busy_s"], out["window_s"]
        run.breakdown = dict(device_ops=out["device_ops"],
                             idle_gaps=out["idle_gaps"])
    if not recorder.launches:
        return
    sky = [r for r in recorder.launches if r["id"] == "B7"]
    cells = bounds.sky_cells(sky[0]["grid_shape"], sky[0]["coords"]) \
        if sky else 0
    kb = bounds.launch_bounds(recorder.launches)
    recorder.launches.clear()
    run.data["kernel_bound_s"] = {k: v for k, v in kb.items()
                                  if k != "pairs"}
    run.data["kernel_launches"] = dict(recorder.counts)
    pairs = kb["pairs"]
    if pairs:
        sz = scene.sizes(run.spec, int(run.traffic["capacity_factor"]))
        h, w = int(run.spec["height"]), int(run.spec["width"])
        hit, gated, culled, ch = (sum(p[i] for p in pairs) / len(pairs)
                                  for i in range(4))
        nb, fl = roofline.render_frame_bound(
            int(state.num_scene), int(state.num_obj), sz.sh_k, sz.c_shs,
            sz.c_xyz, sz.c_rot, sz.c_bg, h * w, cells, hit, gated, culled,
            ch, 3)
        run.data["frame_bound_s"] = roofline.bound_s(nb, fl)


def compare(run, views, kept, n, keep):
    """The sampled frames and the last against the plain reference's
    renders of the same cameras (judge.render); a sampled frame that never
    came fails."""
    from .. import judge
    frames = sorted(i for i in kept if i < n)
    ref = render_ref.render(run.spec, run.traffic, run.seed, run.device,
                            [views[i % len(views)] for i in frames])
    got = judge.render([kept[i] for i in frames], ref)
    if any(i >= n for i in keep):
        got = {k: float("inf") for k in got}
    for name, value in got.items():
        run.check(name, value, run.cell["limits"][name])
    run.data["compared_frames"] = len(frames)
