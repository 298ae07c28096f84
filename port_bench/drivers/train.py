"""Trainer traffic: `Trainer.train` on a scene made from the seed, from
iteration `start_iteration` at the configuration's SH degree, one call
that runs until the window has closed.

Set-up builds one Trainer on the benchmark's SceneData, hands it the
benchmark's model, sky and zeroed Adam moments at the start iteration (as
`Trainer.resume` would from a file) and fills its frame cache with the
training frames in the form `load_frame` returns them (flow packages on
the host, as the reader gives them). The instance capacity is sized as
the overflow guard would grow it over the training cameras, and the
Gaussian blocks are twice their alive counts, as after the first
densify, so that no growth falls in the window.

The benchmark's step wrapper (installed on `Trainer._step_fn` from here,
again after any rebuild) ends each step in a synchronize, which the
trainer's own `float(logs["total_loss"])` does a moment later anyway, and
reads the host clock there. The first `check_steps` steps are recorded
for the reference, the next `warmup_steps` warm up, and the window counts
the steps that end within `--seconds` of the last warm-up step's end.
The memory peak is the allocator's from the start of the `train` call
(its KNN refresh, the checked steps, the warm-up) to the window's close.
After the window (and, in a traced run, after the traced steps) one more
step is checked: the wrapper keeps the program's state before it, and the
reference takes one step from that state.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time

import numpy as np
import torch

from .. import readings, scene
from ..harness import sync, window_halves_ms
from ..reference import train_ref


class WindowClosed(BaseException):
    """Ends the trainer's loop once the window has closed (a BaseException,
    so that the trainer's failure snapshot does not take it for a step
    that raised)."""


def snapshot(params, env, opt_state, state, k: int, it: int) -> dict:
    """The program's state before a step, cloned (the step may update its
    inputs in place), as plain tensors by field name."""
    def fields(obj):
        return {f.name: getattr(obj, f.name).detach().clone()
                for f in dataclasses.fields(obj)}

    def tree(t):
        return dict(fields(t.gaussians), env=t.env.grid.detach().clone())

    return dict(k=k, it=int(it), count=int(opt_state.count),
                params=fields(params), env=env.grid.detach().clone(),
                m=tree(opt_state.m), v=tree(opt_state.v),
                state=fields(state))


class StepProbe:
    def __init__(self, run, traffic: dict):
        self.run = run
        self.dev = run.device
        self.n_check = int(traffic["check_steps"])
        self.n_warm = int(traffic["warmup_steps"])
        self.profile_steps = int(traffic["profile_steps"])
        self.k = 0
        self.capturing = False
        self.p0 = self.s0 = None      # the first stretch's start (host)
        self.losses: list = []
        self.images: list = []        # the checked steps' renders (host)
        self.grad_norms = self.stats = None
        self.first = None             # readings of the first stretch
        self.post = None              # the program's state before the
        self.post_read = None         # step after the window; its readings
        self.window_t0 = None
        self.ends: list = []          # host end time of each window step
        self.starts: list = []        # host start time of each window step
        self.iters: list = []
        self.marks: list = []         # stage ms of each window step (trace)
        self.stage = "set-up"         # then window, profile, keep, post
        self.extra = 0                # steps of the stage after the window
        self.peak = 0
        self.prof_cm = self.prof_out = None
        self.recorder = None

    def wrap(self, inner):
        from adgs_tpu_torch._stages import stage_ms
        from adgs_tpu_torch.train.optim import TrainableState, leaves

        def step(params, env, opt_state, state, cam, batch, rays, it,
                 active_sh_degree=3, stage_marks=None):
            k = self.k
            self.k += 1
            if k == 0:
                # kept on the host, out of the device's memory peak
                self.p0 = [x.detach().cpu() for x in
                           leaves(TrainableState(params, env))]
                self.s0 = {n: t.detach().cpu() for n, t in
                           readings.stat_tensors(state).items()}
            post = self.stage == "post"
            if post:
                self.post = snapshot(params, env, opt_state, state, k, it)
            self.capturing = k < self.n_check or post
            w = self.stage == "window"
            marks = ([] if w and self.run.trace and self.dev.type == "cuda"
                     else None)
            t0 = time.perf_counter()
            out = inner(params, env, opt_state, state, cam, batch, rays, it,
                        active_sh_degree=active_sh_degree,
                        stage_marks=marks)
            sync(self.dev)
            t1 = time.perf_counter()
            self.capturing = False
            if k < self.n_check:
                self.record_check(k, out)
                self.run.phase(f"checked step {k + 1}")
            if post:
                self.record_post(out)
                raise WindowClosed()
            if k == self.n_check + self.n_warm - 1:
                self.run.phase("warm-up")
                self.window_t0 = t1
                self.stage = "window"
            elif w and t1 - self.window_t0 > self.run.seconds:
                self.close_window()
            elif w:
                self.starts.append(t0)
                self.ends.append(t1)
                self.iters.append(it)
                if marks is not None:
                    self.marks.append(stage_ms(marks))
            elif self.stage == "profile":
                self.extra += 1
                if self.extra == self.profile_steps:
                    self.stop_profiler()
                    self.recorder.mode = "keep"
                    self.stage, self.extra = "keep", 0
            elif self.stage == "keep":
                self.extra += 1
                if self.extra == self.profile_steps:
                    self.recorder.mode = None
                    self.stage = "post"
            return out

        return step

    def close_window(self):
        """The window has closed: keep the memory peak; a traced run then
        traces `profile_steps` steps (counting kernel launches) and keeps
        the kernels' inputs over as many more, unprofiled; then the step
        after them is checked."""
        from .. import tracing
        self.peak = (torch.cuda.max_memory_allocated(self.dev)
                     if self.dev.type == "cuda" else 0)
        if not self.run.trace:
            self.stage = "post"
            return
        tracing.warm_up()
        self.recorder.mode = "count"
        self.prof_cm = tracing.profiled()
        self.prof_out = self.prof_cm.__enter__()
        self.stage = "profile"

    def stop_profiler(self):
        if self.prof_cm is not None:
            self.recorder.mode = None
            self.prof_cm.__exit__(None, None, None)
            self.prof_cm = None

    def record_check(self, k, out):
        from adgs_tpu_torch.train.optim import TrainableState, leaves
        params, env, opt_state, state = out[:4]
        self.losses.append(float(out[4]["total_loss"]))
        if k == 0:
            # the first gradient as Adam got it (its moments start at 0),
            # and the statistics' change over the first step
            self.grad_norms = readings.gradient_norms(leaves(opt_state.m))
            self.stats = readings.stat_changes(readings.stat_tensors(state),
                                               self.s0)
        if k == self.n_check - 1:
            self.first = dict(
                losses=self.losses, grad_norms=self.grad_norms,
                change_norms=readings.change_norms(
                    leaves(TrainableState(params, env)), self.p0),
                stats=self.stats, images=self.images[:self.n_check])
            self.p0 = self.s0 = None

    def record_post(self, out):
        from adgs_tpu_torch.train.optim import TrainableState, leaves
        params, env, opt_state, state = out[:4]
        snap = self.post
        names = list(snap["params"]) + ["env"]
        p0 = [snap["params"][n] for n in names[:-1]] + [snap["env"]]
        m0 = [snap["m"][n] for n in names]
        self.post_read = dict(
            losses=[float(out[4]["total_loss"])],
            grad_norms=readings.gradient_norms(leaves(opt_state.m), m0),
            change_norms=readings.change_norms(
                leaves(TrainableState(params, env)), p0),
            stats=readings.stat_changes(
                readings.stat_tensors(state),
                {n: snap["state"][n] for n in readings.POST_STATS}),
            images=self.images[self.n_check:])


def build_trainer(run, spec, traffic, w, train_views, test_views, frames):
    """The program's Trainer on the benchmark's scene and model."""
    from adgs_tpu_torch.core.camera import Camera
    from adgs_tpu_torch.data.readers import FrameInfo, SceneData
    from adgs_tpu_torch.models.env_map import EnvironmentMap
    from adgs_tpu_torch.models.gaussians import GaussianParams, GaussianState
    from adgs_tpu_torch.render import compute_binning
    from adgs_tpu_torch.train.config import OptimizationConfig
    from adgs_tpu_torch.train.losses import FrameBatch
    from adgs_tpu_torch.train.optim import TrainableState, init_adam
    from adgs_tpu_torch.train.trainer import Trainer

    dev = run.device

    def info(v, flows):
        return FrameInfo(uid=v.uid, cam_id=v.cam_id, fid=float(v.uid),
                         R=v.R, T=v.T, fovx=v.fovx, fovy=v.fovy,
                         width=v.width, height=v.height, time=v.time,
                         image_path="", depth=None, semantic=None, sky=None,
                         flow=flows, image_name=f"{v.uid:06d}.png")

    # the init cloud the Trainer is built on: the first Gaussians of each
    # block (the model is then replaced by the benchmark's, as a resume)
    k = int(traffic["init_points"])
    pts = torch.cat([w["scene_xyz"][:k], w["obj_xyz"][:k]]).cpu().numpy()
    n_images = len(train_views) + len(test_views)
    data = SceneData(
        points=pts, colors=np.full((2 * k, 3), 0.5, np.float32),
        times=np.concatenate([np.full(k, -1.0), np.full(k, 0.5)])
        .astype(np.float32),
        obj_id=np.concatenate([np.zeros(k), np.ones(k)]).astype(np.float32),
        train_frames=[info(v, fl) for v, (_, fl) in zip(train_views, frames)],
        test_frames=[info(v, None) for v in test_views],
        cameras_extent=scene.cameras_extent(train_views),
        scene_extent=scene.scene_extent(spec, w),
        frame_gap=float(spec["num_cam"]) / n_images,
        bound=(pts.min(0), pts.max(0)))
    opt = scene.optimization(spec, OptimizationConfig)
    model_path = os.path.join(run.tmp_dir, "model")
    tr = Trainer(data, opt, model_path, order_args=spec["order_args"],
                 sh_degree=int(spec["sh_degree"]),
                 env_resolution=int(traffic["init_env_resolution"]),
                 capacity=1 << 12, seed=run.seed, device=dev,
                 layout="gather")
    params = GaussianParams(**{name: w[name] for name in scene.LEAVES})
    zeros = torch.zeros(params.capacity, dtype=torch.float32, device=dev)
    state = GaussianState(
        scene_alive=w["scene_alive"], obj_alive=w["obj_alive"],
        gs_time=w["gs_time"], max_radii2d=zeros, xyz_grad_accum=zeros.clone(),
        denom=zeros.clone(),
        obj_near_idx=torch.zeros((1, 1), dtype=torch.int32, device=dev),
        obj_near_valid=torch.zeros((1,), dtype=torch.bool, device=dev))
    env = EnvironmentMap(grid=w["env"])
    start = int(traffic["start_iteration"])
    tr.params, tr.env, tr.state = params, env, state
    tr.opt_state = init_adam(TrainableState(params, env))._replace(
        count=torch.tensor(start, dtype=torch.int32))
    tr.iteration = start
    tr.active_sh_degree = int(spec["sh_degree"])
    by_cam = {}
    for i, (v, ((image, depth, sky, semantic), flows)) in enumerate(
            zip(train_views, frames)):
        cam = Camera.create(R=v.R, T=v.T, fovx=v.fovx, fovy=v.fovy,
                            width=v.width, height=v.height, time=v.time,
                            device=dev)
        tr._frame_cache[("train", i)] = (
            cam, FrameBatch(image=image, depth=depth, sky=sky,
                            semantic=semantic), flows)
        nr = int(compute_binning(cam, params, state, tr.config,
                                 capacity=1 << 10).num_rendered)
        by_cam[v.cam_id] = max(by_cam.get(v.cam_id, 0), nr)
    nr = max(by_cam.values())
    tr.capacity = scene.instance_capacity(nr)
    run.data.update(instance_capacity=tr.capacity, max_num_rendered=nr,
                    max_num_rendered_by_camera=[by_cam[c]
                                                for c in sorted(by_cam)])
    return tr


def run(run):
    spec, traffic, dev = run.spec, run.traffic, run.device
    run.phase("imports")
    w = scene.make_weights(spec, run.seed, dev,
                           capacity_factor=int(traffic["capacity_factor"]))
    run.phase("weights")
    all_views = scene.views(spec)
    train_views = [v for v in all_views if not v.is_test]
    test_views = [v for v in all_views if v.is_test]
    frames = scene.make_frames(spec, run.seed, dev, train_views,
                               int(traffic["flow_per_frame"]))
    run.phase("frames")
    tr = build_trainer(run, spec, traffic, w, train_views, test_views,
                       frames)
    run.phase("trainer and capacity")
    del w, frames
    probe = StepProbe(run, traffic)
    if run.trace:
        from ..tracing import LaunchRecorder
        probe.recorder = LaunchRecorder().install()
    build = tr._build_step

    def build_and_wrap():
        build()
        tr._step_fn = probe.wrap(tr._step_fn)

    tr._build_step = build_and_wrap
    refreshes, densifies, restore = count_events(tr)
    from adgs_tpu_torch.train import step as step_mod
    from ..capture import step_renders
    never = 10 ** 9
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        with step_renders(step_mod, probe.images, lambda: probe.capturing):
            tr.train(iterations=never - 1, save_iterations=[never],
                     test_iterations=[never])
    except WindowClosed:
        pass
    finally:
        probe.stop_profiler()
        restore()
    if probe.recorder is not None:
        probe.recorder.uninstall()
    n = len(probe.ends)
    if n == 0:
        raise RuntimeError("no training step ended inside the window")
    if probe.post_read is None:
        raise RuntimeError("the step after the window did not run")
    span = probe.ends[-1] - probe.window_t0
    run.setup_s = probe.window_t0 - run.t_start
    run.attempted, run.failed = n, 0
    peak = probe.peak
    run.memory_peak_bytes = peak
    run.e2e["train_ms_per_step"] = (1e3 * span / n, "ms")
    run.e2e["train_peak_gib"] = (peak / 2 ** 30, "GiB")
    in_window = set(probe.iters)
    run.data.update(
        driver="train", window_steps=n,
        window_refreshes=sum(1 for i in refreshes if i in in_window),
        window_densifies=sum(1 for i in densifies if i in in_window),
        first_window_iteration=probe.iters[0],
        window_halves_ms=window_halves_ms(probe.window_t0, probe.ends))
    if run.trace:
        record_trace(run, probe, tr)
    # the reference runs on freed memory: drop the program's state
    del tr, build, build_and_wrap
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = train_ref.follow(spec, traffic, run.seed, dev,
                           int(traffic["check_steps"]), post=probe.post)
    probe.post = None
    compare(run, [probe.first, probe.post_read], ref)
    run.data["reference_s"] = time.perf_counter() - t_ref


def count_events(tr):
    """Wrap the trainer's refresh and densify (module function) so that
    the iterations they ran at are counted; returns the lists and a
    function that puts densify back."""
    from adgs_tpu_torch.train import densify as densify_lib
    refreshes, densifies = [], []
    refresh = tr.refresh_near_idx

    def counted_refresh():
        refreshes.append(tr.iteration)
        return refresh()

    tr.refresh_near_idx = counted_refresh
    dp = densify_lib.densify_and_prune

    def counted_densify(*args, **kwargs):
        densifies.append(tr.iteration)
        return dp(*args, **kwargs)

    densify_lib.densify_and_prune = counted_densify

    def restore():
        densify_lib.densify_and_prune = dp

    return refreshes, densifies, restore


def record_trace(run, probe, tr):
    """Per-layer readings of a traced run (metrics/*.py read them): the
    window's stage marks and host gaps, and the profiled steps after it."""
    from .. import bounds, roofline
    out = probe.prof_out or {}
    outside = [s - e for s, e in zip(probe.starts[1:], probe.ends[:-1])]
    run.data.update(
        step_marks=probe.marks, outside_step_s=outside,
        window_step_s=list(np.diff([probe.window_t0] + probe.ends)),
        trace=out)
    if out.get("window_s"):
        run.busy_s, run.window_s = out["busy_s"], out["window_s"]
        run.breakdown = dict(device_ops=out["device_ops"],
                             idle_gaps=out["idle_gaps"])
    if probe.recorder is None or not probe.recorder.launches:
        return
    kb = bounds.launch_bounds(probe.recorder.launches)
    run.data["kernel_bound_s"] = {k: v for k, v in kb.items()
                                  if k != "pairs"}
    run.data["kernel_launches"] = dict(probe.recorder.counts)
    probe.recorder.launches.clear()
    pairs = kb["pairs"]
    if pairs:
        sz = scene.sizes(run.spec, int(run.traffic["capacity_factor"]))
        ns = int(tr.state.num_scene)
        no = int(tr.state.num_obj)
        h, w = int(run.spec["height"]), int(run.spec["width"])
        hit, gated, culled, ch = (sum(p[i] for p in pairs) / len(pairs)
                                  for i in range(4))
        nb, fl = roofline.train_step_bound(
            ns, no, sz.sh_k, sz.c_shs, sz.c_xyz, sz.c_rot, sz.c_bg,
            3 * sz.env_res ** 2, h * w, h * w, hit, gated, culled, ch)
        run.data["step_bound_s"] = roofline.bound_s(nb, fl)


def compare(run, got: list, ref: list):
    """The first stretch and the step after the window against the
    reference's (judge.train)."""
    from .. import judge

    def bare(stretch):
        return {k: v for k, v in stretch.items() if k != "images"}

    run.data["readings"] = dict(
        program=[bare(x) for x in got], reference=[bare(x) for x in ref],
        image_gaps=[judge.image_gaps(a["images"], b["images"])
                    for a, b in zip(got, ref)])
    for name, value in judge.train(got, ref).items():
        run.check(name, value, run.cell["limits"][name])
