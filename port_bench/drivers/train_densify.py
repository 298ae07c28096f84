"""Trainer traffic on a model that grows: the `train` traffic
(drivers/train.py, whose functions this driver calls) on a configuration
whose densify thresholds clone and split, with a densify checked against
the frozen plain densify (reference/plain/train/densify.py).

The window is `train`'s: `--seconds` of `Trainer.train` after the check
and warm-up steps, densifies and KNN refreshes inside. Each densify's
report and alive counts before and after are kept as tensors and read
once the window has closed, so that the window waits on nothing more than
the trainer does.

After the window the trainer runs on, untimed, to the next densify: the
first multiple of `densification_interval` more than half `profile_steps`
past the step that closed the window. A traced run starts its profiler
half `profile_steps` before that densify, so that the densify lies inside
the traced stretch; an untraced run goes on to the step after it. At that
densify the driver keeps the densify's inputs (parameters, Adam state,
GaussianState), the state of the trainer's generator, from which the
split's draws are made again (`split_draws`), and its outputs. They are
kept by reference: the program's densify and step return fresh tensors
and leave their inputs as they were (a later write in place would show
as a gap). Then the step after the window is checked as `train` checks
it, on the grown state.

Once the program is freed, the frozen plain densify runs on the kept
inputs with the same draws. Two numbers join `train`'s:

- `densify_gap`: the widest gap of a parameter or Adam moment leaf of
  either block, relative to the reference leaf's largest magnitude; inf
  unless the alive masks, gs_time, every other GaussianState field and
  the report's eight counts are bitwise equal;
- `densify_stalled`: 1 if the window's densifies added no Gaussian (no
  clone and no split sample written, or no densify in the window), else
  0, so that a program that stops densifying cannot pass as faster.

A traffic may set `window_steps`: the window then closes after that many
steps instead of after `--seconds` (a step count keeps a toy run on a
loaded CPU from closing its window before a step ends in it).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from .. import scene
from ..harness import window_halves_ms
from ..reference import train_ref
from . import train as base


class DensifyProbe(base.StepProbe):
    """`train`'s step wrapper with the stretch after the window: steps
    to the kept densify (`keep_at`), untimed, then `train`'s profiled,
    kept and checked steps."""

    def __init__(self, run, traffic: dict, interval: int):
        super().__init__(run, traffic)
        self.interval = int(interval)
        self.window_steps = traffic.get("window_steps")
        self.lead = self.profile_steps // 2 if run.trace else 0
        self.keep_at = self.resume_after = None

    def close_window(self):
        """Keep the memory peak; the steps after the window run untimed
        until `resume`."""
        self.peak = (torch.cuda.max_memory_allocated(self.dev)
                     if self.dev.type == "cuda" else 0)
        self.stage = "after"

    def resume(self):
        """`train`'s close of the window (the profiler in a traced run, else
        the checked step), with the peak that the window closed on."""
        peak = self.peak
        base.StepProbe.close_window(self)
        self.peak = peak

    def wrap(self, inner):
        step = super().wrap(inner)

        def outer(*args, **kwargs):
            if (self.stage == "window" and self.window_steps is not None
                    and len(self.ends) >= int(self.window_steps)):
                self.close_window()
            out = step(*args, **kwargs)
            if self.stage == "after":
                it = int(args[7])
                if self.keep_at is None:
                    self.keep_at = self.interval * (
                        (it + self.lead) // self.interval + 1)
                    self.resume_after = self.keep_at - self.lead
                if it >= self.resume_after:
                    self.resume()
            return out

        return outer


class DensifyWatch:
    """Wraps the program's densify_and_prune (a module function, looked up
    at each call): every call's report and alive counts before and after
    (tensors, read later), and at the probe's `keep_at` the call's inputs,
    arguments, generator state and outputs."""

    def __init__(self, tr, probe: DensifyProbe):
        from adgs_tpu_torch.train import densify as densify_lib
        self.tr, self.probe, self.lib = tr, probe, densify_lib
        self.inner = densify_lib.densify_and_prune
        self.events: list = []
        self.kept = None

    def install(self):
        self.lib.densify_and_prune = self
        return self

    def uninstall(self):
        self.lib.densify_and_prune = self.inner

    def __call__(self, trainables, opt_state, state, generator, *args):
        it = self.tr.iteration
        keep = it == self.probe.keep_at
        gen_state = generator.get_state() if keep else None
        before = alive_count(state)
        out = self.inner(trainables, opt_state, state, generator, *args)
        self.events.append((it, out[3], before, alive_count(out[2])))
        if keep:
            self.kept = dict(inputs=(trainables, opt_state, state),
                             gen_state=gen_state, args=args, outputs=out)
        return out


def alive_count(state) -> torch.Tensor:
    return torch.sum(state.scene_alive) + torch.sum(state.obj_alive)


def growth(events: list, window_iters: set) -> list:
    """One record a densify: its iteration, whether it fell in the window,
    the report's counts summed over both blocks, the alive Gaussians
    before and after, and the net growth as a share of those before."""
    rows = []
    for it, report, before, after in events:
        n = dict(zip(report._fields, (int(x) for x in report)))
        b, a = int(before), int(after)
        rows.append(dict(
            iteration=int(it), in_window=it in window_iters,
            **{what: n[f"scene_{what}"] + n[f"obj_{what}"]
               for what in ("cloned", "split", "pruned", "dropped")},
            alive_before=b, alive_after=a,
            net_share=(a - b) / b if b else 0.0))
    return rows


def densify_outputs(trainables, opt_state, state, report) -> dict:
    """A densify's outputs by name, of the program's or the reference's
    types: "values" every parameter and Adam moment leaf of the Gaussians
    (p., m., v.), "exact" every GaussianState field, "counts" the report's
    eight counts."""
    values = {}
    for pre, tree in (("p.", trainables.gaussians),
                      ("m.", opt_state.m.gaussians),
                      ("v.", opt_state.v.gaussians)):
        for f in dataclasses.fields(tree):
            values[pre + f.name] = getattr(tree, f.name)
    exact = {f.name: getattr(state, f.name)
             for f in dataclasses.fields(state)}
    return dict(values=values, exact=exact,
                counts=[int(x) for x in report])


def densify_gap(got: dict, ref: dict) -> float:
    """The widest relative gap of a value leaf (max |got - ref| over max
    |ref|; a leaf that is zero in the reference must be zero), inf unless
    every exact field and count is bitwise equal."""
    if (got["counts"] != ref["counts"] or set(got["values"])
            != set(ref["values"]) or set(got["exact"]) != set(ref["exact"])):
        return math.inf
    for name, r in ref["exact"].items():
        a = got["exact"][name]
        if (a.dtype != r.dtype or a.shape != r.shape
                or not torch.equal(a, r)):
            return math.inf
    worst = 0.0
    for name, r in ref["values"].items():
        a = got["values"][name]
        if a.shape != r.shape:
            return math.inf
        if r.numel() == 0:
            continue
        diff = float((a.double() - r.double()).abs().max())
        scale = float(r.double().abs().max())
        if not math.isfinite(diff) or (scale == 0.0 and diff != 0.0):
            return math.inf
        if scale:
            worst = max(worst, diff / scale)
    return worst


def plain_densify(kept: dict) -> dict:
    """The frozen plain densify on the kept inputs and the split's draws
    made again from the kept generator state; its outputs as
    densify_outputs gives them."""
    from adgs_tpu_torch.train.densify import split_draws
    from ..reference.plain.models.env_map import EnvironmentMap
    from ..reference.plain.models.gaussians import (GaussianParams,
                                                    GaussianState)
    from ..reference.plain.train import densify as plain
    from ..reference.plain.train.optim import AdamState, TrainableState
    trainables, opt_state, state = kept["inputs"]
    gen = torch.Generator(device=trainables.gaussians.scene_xyz.device)
    gen.set_state(kept["gen_state"])
    eps_scene, eps_obj = split_draws(trainables, gen)

    def tree(t):
        g = t.gaussians
        return TrainableState(
            GaussianParams(**{f.name: getattr(g, f.name)
                              for f in dataclasses.fields(g)}),
            EnvironmentMap(grid=t.env.grid))

    ref_state = GaussianState(**{f.name: getattr(state, f.name)
                                 for f in dataclasses.fields(state)})
    ref_opt = AdamState(m=tree(opt_state.m), v=tree(opt_state.v),
                        count=opt_state.count)
    return densify_outputs(*plain.densify_and_prune_eps(
        tree(trainables), ref_opt, ref_state, eps_scene, eps_obj,
        *kept["args"]))


def check_densify(run, kept, rows: list) -> None:
    """densify_gap of the kept densify and densify_stalled of the
    window's (run.check against the cell's limits)."""
    limits = run.cell["limits"]
    gap = math.inf
    if kept is not None:
        got = densify_outputs(*kept["outputs"])
        gap = densify_gap(got, plain_densify(kept))
    run.check("densify_gap", gap, limits["densify_gap"])
    added = sum(r["cloned"] + r["split"] for r in rows if r["in_window"])
    run.check("densify_stalled", 0.0 if added else 1.0,
              limits["densify_stalled"])


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
    tr = base.build_trainer(run, spec, traffic, w, train_views, test_views,
                            frames)
    run.phase("trainer and capacity")
    del w, frames
    probe = DensifyProbe(run, traffic, tr.opt.densification_interval)
    if run.trace:
        from ..tracing import LaunchRecorder
        probe.recorder = LaunchRecorder().install()
    build = tr._build_step
    builds = []

    def build_and_wrap():
        builds.append(tr.iteration)
        build()
        tr._step_fn = probe.wrap(tr._step_fn)

    tr._build_step = build_and_wrap
    capacity0 = (tr.params.scene_capacity, tr.params.obj_capacity)
    refreshes, densifies, restore = base.count_events(tr)
    watch = DensifyWatch(tr, probe).install()
    from adgs_tpu_torch.train import step as step_mod
    from ..capture import step_renders
    never = 10 ** 9
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        with step_renders(step_mod, probe.images, lambda: probe.capturing):
            tr.train(iterations=never - 1, save_iterations=[never],
                     test_iterations=[never])
    except base.WindowClosed:
        pass
    finally:
        probe.stop_profiler()
        watch.uninstall()
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
    run.memory_peak_bytes = probe.peak
    run.e2e["train_ms_per_step"] = (1e3 * span / n, "ms")
    run.e2e["train_peak_gib"] = (probe.peak / 2 ** 30, "GiB")
    in_window = set(probe.iters)
    rows = growth(watch.events, in_window)
    run.data.update(
        driver="train", window_steps=n,
        window_refreshes=sum(1 for i in refreshes if i in in_window),
        window_densifies=sum(1 for i in densifies if i in in_window),
        first_window_iteration=probe.iters[0],
        window_halves_ms=window_halves_ms(probe.window_t0, probe.ends))
    capacity = dict(
        instance=[tr.capacity, builds[1:]],
        gaussians=[list(capacity0), [tr.params.scene_capacity,
                                     tr.params.obj_capacity]])
    if run.trace:
        base.record_trace(run, probe, tr)
    # the references run on freed memory: drop the program's state
    kept, watch.kept, watch.events = watch.kept, None, None
    del tr, build, build_and_wrap, watch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    check_densify(run, kept, rows)
    del kept
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = train_ref.follow(spec, traffic, run.seed, dev,
                           int(traffic["check_steps"]), post=probe.post)
    probe.post = None
    base.compare(run, [probe.first, probe.post_read], ref)
    run.data["readings"].update(densify=rows, capacity=capacity)
    run.data["reference_s"] = time.perf_counter() - t_ref
