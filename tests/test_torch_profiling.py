"""The port's spans and counters (adgs_tpu_torch/profiling.py) on the CPU,
on tests/test_torch_trainer.py's 64x48 synthetic KITTI scene:
  - with no profiler nothing is recorded, span() returns the shared
    no-op and allocates nothing;
  - a profiler started inside an open root that does not record leaves
    no orphan roots, and a root that outlives the profiler is not kept;
  - three traced iterations give three "trainer.iteration" roots whose
    children lie inside them in the loop's order, each span also in the
    profiler's Chrome trace, on the same clock;
  - "h2d_bytes" of the frames is the flow packages' bytes, "host_syncs"
    of the reads is two;
  - "splat_instances" of the reads is the step's num_rendered, read on
    the host with no read of its own (the read span converts two tensors
    to numbers, as before the counter), and nothing without a profiler;
  - the step's outputs and its marks' names are bitwise and letter for
    letter the same with tracing on and off;
  - summary()'s arithmetic on a hand-built store; --profile writes it to
    metrics.jsonl;
  - a densify's span counts its report (densify_cloned, _split, _pruned,
    _dropped) and one host sync for reading it; a block's growth is a
    "trainer.grow" span counting "capacity_grows"."""

import contextlib
import copy
import dataclasses
import json
import os
import statistics
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adgs_tpu_torch import profiling
from adgs_tpu_torch.data.readers import read_scene
from adgs_tpu_torch.train import trainer as trainer_mod
from adgs_tpu_torch.train.config import OptimizationConfig
from adgs_tpu_torch.train.trainer import Trainer
from tests.test_data_cli import make_kitti_scene

ORDER = dict(xyz=[4, 2, 0, 2, 0, 0], rotation=[0, 0, 0, 0, 4, 2],
             shs=[0, 0, 0, 2, 0, 0], background=[0, 0, 0, 0, 0, 0])
W, H = 64, 48
# densify at 3, a KNN refresh and a log line at 2: every child of an
# iteration shows within three
OPT = dict(densify_from_iter=1, densification_interval=3,
           near_idx_reset_interval=2)
CHILDREN = ("trainer.frames", "trainer.step", "trainer.read", "trainer.log",
            "trainer.refresh", "trainer.densify")
STEP_CHILDREN = ("render.deform", "render.preprocess", "render.binning",
                 "render.compositing", "render.sky", "step.losses",
                 "step.backward", "step.adam", "step.stats")


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.reset()
    yield
    profiling.reset()


def _trainer(tmp_path, name="out"):
    root = str(tmp_path / "scene")
    if not os.path.exists(root):
        make_kitti_scene(root, width=W, height=H)
    return Trainer(read_scene(root), OptimizationConfig(**OPT),
                   str(tmp_path / name), order_args=ORDER, env_resolution=32,
                   capacity=4096, capacity_quantum=256, seed=1,
                   device="cpu")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Three iterations of Trainer.train under a CPU profiler: the stored
    roots, the trace's events and base, and the flow packages the frames
    made (caught at the trainer's flow_package). The frame cache and the
    rays are filled first, as after the first round of cameras."""
    tmp = tmp_path_factory.mktemp("traced")
    tr = _trainer(tmp)
    for i, info in enumerate(tr.scene.train_frames):
        cam, _, _ = tr._get_frame("train", i)
        tr._rays_for(cam, info.cam_id)
    packages = []
    real = trainer_mod.flow_package

    def caught(raw, device=None):
        packages.append(real(raw, device=device))
        return packages[-1]

    trainer_mod.flow_package = caught
    # each step's num_rendered, as the step returned it
    rendered = []
    real_step = trainer_mod.make_train_step

    def kept_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def wrapped(*a, **kw):
            out = step(*a, **kw)
            rendered.append(out[4]["num_rendered"])
            return out

        return wrapped

    trainer_mod.make_train_step = kept_step
    # Tensor -> number conversions inside each read span
    reads = []
    conversions = ("__float__", "__int__", "__bool__", "item", "tolist")
    real_conv = {n: getattr(torch.Tensor, n) for n in conversions}

    def counted(name):
        def conv(t, *a, **kw):
            if any(sp.name == "trainer.read" for sp in profiling._state.open):
                reads[-1] += 1
            return real_conv[name](t, *a, **kw)
        return conv

    real_read = profiling.Span.__enter__

    def enter(sp):
        if sp.name == "trainer.read":
            reads.append(0)
        return real_read(sp)

    # the first profiler of a process and its first range pay a one-time
    # set-up that would fall inside the first span
    with profile(activities=[ProfilerActivity.CPU]), \
            profiling.span("warm-up"):
        pass
    profiling.reset()
    try:
        for n in conversions:
            setattr(torch.Tensor, n, counted(n))
        profiling.Span.__enter__ = enter
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tr.train(iterations=3, save_iterations=[9], test_iterations=[9],
                     log_every=2)
    finally:
        for n in conversions:
            setattr(torch.Tensor, n, real_conv[n])
        profiling.Span.__enter__ = real_read
        trainer_mod.make_train_step = real_step
        trainer_mod.flow_package = real
    path = str(tmp / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    roots = profiling.roots()
    profiling.reset()
    tr.close()
    return dict(roots=roots, events=doc["traceEvents"],
                base_ns=int(doc.get("baseTimeNanoseconds", 0)),
                packages=packages, rendered=[int(n) for n in rendered],
                reads=reads)


def test_off_records_nothing(tmp_path):
    a = profiling.span("trainer.iteration", 1)
    assert a is profiling.span("render.deform")
    blocks = sys.getallocatedblocks()
    for _ in range(10_000):
        with profiling.span("a", 7), profiling.span("b"):
            profiling.count("host_syncs", 2)
    assert sys.getallocatedblocks() - blocks < 100
    tr = _trainer(tmp_path)
    tr.train(iterations=1, save_iterations=[9], test_iterations=[9])
    tr.close()
    assert profiling.roots() == [] and profiling.summary() == {}


def test_profiler_started_inside_an_open_root_leaves_no_orphans():
    with profiling.span("trainer.iteration", 5):
        with profiling.span("trainer.step"):
            prof = profile(activities=[ProfilerActivity.CPU])
            prof.__enter__()
        with profiling.span("trainer.read"):
            profiling.count("host_syncs", 2)
        with profiling.span("trainer.refresh"):
            pass
    try:
        assert profiling.roots() == []
        with profiling.span("trainer.iteration", 6):
            with profiling.span("trainer.read"):
                profiling.count("host_syncs", 2)
        # a root that outlives the profiler is not kept
        with profiling.span("trainer.iteration", 7):
            with profiling.span("trainer.step"):
                prof.__exit__(None, None, None)
                prof = None
            with profiling.span("trainer.read"):
                pass
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    (root,) = profiling.roots()
    assert (root.name, root.number) == ("trainer.iteration", 6)
    assert [c.name for c in root.children] == ["trainer.read"]


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def _in_order(names, order):
    pos = [order.index(n) for n in names]
    return pos == sorted(pos)


def test_trainer_spans_nest_in_order(traced):
    roots = [r for r in traced["roots"] if r.name == "trainer.iteration"]
    assert [r.number for r in roots] == [1, 2, 3]
    seen = set()
    for r in roots:
        names = [c.name for c in r.children]
        assert _in_order(names, CHILDREN), names
        seen.update(names)
        for c in r.children:
            assert _inside(c, r)
            for g in c.children:
                assert _inside(g, c)
        (step,) = [c for c in r.children if c.name == "trainer.step"]
        assert tuple(c.name for c in step.children) == STEP_CHILDREN
        for a, b in zip(r.children, r.children[1:]):
            assert a.end_ns <= b.start_ns
    assert seen == set(CHILDREN)


def test_spans_lie_in_the_trace_on_its_clock(traced):
    marks = {}
    for e in traced["events"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            marks.setdefault(e["name"], []).append(e)
    for v in marks.values():
        v.sort(key=lambda e: e["ts"])
    spans = sorted((s for r in traced["roots"] for s in r.walk()),
                   key=lambda s: s.start_ns)
    offsets, used = [], {}
    for s in spans:
        k = used.get(s.name, 0)
        used[s.name] = k + 1
        e = marks[s.name][k]
        dur_us = (s.end_ns - s.start_ns) / 1e3
        assert abs(float(e["dur"]) - dur_us) <= max(0.05 * dur_us, 100.0), \
            (s.name, e["dur"], dur_us)
        offsets.append(float(e["ts"]) * 1e3 + traced["base_ns"] - s.start_ns)
    assert len(offsets) == len(spans) >= 40
    mid = statistics.median(offsets)
    assert max(abs(o - mid) for o in offsets) <= 1e6


def test_counters_of_the_frames_and_the_reads(traced):
    roots = [r for r in traced["roots"] if r.name == "trainer.iteration"]
    pkgs = traced["packages"]
    assert len(pkgs) == len(roots) == 3
    for r, pkg in zip(roots, pkgs):
        (frames,) = [c for c in r.children if c.name == "trainer.frames"]
        flow_valid = 1                     # torch.tensor(True), one byte
        assert frames.counts["h2d_bytes"] == \
            sum(t.nbytes for t in pkg) + flow_valid
        assert frames.counts["host_syncs"] == len(pkg) + 1
        (read,) = [c for c in r.children if c.name == "trainer.read"]
        assert read.counts["host_syncs"] == 2


def test_splat_instances_is_num_rendered_read_once(traced):
    """The read span counts the step's num_rendered under
    "splat_instances" beside its two host syncs, and converts exactly two
    tensors to numbers (the loss, num_rendered): the counter is the value
    the overflow guard reads, and adds no read; the root's summary is the
    mean over the steps."""
    roots = [r for r in traced["roots"] if r.name == "trainer.iteration"]
    assert len(roots) == len(traced["rendered"]) == 3
    assert traced["reads"] == [2, 2, 2]
    for r, nr in zip(roots, traced["rendered"]):
        (read,) = [c for c in r.children if c.name == "trainer.read"]
        assert nr > 0
        assert read.counts == {"host_syncs": 2, "splat_instances": nr}
    for r in roots:
        profiling._state.roots.append(r)
    counts = profiling.summary()["trainer.iteration"]["spans"][
        "trainer.iteration"]["counts"]
    assert counts["splat_instances"] == pytest.approx(
        sum(traced["rendered"]) / 3)


def test_splat_instances_off_records_nothing(tmp_path):
    """Without a profiler the trainer's steps render (num_rendered > 0)
    and the store stays empty: no root, no counter."""
    tr = _trainer(tmp_path)
    seen = []
    tr._build_step()
    step = tr._step_fn

    def kept(*a, **kw):
        out = step(*a, **kw)
        seen.append(int(out[4]["num_rendered"]))
        return out

    tr._step_fn = kept
    tr._build_step = lambda: setattr(tr, "_step_fn", kept)
    tr.train(iterations=2, save_iterations=[9], test_iterations=[9])
    tr.close()
    assert len(seen) == 2 and min(seen) > 0
    assert profiling.roots() == [] and profiling.summary() == {}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


class _Event:
    """A CPU stand-in for torch.cuda.Event: the marks keep their names."""

    def __init__(self, **kw):
        pass

    def record(self):
        pass


def test_tracing_leaves_the_step_and_its_marks_alone(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    tr = _trainer(tmp_path)
    tr._build_step()
    tr.refresh_near_idx()
    cam, batch, rays = tr._frames_for_step([0], tr.opt)
    args = (tr.params, tr.env, tr.opt_state, tr.state, cam, batch, rays, 1)

    def step(traced):
        marks = []
        ctx = (profile(activities=[ProfilerActivity.CPU]) if traced
               else contextlib.nullcontext())
        with ctx, profiling.span("trainer.step", 1):
            out = tr._step_fn(*copy.deepcopy(args), active_sh_degree=0,
                              stage_marks=marks)
        return _tensors(out), [n for n, _ in marks]

    off, off_marks = step(False)
    assert profiling.roots() == []
    on, on_marks = step(True)
    assert len(profiling.roots()) == 1
    assert on_marks == off_marks
    assert off_marks == ["start", "deform", "preprocess", "binning",
                         "compositing", "sky", "losses", "backward", "adam",
                         "stats"]
    assert len(on) == len(off) > 20
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tr.close()


def _span(name, start, end, children=(), counts=None, number=None):
    s = profiling.Span(name, number)
    s.start_ns, s.end_ns, s.counts = start, end, counts
    for c in children:
        c.parent = s
        s.children.append(c)
    return s


def test_summary_arithmetic_on_a_hand_built_store():
    ms = 1_000_000
    r1 = _span("it", 0, 10 * ms, [
        _span("step", 1 * ms, 7 * ms, [_span("losses", 2 * ms, 3 * ms,
                                             counts={"h2d_bytes": 40})],
              counts={"host_syncs": 3}),
        _span("read", 7 * ms, 9 * ms, counts={"host_syncs": 2})], number=1)
    r2 = _span("it", 20 * ms, 24 * ms, [
        _span("step", 20 * ms, 23 * ms, counts={"h2d_bytes": 60})],
        number=2)
    f1 = _span("frame", 0, 5 * ms, number=0)
    for r in (r1, r2, f1):
        profiling._state.roots.append(r)
    s = profiling.summary()
    assert s["it"]["roots"] == 2 and s["frame"]["roots"] == 1
    sp = s["it"]["spans"]
    assert sp["it"]["ms"] == pytest.approx((10 + 4) / 2)
    assert sp["it"]["self_ms"] == pytest.approx((10 - 6 - 2 + 4 - 3) / 2)
    assert sp["step"]["ms"] == pytest.approx((6 + 3) / 2)
    assert sp["step"]["self_ms"] == pytest.approx((5 + 3) / 2)
    assert sp["losses"]["ms"] == pytest.approx(1 / 2)
    assert sp["read"]["ms"] == pytest.approx(2 / 2)
    assert sp["it"]["counts"] == {"host_syncs": 2.5, "h2d_bytes": 50.0}
    assert sp["step"]["counts"] == {"host_syncs": 1.5, "h2d_bytes": 50.0}
    assert sp["losses"]["counts"] == {"h2d_bytes": 20.0}
    assert s["frame"]["spans"]["frame"] == dict(ms=5.0, self_ms=5.0,
                                                counts={})
    profiling.reset()
    assert profiling.summary() == {}


def test_store_keeps_the_last_roots():
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(profiling.MAX_ROOTS + 5):
            with profiling.span("serve.frame", i):
                pass
    roots = profiling.roots()
    assert len(roots) == profiling.MAX_ROOTS
    assert roots[0].number == 5 and roots[-1].number == profiling.MAX_ROOTS + 4


def test_profile_window_writes_the_summary(tmp_path, monkeypatch):
    """--profile traces steps 20-39 and writes summary() to metrics.jsonl
    (split "profile"); the step is stubbed, so 40 iterations are quick."""
    tr = _trainer(tmp_path)
    tr.profile_dir = str(tmp_path / "prof")

    def step(params, env, opt_state, state, cam, batch, rays, it,
             active_sh_degree=3):
        return (params, env, opt_state, state,
                {"total_loss": torch.tensor(1.0),
                 "num_rendered": torch.tensor(100)})

    tr._build_step = lambda: setattr(tr, "_step_fn", step)
    monkeypatch.setattr(tr, "refresh_near_idx", lambda: None)
    tr.train(iterations=41, save_iterations=[99], test_iterations=[99])
    tr.close()
    (trace_file,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / trace_file) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"trainer.iteration", "trainer.frames", "trainer.step",
            "trainer.read"} <= names
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        (rec,) = [r for r in map(json.loads, f) if r["split"] == "profile"]
    assert rec["step"] == 40
    assert rec["trainer.iteration/roots"] == 20
    assert rec["trainer.iteration/trainer.read/host_syncs"] == 2
    assert rec["trainer.iteration/trainer.frames/h2d_bytes"] == \
        3 * W * H * 4 + (1 + 9 + 9 + 3) * 4 + 1
    assert rec["trainer.iteration/trainer.iteration/ms"] > 0



def test_densify_counters_and_growth(tmp_path, monkeypatch):
    """A densify at threshold 0 (every alive Gaussian copied) fills the
    scene block: its span counts the report's clones, split samples,
    prunes and dropped copies, each the sum over both blocks, and one
    host sync for the report's read besides the capacity check's two and
    the densify's own copies; the block's growth is a "trainer.grow" span
    inside it that counts "capacity_grows"."""
    from adgs_tpu_torch.train import densify as densify_lib
    root = str(tmp_path / "scene")
    make_kitti_scene(root, width=W, height=H)
    opt = OptimizationConfig(**OPT, densify_scene_grad_threshold=0.0,
                             densify_obj_grad_threshold=0.0,
                             percent_dense=0.1)
    tr = Trainer(read_scene(root), opt, str(tmp_path / "out"),
                 order_args=ORDER, env_resolution=32, capacity=4096,
                 capacity_quantum=256, seed=1, device="cpu")
    reports, copies = [], []
    real = densify_lib.densify_and_prune

    def spy(*args):
        out = real(*args)
        reports.append({k: int(v) for k, v in out[3]._asdict().items()})
        return out

    real_copied = densify_lib.copied_in

    def copied(*tensors):
        copies.append(len(tensors))
        real_copied(*tensors)

    monkeypatch.setattr(densify_lib, "densify_and_prune", spy)
    monkeypatch.setattr(densify_lib, "copied_in", copied)
    capacity = tr.params.capacity
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train(iterations=4, save_iterations=[9], test_iterations=[9])
    tr.close()
    (rep,) = reports
    assert rep["scene_cloned"] > 0 and rep["scene_dropped"] > 0
    roots = {r.number: r for r in profiling.roots()
             if r.name == "trainer.iteration"}
    (dens,) = [c for c in roots[3].children if c.name == "trainer.densify"]
    for what in ("cloned", "split", "pruned", "dropped"):
        assert dens.counts[f"densify_{what}"] == \
            rep[f"scene_{what}"] + rep[f"obj_{what}"]
    assert dens.counts["host_syncs"] == 1 + 2 + sum(copies)
    (grow,) = [c for c in dens.children if c.name == "trainer.grow"]
    assert grow.counts == {"capacity_grows": 1}
    assert tr.params.capacity > capacity
    assert not any(s.name == "trainer.grow" for r in roots.values()
                   for s in r.walk() if s is not grow)
