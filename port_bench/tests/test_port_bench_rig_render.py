"""The rig render cell (`nuscenes-render`, drivers/render_rig.py) and its
two readers, camera_enqueue_ms.render and deforms_per_camera.render:

  - the round at full size: every timestamp's rig and the 150 time rigs,
    each rig's cameras at one time in `rig_request`'s order, the order
    drawn from the seed;
  - the rig's stage marks summed by stage over its cameras;
  - the readers on a hand-built store, None on a store whose frames carry
    neither the span nor the counters (a program that serves one camera
    without them), and off the render driver;
  - traced toy runs: the rig cell reads 1/3 deformations a camera, the
    single-camera render cell 1, and both a camera's enqueue time."""

import types

import pytest

from conftest import TOY_TRAFFIC, cell_spec, toy_run, toy_spec

MS = 1_000_000
READERS = ("camera_enqueue_ms.render", "deforms_per_camera.render")


@pytest.fixture
def store():
    from adgs_tpu_torch import profiling
    profiling.reset()
    yield profiling
    profiling.reset()


def _readers():
    from port_bench import harness
    return {n: m for n, m in harness.metric_readers().items()
            if n in READERS}


def _span(profiling, name, start, end, children=(), counts=None,
          number=None):
    s = profiling.Span(name, number)
    s.start_ns, s.end_ns, s.counts = start, end, counts
    for c in children:
        c.parent = s
        s.children.append(c)
    return s


def _frame(p, t0, number, n_cam, counted=True):
    """A served frame: 1 ms of deformation, then 2 ms a camera."""
    cams = [_span(p, "render.camera", t0 + (1 + 2 * k) * MS,
                  t0 + (3 + 2 * k) * MS, number=k) for k in range(n_cam)]
    counts = ({"frame_cameras": n_cam, "frame_deforms": 1} if counted
              else None)
    return _span(p, "serve.frame", t0, t0 + (1 + 2 * n_cam) * MS,
                 [_span(p, "render.deform", t0, t0 + MS)] + cams,
                 counts=counts, number=number)


def test_the_round_holds_every_rig_at_one_time():
    from port_bench import harness
    from port_bench.drivers import render_rig
    _, spec, traffic = harness.cell_files("nuscenes-render")
    rigs = render_rig.traffic_rigs(spec, traffic, 2 ** 31 + 7)
    assert len(rigs) == int(spec["timestamps"]) + traffic["interp_frames"]
    assert all(len({v.time for v in r}) == 1 for r in rigs)
    assert all([v.cam_id for v in r] == [0, 1, 2] for r in rigs)
    assert len({r[0].time for r in rigs}) == len(rigs) - 1   # 0 twice
    other = render_rig.traffic_rigs(spec, traffic, 4_250_000_001)
    assert [r[0].uid for r in other] != [r[0].uid for r in rigs]
    # a request in another order serves the cameras in that order
    back = dict(spec, rig_request=spec["rig_request"][::-1])
    assert render_rig.rig_cameras(back) == [2, 1, 0]


def test_rig_stage_marks_sum_over_cameras(monkeypatch):
    from adgs_tpu_torch import _stages
    from port_bench.drivers import render_rig

    class Ev:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    names = ["start", "deform"] + ["preprocess", "binning", "compositing",
                                   "sky"] * 3
    marks = [(n, Ev(float(i * i))) for i, n in enumerate(names)]
    got = render_rig.rig_stage_ms(marks)
    assert got["deform"] == 1.0
    assert got["preprocess"] == 3.0 + 11.0 + 19.0
    assert got["sky"] == 9.0 + 17.0 + 25.0
    assert sum(got.values()) == _stages.stage_ms(
        [("a", marks[0][1]), ("b", marks[-1][1])])["b"]


def test_readers_on_a_hand_built_store(store):
    store._state.roots.extend([_frame(store, 0, 0, 3),
                               _frame(store, 10 * MS, 1, 3)])
    r = _readers()
    run = types.SimpleNamespace(data={"driver": "render"})
    assert r["camera_enqueue_ms.render"].read(run) == pytest.approx(2.0)
    assert r["deforms_per_camera.render"].read(run) == pytest.approx(1 / 3)
    store.reset()
    store._state.roots.append(_frame(store, 0, 0, 1))
    assert r["deforms_per_camera.render"].read(run) == 1.0
    assert r["camera_enqueue_ms.render"].read(run) == pytest.approx(2.0)
    assert r["camera_enqueue_ms.render"].read(
        types.SimpleNamespace(data={"driver": "train"})) is None


def test_a_frame_without_the_span_or_counters_reads_nothing(store):
    """The frames of a program that serves one camera without the
    span and the counters (the parent of the rig entry)."""
    p = store
    store._state.roots.append(_span(p, "serve.frame", 0, 3 * MS, [
        _span(p, "render.deform", 0, MS)], number=0))
    run = types.SimpleNamespace(data={"driver": "render"})
    for name, reader in _readers().items():
        assert reader.read(run) is None, name
    store.reset()
    for name, reader in _readers().items():
        assert reader.read(run) is None, name


@pytest.mark.parametrize("workload,per_camera", [
    ("nuscenes-render", 1 / 3), ("kitti75-render", 1.0)])
def test_traced_toy_run_reads_both(workload, per_camera, store):
    if workload == "nuscenes-render":
        run = _rig_toy_run(trace=True)
    else:
        run = toy_run(workload, trace=True)
    from port_bench import harness
    line = harness.result_line(run)
    assert line["correct"] is True, line["checks"]
    m = line["metrics"]
    assert m["deforms_per_camera.render"]["value"] == pytest.approx(
        per_camera)
    assert m["camera_enqueue_ms.render"]["value"] > 0
    assert m["camera_enqueue_ms.render"]["value"] < \
        m["frame_enqueue_ms.render"]["value"]


def _rig_toy_run(trace: bool):
    """The committed rig cell at the toy size, its window closed after 6
    frames."""
    import time

    import torch
    from port_bench import harness
    _, spec = cell_spec("nuscenes-render")
    traffic = dict(TOY_TRAFFIC["render"], window_frames=6)
    run = harness.Run("nuscenes-render", 2 ** 31 + 7, 60.0, trace,
                      torch.device("cpu"), time.perf_counter(),
                      overrides=dict(spec=toy_spec(spec), traffic=traffic))
    try:
        harness.drive(run)
    finally:
        run.close()
    return run
