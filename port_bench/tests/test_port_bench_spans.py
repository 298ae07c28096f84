"""The six readers of the program's spans and counters (metrics/*.py with
"source": "program_span" beside port_bench/program_spans.py): their
arithmetic on a hand-built store, None off their driver and on an empty
store, and a traced toy run of each driver, whose profiled sub-window is
all the store holds."""

import types

import pytest

from conftest import TOY_TRAFFIC, toy_run

SPAN_METRICS = {
    "trainer_ms.train": "train", "flow_upload_ms.train": "train",
    "h2d_mb.train": "train", "host_syncs.train": "train",
    "step_enqueue_ms.train": "train", "frame_enqueue_ms.render": "render",
}
MS = 1_000_000


@pytest.fixture
def store():
    from adgs_tpu_torch import profiling
    profiling.reset()
    yield profiling
    profiling.reset()


def _span(profiling, name, start, end, children=(), counts=None,
          number=None):
    s = profiling.Span(name, number)
    s.start_ns, s.end_ns, s.counts = start, end, counts
    for c in children:
        c.parent = s
        s.children.append(c)
    return s


def _iteration(p, t0, number):
    """An iteration of 10 ms: frames 2 ms (5.6 MB, 7 syncs), step 5 ms (a
    1 ms child with 10 syncs), read 1 ms (2 syncs)."""
    return _span(p, "trainer.iteration", t0, t0 + 10 * MS, [
        _span(p, "trainer.frames", t0, t0 + 2 * MS,
              counts={"h2d_bytes": 5_589_001, "host_syncs": 7}),
        _span(p, "trainer.step", t0 + 2 * MS, t0 + 7 * MS, [
            _span(p, "render.deform", t0 + 2 * MS, t0 + 3 * MS,
                  counts={"h2d_bytes": 780, "host_syncs": 10})]),
        _span(p, "trainer.read", t0 + 7 * MS, t0 + 8 * MS,
              counts={"host_syncs": 2})], number=number)


def _readers():
    from port_bench import harness
    return {n: m for n, m in harness.metric_readers().items()
            if n in SPAN_METRICS}


def _run(driver):
    return types.SimpleNamespace(data={"driver": driver})


def test_readers_on_a_hand_built_store(store):
    readers = _readers()
    assert set(readers) == set(SPAN_METRICS)
    for name, mod in readers.items():
        assert mod.read(_run(SPAN_METRICS[name])) is None, name
    for i in range(2):
        store._state.roots.append(_iteration(store, 100 * i * MS, 5300 + i))
    store._state.roots.append(_span(store, "serve.frame", 0, 3 * MS,
                                    number=0))
    store._state.roots.append(_span(store, "serve.frame", 0, 5 * MS,
                                    number=1))
    got = {n: m.read(_run(SPAN_METRICS[n])) for n, m in readers.items()}
    assert got["trainer_ms.train"] == pytest.approx(10 - 5 - 1)
    assert got["flow_upload_ms.train"] == pytest.approx(2)
    assert got["h2d_mb.train"] == pytest.approx(5.589781)
    assert got["host_syncs.train"] == pytest.approx(19)
    assert got["step_enqueue_ms.train"] == pytest.approx(5)
    assert got["frame_enqueue_ms.render"] == pytest.approx(4)
    for name, mod in readers.items():
        other = "render" if SPAN_METRICS[name] == "train" else "train"
        assert mod.read(_run(other)) is None, name


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from adgs_tpu_torch import profiling
    monkeypatch.delattr(profiling, "summary")
    for name, mod in _readers().items():
        assert mod.read(_run(SPAN_METRICS[name])) is None, name


@pytest.mark.parametrize("workload", ("kitti75-train", "kitti75-render"))
def test_traced_toy_run_reads_the_profiled_window(workload, store):
    from port_bench import harness
    run = toy_run(workload, seconds=5.0, trace=True)
    line = harness.result_line(run)
    assert line["correct"] is True, line["checks"]
    driver = run.data["driver"]
    mine = {n for n, d in SPAN_METRICS.items() if d == driver}
    assert mine <= set(line["metrics"])
    assert not (set(SPAN_METRICS) - mine) & set(line["metrics"])
    summary = store.summary()
    if driver == "train":
        # the train traffic stops its profiler inside the last profiled
        # step, whose root is not kept
        assert summary["trainer.iteration"]["roots"] == \
            TOY_TRAFFIC["train"]["profile_steps"] - 1
        assert line["metrics"]["host_syncs.train"]["value"] >= 2
        assert line["metrics"]["h2d_mb.train"]["value"] > 0
    else:
        assert set(summary) == {"serve.frame"}
        assert summary["serve.frame"]["roots"] == \
            TOY_TRAFFIC["render"]["profile_frames"]
