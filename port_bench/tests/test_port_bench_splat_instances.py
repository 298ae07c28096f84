"""The reader of the program's "splat_instances" counter
(metrics/splat_instances_m.train.py): millions per iteration on a
hand-built store, a positive number on a traced toy run of the
`nuscenes-train` cell, and None (never 0) on a store whose iterations do
not carry the counter, as the program before the counter leaves it."""

import types

import pytest

from conftest import toy_run

NAME = "splat_instances_m.train"
MS = 1_000_000


@pytest.fixture
def store():
    from adgs_tpu_torch import profiling
    profiling.reset()
    yield profiling
    profiling.reset()


def _reader():
    from port_bench import harness
    return harness.metric_readers()[NAME]


def _iteration(p, t0, number, read_counts):
    root = p.Span("trainer.iteration", number)
    read = p.Span("trainer.read")
    root.start_ns, root.end_ns = t0, t0 + 10 * MS
    read.start_ns, read.end_ns, read.counts = t0 + 7 * MS, t0 + 8 * MS, \
        read_counts
    read.parent = root
    root.children.append(read)
    return root


def _run(driver="train"):
    return types.SimpleNamespace(data={"driver": driver})


def test_reads_millions_per_iteration(store):
    for i, n in enumerate((1_200_000, 1_300_000)):
        store._state.roots.append(_iteration(
            store, 100 * i * MS, 5300 + i,
            {"host_syncs": 2, "splat_instances": n}))
    assert _reader().read(_run()) == pytest.approx(1.25)
    assert _reader().read(_run("render")) is None


def test_a_program_without_the_counter_reads_nothing(store):
    assert _reader().read(_run()) is None
    for i in range(2):
        store._state.roots.append(_iteration(store, 100 * i * MS, 5300 + i,
                                             {"host_syncs": 2}))
    assert _reader().read(_run()) is None


def test_traced_toy_run_of_the_nuscenes_cell(store):
    from port_bench import harness
    run = toy_run("nuscenes-train", seconds=5.0, trace=True)
    line = harness.result_line(run)
    assert line["correct"] is True, line["checks"]
    got = line["metrics"][NAME]
    assert got["unit"] == "M"
    assert got["value"] > 0
