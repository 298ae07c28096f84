"""Each cell end to end at a toy size: set-up, window, the reference's
comparison, the result line and the per-layer readers."""

import json
import math

import pytest

from conftest import CELLS, toy_run

E2E = {"train": ("train_ms_per_step", "train_peak_gib", "setup_s"),
       "render": ("render_ms_per_frame", "render_p95_ms", "setup_s")}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct(workload):
    from port_bench import harness
    run = toy_run(workload)
    line = harness.result_line(run)
    driver = run.data["driver"]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == set(E2E[driver])
    assert all(math.isfinite(m["value"]) and m["value"] >= 0
               for m in line["metrics"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    json.dumps(line)


@pytest.mark.parametrize("workload", ("kitti75-train", "kitti75-render"))
def test_traced_run_reads_host_metrics(workload):
    """On the CPU a traced run has no device events: the device readers
    find nothing and leave their metrics out; the host's remain."""
    from port_bench import harness
    run = toy_run(workload, seconds=5.0, trace=True)
    line = harness.result_line(run)
    assert line["correct"] is True
    names = set(line["metrics"])
    assert not any(n.startswith(("device_idle", "kernel_roofline"))
                   or n.endswith("mfu") for n in names)
    if run.data["driver"] == "train":
        assert "outside_step_ms.train" in names
