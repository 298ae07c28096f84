"""Cells, configurations, traffic and per-layer metrics are found by name
from their files: a new file adds a cell or a metric, and no file of the
harness is edited."""

import json
import shutil
from pathlib import Path

from conftest import CELLS, ROOT


def test_bench_cells_match_workload_files():
    from port_bench import harness
    bench = json.loads((Path(ROOT) / "BENCHMARK.json").read_text())
    names = {w["name"] for w in bench["workloads"]}
    assert names <= {p.stem for p in (harness.HERE / "workloads")
                     .glob("*.json")}
    for w in bench["workloads"]:
        cell, spec, traffic = harness.cell_files(w["name"])
        assert cell["config"] == w["config"] and spec["name"] == w["config"]
        assert cell["traffic"] == w["traffic"]
    per_layer = {m["name"] for m in bench["per_layer"]}
    assert per_layer == set(harness.metric_readers())


def test_new_files_add_a_cell_and_a_metric(tmp_path):
    from port_bench import harness
    root = tmp_path / "port_bench"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = json.loads((root / "workloads" / f"{CELLS[0]}.json").read_text())
    (root / "workloads" / "kitti75-train-slow.json").write_text(
        json.dumps(dict(cell, traffic="train-slow")))
    traffic = json.loads((root / "traffic" / "train.json").read_text())
    (root / "traffic" / "train-slow.json").write_text(
        json.dumps(dict(traffic, start_iteration=100)))
    (root / "metrics" / "steps.train.py").write_text(
        'UNIT = "1"\n\n\ndef read(run):\n'
        '    return run.data.get("window_steps")\n')
    c, s, t = harness.cell_files("kitti75-train-slow", root)
    assert t["start_iteration"] == 100 and s["name"] == cell["config"]
    readers = harness.metric_readers(root)
    assert "steps.train" in readers
    assert set(harness.metric_readers()) < set(readers)
