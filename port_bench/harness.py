"""The benchmark's harness: finds a cell, its configuration, its traffic
and the per-layer metrics by name (one file each under this folder), runs
the traffic's driver on the card and prints the result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell is workloads/<cell>.json: its configuration (configs/<name>.json),
its traffic (traffic/<name>.json, whose "driver" names drivers/<d>.py)
and the limits of the numbers that decide `correct`. A per-layer metric
is metrics/<metric>.py with UNIT and read(run) -> number or None. A later
change adds a cell or a metric by adding files.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def sync(dev) -> None:
    """Wait for the card (nothing on the CPU)."""
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def window_halves_ms(t0: float, ends: list) -> list:
    """ms per unit in the first and in the second half of the window's
    units (a reading for stderr: whether a run's speed moves within the
    window or only from run to run)."""
    h = len(ends) // 2
    if h == 0:
        return []
    return [1e3 * (ends[h - 1] - t0) / h,
            1e3 * (ends[-1] - ends[h - 1]) / (len(ends) - h)]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str, root: Path = HERE):
    """(cell, configuration, traffic) dicts of a cell, by name."""
    cell = load_json(root / "workloads" / f"{workload}.json")
    spec = load_json(root / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    return cell, spec, traffic


def metric_readers(root: Path = HERE) -> dict:
    """{metric name: module} of every metrics/<name>.py."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = path.name[:-3]
        spec = importlib.util.spec_from_file_location(
            f"port_bench.metrics.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


class Run:
    """One run of a cell: its inputs, and what the driver and the readers
    leave for the result line."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device, t_start: float, overrides=None):
        self.workload = workload
        self.cell, self.spec, self.traffic = cell_files(workload)
        for part, values in (overrides or {}).items():
            getattr(self, part).update(values)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), \
            bool(trace)
        self.device, self.t_start = device, t_start
        self.tmp_dir = tempfile.mkdtemp(prefix="port_bench_")
        self.e2e: dict = {}          # name -> (value, unit)
        self.checks: list = []       # (name, value, limit)
        self.data: dict = {}         # what the per-layer readers read
        self.setup_s = None
        self.attempted = self.failed = 0
        self.memory_peak_bytes = 0
        self.busy_s = self.window_s = None
        self.breakdown = None
        self.phases: list = []       # (set-up phase, seconds since start)

    def phase(self, name: str) -> None:
        """Note the end of a set-up phase (printed on standard error)."""
        self.phases.append((name, time.perf_counter() - self.t_start))

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return (bool(self.checks) and self.failed == 0
                and all(math.isfinite(v) and v <= lim
                        for _, v, lim in self.checks))

    def close(self) -> None:
        shutil.rmtree(self.tmp_dir, ignore_errors=True)


def drive(run: Run) -> None:
    """Set-up, window and reference of the cell's traffic."""
    driver = importlib.import_module(
        f"port_bench.drivers.{run.traffic['driver']}")
    driver.run(run)
    if run.setup_s is not None:
        run.e2e["setup_s"] = (run.setup_s, "s")


def per_layer(run: Run) -> dict:
    out = {}
    for name, mod in metric_readers().items():
        value = mod.read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


def result_line(run: Run) -> dict:
    import torch
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": int(run.cell.get("chips", 1)),
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace:
        metrics = per_layer(run)
        if run.busy_s is not None:
            device.update(busy_s=run.busy_s, window_s=run.window_s)
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in run.e2e.items()}
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.breakdown:
        line["breakdown"] = run.breakdown
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in run.checks}
    return line


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from . import guards
    bad = guards.reference_import_faults()
    if bad:
        print("the reference imports what it may not: " + "; ".join(bad),
              file=sys.stderr)
        return 4
    cell = load_json(HERE / "workloads" / f"{args.workload}.json")
    chips = int(cell.get("chips", 1))

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace), dev,
              t_start)
    try:
        drive(run)
        leaks = guards.reference_leaks() + guards.forbidden_modules()
        if leaks:
            print("import guard: " + "; ".join(leaks), file=sys.stderr)
            return 5
        line = result_line(run)
    finally:
        run.close()
    if "readings" in run.data:
        print("readings: " + json.dumps(run.data["readings"]),
              file=sys.stderr)
    print("set-up phases (s since start): " + ", ".join(
        f"{n} {t:.3f}" for n, t in run.phases), file=sys.stderr)
    for key in ("instance_capacity", "max_num_rendered",
                "max_num_rendered_by_camera", "window_steps",
                "window_refreshes", "window_densifies", "window_frames",
                "first_window_iteration", "window_halves_ms",
                "compared_frames", "reference_s"):
        if key in run.data:
            print(f"{key}: {run.data[key]}", file=sys.stderr)
    for name, value, limit in run.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0
