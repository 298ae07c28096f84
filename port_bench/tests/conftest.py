"""Shared set-up of the benchmark's tests: the cells at a toy size on the
CPU with the plain backend, driven through the harness's own functions
(never through the measuring command, which refuses the CPU)."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("kitti75-train", "waymo-train", "kitti75-render", "waymo-render")
TOY_SPEC = dict(gaussians=3000, width=64, height=48, focal=60.0,
                env_resolution=64, timestamps=8)
TOY_TRAFFIC = {
    "train": dict(warmup_steps=2, init_points=16, profile_steps=2),
    "render": dict(interp_frames=10, warmup_frames=2, sample_within=5,
                   sample_frames=3, profile_frames=3),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips elsewhere")


def toy_run(workload: str, seconds: float = 5.0, trace: bool = False,
            seed: int = 2 ** 31 + 7):
    """A harness Run of the cell at the toy size on the CPU, driven."""
    import torch
    from port_bench import harness
    driver = harness.cell_files(workload)[2]["driver"]
    run = harness.Run(workload, seed, seconds, trace, torch.device("cpu"),
                      time.perf_counter(),
                      overrides=dict(spec=dict(TOY_SPEC),
                                     traffic=dict(TOY_TRAFFIC[driver])))
    try:
        harness.drive(run)
    finally:
        run.close()
    return run


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32 and the hand kernels exist "
                    "only there)")
    return torch.device("cuda", 0)
