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
# a three-camera rig shaped as nuScenes' front cameras (front, left,
# right; yaws 0, +55, -55 degrees; intrinsics of their size on 1600 x 900)
# around the surround cloud, run as kitti-75's cells (the nuScenes preset
# has kitti-75's order args); toy_run takes "rig-train" and "rig-render"
RIG = dict(num_cam=3, cloud="surround", width=1600, height=900, rig=[
    dict(yaw_deg=0.0, forward=1.70, left=0.016,
         fx=1266.4, fy=1266.4, cx=816.3, cy=491.5),
    dict(yaw_deg=55.0, forward=1.52, left=0.495,
         fx=1272.6, fy=1272.6, cx=826.6, cy=479.8),
    dict(yaw_deg=-55.0, forward=1.52, left=-0.494,
         fx=1260.8, fy=1260.8, cx=808.0, cy=495.3)])
RIG_CELLS = {"rig-train": ("kitti75-train", RIG),
             "rig-render": ("kitti75-render", RIG)}
TOY_TRAFFIC = {
    "train": dict(warmup_steps=2, init_points=16, profile_steps=2),
    "render": dict(interp_frames=10, warmup_frames=2, sample_within=5,
                   sample_frames=3, profile_frames=3),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips elsewhere")


def toy_spec(spec: dict) -> dict:
    """The configuration at TOY_SPEC's size. A rig's fx and cx are scaled
    by the ratio of the widths, its fy and cy by that of the heights, so
    every camera keeps its FoVs (fovx = 2 atan(cx / fx)) on the smaller
    image; TOY_SPEC's `focal` is for configurations without a rig."""
    out = dict(spec, **TOY_SPEC)
    if "rig" in spec:
        sx = TOY_SPEC["width"] / spec["width"]
        sy = TOY_SPEC["height"] / spec["height"]
        out["rig"] = [dict(c, fx=c["fx"] * sx, cx=c["cx"] * sx,
                           fy=c["fy"] * sy, cy=c["cy"] * sy)
                      for c in spec["rig"]]
    return out


def cell_spec(workload: str) -> tuple:
    """(the committed cell it runs as, its configuration at full size) of a
    cell or of a rig case."""
    from port_bench import harness
    cell, extra = RIG_CELLS.get(workload, (workload, {}))
    return cell, dict(harness.cell_files(cell)[1], **extra)


def toy_run(workload: str, seconds: float = 5.0, trace: bool = False,
            seed: int = 2 ** 31 + 7):
    """A harness Run of the cell (or rig case) at the toy size on the CPU,
    driven."""
    import torch
    from port_bench import harness
    cell, spec = cell_spec(workload)
    driver = harness.cell_files(cell)[2]["driver"]
    run = harness.Run(cell, seed, seconds, trace, torch.device("cpu"),
                      time.perf_counter(),
                      overrides=dict(spec=toy_spec(spec),
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
