"""A camera rig served as one frame (render.make_staged_render_fn with a
sequence of cameras at one time), on the CPU, on port_bench/tests/
conftest.py's toy three-camera rig (RIG: yaws 0, +55 and -55 degrees,
three intrinsics, the surround cloud) at 64x48:

  - each camera of the rig call is bitwise the same camera served alone
    at the same time, every output of render() included;
  - the rig against the frozen plain reference (port_bench/reference/
    render_rig_ref.py, one plain deformation a camera), within the
    `nuscenes-render` cell's limits;
  - one "render.deform" a "serve.frame", and one "render.camera" a
    camera, numbered by its place; the counters frame_cameras and
    frame_deforms read 3 and 1 for the rig, 1 and 1 for a camera alone;
  - with every tensor routed to the kernels and each launch recorded
    (tests/test_torch_dispatch.py's `routed`), the rig launches T1 once
    and each camera's kernels once a camera, and a single camera launches
    what render() launches;
  - the committed `nuscenes-render` cell at the toy size, its window
    closed by `window_frames`: `correct`."""

import importlib.util
import os
import time

import pytest
import torch

from adgs_tpu_torch import profiling
from adgs_tpu_torch.core.camera import Camera
from adgs_tpu_torch.models.env_map import EnvironmentMap, camera_rays
from adgs_tpu_torch.models.gaussians import (GaussianConfig, GaussianParams,
                                             GaussianState)
from adgs_tpu_torch.render import make_staged_render_fn, render
from tests.test_torch_dispatch import routed  # noqa: F401  (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "nuscenes-render"
SEED = 4_250_000_013
CAPACITY = 1 << 14


def _toy():
    """port_bench/tests/conftest.py as a module of its own name (this
    suite has a conftest of its own)."""
    spec = importlib.util.spec_from_file_location(
        "port_bench_toy", os.path.join(ROOT, "port_bench", "tests",
                                       "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rig():
    """(spec, the model, the rig's Views and Cameras at a training
    timestamp, each camera's sky rays) of the toy rig."""
    from port_bench import scene
    toy = _toy()
    spec = toy.toy_spec(toy.cell_spec("rig-render")[1])
    dev = torch.device("cpu")
    w = scene.make_weights(spec, SEED, dev)
    params = GaussianParams(**{n: w[n] for n in scene.LEAVES})
    zeros = torch.zeros(params.capacity)
    state = GaussianState(
        scene_alive=w["scene_alive"], obj_alive=w["obj_alive"],
        gs_time=w["gs_time"], max_radii2d=zeros, xyz_grad_accum=zeros,
        denom=zeros, obj_near_idx=torch.zeros((1, 1), dtype=torch.int32),
        obj_near_valid=torch.zeros((1,), dtype=torch.bool))
    env = EnvironmentMap(grid=w["env"])
    cfg = GaussianConfig.from_order_args(
        spec["order_args"], scene.scene_frame_num(spec), 3,
        sh_degree=int(spec["sh_degree"]), use_time_mask=True)
    views = scene.views(spec)[3:6]     # timestamp 1, cameras 0, 1, 2
    assert len({v.time for v in views}) == 1
    assert [v.cam_id for v in views] == [0, 1, 2]
    cams = [Camera.create(R=v.R, T=v.T, fovx=v.fovx, fovy=v.fovy,
                          width=v.width, height=v.height, time=v.time,
                          device=dev)
            for v in views]
    rays = [torch.as_tensor(camera_rays(c.focal_x, c.height, c.width),
                            dtype=torch.float32) for c in cams]
    return spec, (params, state, env, cfg), views, cams, rays


def _fn(model):
    params, state, env, cfg = model
    return make_staged_render_fn(cfg, active_sh_degree=cfg.sh_degree,
                                 capacity=CAPACITY)


def _same(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), (where, k)
        else:
            assert a[k] == b[k], (where, k)


def test_rig_is_bitwise_each_camera_alone(rig):
    _, model, _, cams, rays = rig
    params, state, env, _ = model
    fn = _fn(model)
    outs = fn(cams, params, state, env, rays)
    assert isinstance(outs, list) and len(outs) == 3
    for k, (cam, r) in enumerate(zip(cams, rays)):
        _same(outs[k], fn(cam, params, state, env, r), k)
    # the cameras see different things: the rig is no copy of one camera
    assert not torch.equal(outs[0]["render"], outs[1]["render"])
    assert all(float(o["img_opacity"].max()) > 0.5 for o in outs)


def test_rig_matches_the_plain_reference(rig):
    from port_bench import harness, judge
    from port_bench.reference import render_rig_ref
    spec, model, views, cams, rays = rig
    params, state, env, _ = model
    outs = _fn(model)(cams, params, state, env, rays)
    ref = render_rig_ref.render(spec, {"capacity_factor": 1}, SEED,
                                torch.device("cpu"), [views])
    got = judge.render([torch.clamp(o["render"], 0.0, 1.0) for o in outs],
                       ref)
    limits = harness.cell_files(CELL)[0]["limits"]
    assert set(got) == set(limits)
    for name, value in got.items():
        assert value <= limits[name], (name, value)


def test_one_deform_a_frame_and_the_counters(rig):
    _, model, _, cams, rays = rig
    params, state, env, _ = model
    fn = _fn(model)
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        fn(cams, params, state, env, rays)
        fn(cams[1], params, state, env, rays[1])
    roots = profiling.roots()
    profiling.reset()
    assert [r.name for r in roots] == ["serve.frame"] * 2
    for root, n_cam in zip(roots, (3, 1)):
        assert root.counts == {"frame_cameras": n_cam, "frame_deforms": 1}
        assert [(c.name, c.number) for c in root.children] == \
            [("render.deform", None)] + [("render.camera", k)
                                          for k in range(n_cam)]
        for cam in root.children[1:]:
            assert [c.name for c in cam.children] == [
                "render.preprocess", "render.binning", "render.compositing",
                "render.sky"]


def test_launches_of_a_rig_and_of_a_camera(rig, routed):  # noqa: F811
    _, model, _, cams, rays = rig
    params, state, env, cfg = model
    fn = _fn(model)
    with torch.no_grad():
        render(cams[0], params, state, cfg, env_map=env, cam_rays=rays[0],
               active_sh_degree=cfg.sh_degree, capacity=CAPACITY)
    alone = list(routed)
    assert alone[0] == "deform" and alone.count("deform") == 1
    routed.clear()
    fn(cams[0], params, state, env, rays[0])
    assert routed == alone
    routed.clear()
    fn(cams, params, state, env, rays)
    assert routed == alone + alone[1:] * 2


def test_toy_cell_run_is_correct():
    """The committed cell at the toy size, its window closed after 6 rig
    frames (the sampled frames lie among the first 5). Two threads."""
    from port_bench import harness
    toy = _toy()
    _, full, _ = harness.cell_files(CELL)
    traffic = dict(toy.TOY_TRAFFIC["render"], window_frames=6)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        run = harness.Run(CELL, SEED, 60.0, False, torch.device("cpu"),
                          time.perf_counter(),
                          overrides=dict(spec=toy.toy_spec(full),
                                         traffic=traffic))
        try:
            harness.drive(run)
        finally:
            run.close()
    finally:
        torch.set_num_threads(threads)
    line = harness.result_line(run)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(run.cell["limits"])
    assert run.data["window_frames"] == 6
    assert run.data["compared_frames"] == 4   # 3 sampled and the last
    assert run.data["driver"] == "render"
    assert set(line["metrics"]) == {"render_ms_per_frame", "render_p95_ms",
                                    "setup_s"}
