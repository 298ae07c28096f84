"""The port's trainer (adgs_tpu_torch/train/trainer.py), cli.train and
profiling on the CPU:
  - the schedule against the JAX package's Trainer on
    tests/test_data_cli.py's synthetic KITTI scene (three flow packages a
    frame), with the step, densify, opacity reset and KNN refresh stubbed
    in both packages the same way: camera picks, flow packages, SH degree,
    densify / reset / refresh iterations, instance-capacity rebuilds and
    Gaussian-capacity growths, event for event, over 2100 iterations;
  - the host KNN refresh (ADGS_KNN_HOST=1) bitwise JAX's;
  - cli.train then cli.render --device cpu on the 64x48 scene with smooth
    images: test PSNR rises by 1 dB, the loss falls, densify and refresh
    run, and cli.render's PSNR of the checkpoint equals the trainer's;
  - the overflow guard (as tests/test_data_cli.py::TestCapacityAutotune)
    and the failure snapshot (::TestFailureSnapshot);
  - a densify that adds Gaussians grows the instance capacity before the
    step after it can overflow (a difference from the JAX trainer);
  - multi-device arguments refused without a process group,
    profiling.trace with the program's spans in its trace."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adgs_tpu.data.readers import read_scene as jread_scene
from adgs_tpu.train import densify as jdensify
from adgs_tpu.train.config import OptimizationConfig as JOpt
from adgs_tpu.train.trainer import Trainer as JTrainer
from adgs_tpu_torch import profiling
from adgs_tpu_torch.cli import common as tcommon
from adgs_tpu_torch.data.readers import read_scene
from adgs_tpu_torch.train import checkpoint as tckpt
from adgs_tpu_torch.train import densify as tdensify
from adgs_tpu_torch.train.config import OptimizationConfig
from adgs_tpu_torch.train.optim import TrainableState
from adgs_tpu_torch.train.trainer import Trainer
from adgs_tpu_torch import render as render_lib
from tests.test_data_cli import make_kitti_scene

ORDER = dict(xyz=[4, 2, 0, 2, 0, 0], rotation=[0, 0, 0, 0, 4, 2],
             shs=[0, 0, 0, 2, 0, 0], background=[0, 0, 0, 0, 0, 0])
W, H = 64, 48


def _scene_with_flows(root):
    """make_kitti_scene with three flow packages a frame (distinct
    times), so that the flow choice draws from the trainer's rng."""
    make_kitti_scene(root, width=W, height=H)
    d = os.path.join(root, "flow", "nvs-75")
    for f in sorted(os.listdir(d)):
        (pkg,) = list(np.load(os.path.join(d, f), allow_pickle=True)["flow"])
        pkgs = [[np.float64(pkg[0] + 0.25 * i)] + list(pkg[1:])
                for i in range(3)]
        arr = np.empty(3, dtype=object)
        arr[:] = pkgs
        np.savez(os.path.join(d, f), flow=arr)
    return root


SCHED = dict(iterations=2100, densify_from_iter=150, densify_until_iter=1500,
             densification_interval=100, opacity_reset_interval=300,
             near_idx_reset_interval=50)


def _num_rendered(it):
    """Scripted num_rendered: overflows 2048 at it 275 (the per-step
    guard), passes 0.97 of 4096 before the periodic check at 1300."""
    return 1500 + 2 * it


def _instrument(tr, densify_mod, monkeypatch, ones_like, events):
    """Stub the step, densify, reset and refresh of one package's trainer
    and record what the schedule does."""
    def step(params, env, opt_state, state, cam, batch, rays, it,
             active_sh_degree=3):
        it = int(it)
        events.append(("step", it, active_sh_degree))
        return (params, env, opt_state, state,
                {"total_loss": 1.0, "num_rendered": _num_rendered(it)})

    def build():
        events.append(("build", tr.iteration, tr.capacity))
        tr._step_fn = step

    frames = tr._frames_for_step

    def frames_for_step(picks, opt):
        cam, batch, rays = frames(picks, opt)
        flow_t = (None if batch.flow is None
                  else float(np.float32(batch.flow.time)))
        events.append(("picks", tr.iteration, tuple(picks), flow_t))
        return cam, batch, rays

    n_densify = []

    def densify(trainables, opt_state, state, rand, *args):
        n_densify.append(1)
        events.append(("densify", tr.iteration, bool(args[3]), args[:3]))
        if len(n_densify) == 2:      # fill both blocks: capacities grow
            state = dataclasses.replace(
                state, scene_alive=ones_like(state.scene_alive),
                obj_alive=ones_like(state.obj_alive))
        # a report of no clone, split, prune or drop
        zero = ones_like(state.scene_alive[:0]).sum()
        return (trainables, opt_state, state,
                densify_mod.DensifyReport(*[zero] * 8))

    def reset(trainables, opt_state):
        events.append(("reset", tr.iteration))
        return trainables, opt_state

    grow = densify_mod.grow_capacity

    def grow_capacity(trainables, opt_state, state, ns, no):
        g = trainables.gaussians
        events.append(("grow", tr.iteration, g.scene_capacity,
                       g.obj_capacity, ns, no))
        return grow(trainables, opt_state, state, ns, no)

    tr._build_step = build
    tr._frames_for_step = frames_for_step
    tr.refresh_near_idx = lambda: events.append(("refresh", tr.iteration))
    monkeypatch.setattr(densify_mod, "densify_and_prune", densify)
    monkeypatch.setattr(densify_mod, "reset_opacity", reset)
    monkeypatch.setattr(densify_mod, "grow_capacity", grow_capacity)


def test_schedule_matches_jax_trainer(tmp_path, monkeypatch):
    root = _scene_with_flows(str(tmp_path / "scene"))
    kw = dict(order_args=ORDER, env_resolution=32, capacity=2048,
              capacity_quantum=256, seed=3)
    runs = {}
    for name in ("jax", "torch"):
        events = []
        if name == "jax":
            tr = JTrainer(jread_scene(root, seed=3), JOpt(**SCHED),
                          str(tmp_path / "jax"), **kw)
            _instrument(tr, jdensify, monkeypatch, jnp.ones_like, events)
        else:
            tr = Trainer(read_scene(root, seed=3), OptimizationConfig(**SCHED),
                         str(tmp_path / "torch"), device="cpu", **kw)
            _instrument(tr, tdensify, monkeypatch, torch.ones_like, events)
        n = SCHED["iterations"]
        tr.train(iterations=n, save_iterations=[n + 1],
                 test_iterations=[n + 1])
        runs[name] = (events, tr.capacity, tr.params.scene_capacity,
                      tr.params.obj_capacity, tr.active_sh_degree)
    j_events, t_events = runs["jax"][0], runs["torch"][0]
    assert len(t_events) == len(j_events)
    for a, b in zip(t_events, j_events):
        assert a == b
    assert runs["torch"][1:] == runs["jax"][1:]
    kinds = {e[0] for e in t_events}
    assert kinds == {"step", "build", "picks", "densify", "reset", "refresh",
                     "grow"}
    builds = [e for e in t_events if e[0] == "build"]
    assert [b[2] for b in builds] == [2048, 4096, 8192]   # guard, periodic
    assert runs["torch"][4] == 2
    # every train frame had each of its three flow packages drawn
    drawn = {}
    for e in t_events:
        if e[0] == "picks":
            drawn.setdefault(e[2], set()).add(e[3])
    assert len(drawn) == 10 and all(len(v) == 3 for v in drawn.values())


def test_host_knn_refresh_matches_jax(tmp_path, monkeypatch):
    """ADGS_KNN_HOST=1: the exact scipy refresh on np_rng's anchors gives
    JAX's groups bitwise."""
    monkeypatch.setenv("ADGS_KNN_HOST", "1")
    root = make_kitti_scene(str(tmp_path / "scene"), width=W, height=H,
                            n_pts=600)
    kw = dict(order_args=ORDER, env_resolution=32, capacity_quantum=256,
              seed=1)
    jt = JTrainer(jread_scene(root), JOpt(near_num=4), str(tmp_path / "j"),
                  **kw)
    tt = Trainer(read_scene(root), OptimizationConfig(near_num=4),
                 str(tmp_path / "t"), device="cpu", **kw)
    for _ in range(2):
        jt.refresh_near_idx()
        tt.refresh_near_idx()
        np.testing.assert_array_equal(tt.state.obj_near_idx.numpy(),
                                      np.asarray(jt.state.obj_near_idx))
        np.testing.assert_array_equal(tt.state.obj_near_valid.numpy(),
                                      np.asarray(jt.state.obj_near_valid))
    assert tt.state.obj_near_valid.sum() > 0
    tt.close()


def _smooth_images(root):
    """Replace the scene's noise images by one smooth gradient, which a
    few steps can fit."""
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([xx / W, yy / H, 0.5 * np.ones_like(xx)], -1)
    d = os.path.join(root, "image")
    for f in os.listdir(d):
        Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(d, f))


def _no_lpips(monkeypatch, tmp_path):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "no_torch_home"))
    monkeypatch.setenv("ADGS_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))


def test_cli_train_then_render(tmp_path, monkeypatch, capsys):
    from adgs_tpu_torch.cli import render as render_cli
    from adgs_tpu_torch.cli import train as train_cli
    _no_lpips(monkeypatch, tmp_path)
    root = make_kitti_scene(str(tmp_path / "scene"), width=W, height=H)
    _smooth_images(root)
    out = str(tmp_path / "out")
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "iterations = 20\n"
        "env_resolution = 32\n"
        "capacity = 8192\n"
        "densification_interval = 6\n"
        "near_idx_reset_interval = 5\n"
        "densify_scene_grad_threshold = 1e-6\n"
        "densify_obj_grad_threshold = 1e-6\n"
        f"order_args = {ORDER!r}\n")
    calls = []
    for name in ("densify_and_prune", "reset_opacity"):
        real = getattr(tdensify, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)
        monkeypatch.setattr(tdensify, name, spy)
    tr = train_cli.main(["-s", root, "-m", out, "-c", str(cfg),
                         "--test_iterations", "1", "--device", "cpu"])
    assert tr.device.type == "cpu" and tr.layout == "gather"
    assert calls.count("densify_and_prune") == 3     # iterations 6, 12, 18
    assert int(tr.state.obj_near_valid.sum()) > 0
    base = os.path.join(out, "point_cloud", "iteration_20")
    for f in ("point_cloud.ply", "deform.npz", "env.npy", "train_state.npz"):
        assert os.path.exists(os.path.join(base, f)), f
    recs = [json.loads(line) for line in open(os.path.join(out,
                                                           "metrics.jsonl"))]
    psnr = {r["step"]: r["psnr"] for r in recs if r["split"] == "test"}
    loss = {r["step"]: r["total_loss"] for r in recs if "total_loss" in r}
    assert psnr[20] > psnr[1] + 1.0, psnr
    assert loss[20] < loss[10], loss
    assert all(np.isfinite(v) for v in loss.values())

    render_cli.main(["-m", out, "--skip_train", "--device", "cpu"])
    res = json.load(open(os.path.join(out, "results.json")))["ours_20"]
    np.testing.assert_allclose(res["PSNR"], psnr[20], rtol=0, atol=1e-3)
    model_cfg, _ = tcommon.load_cfg_args(out)
    assert model_cfg.capacity == tr.capacity


def test_overflow_grows_instance_capacity(tmp_path):
    """An undersized instance capacity is grown from num_rendered, and the
    grown capacity renders as a generous one does."""
    root = make_kitti_scene(str(tmp_path / "scene"), width=W, height=H)
    opt = OptimizationConfig(
        iterations=4, densification_interval=2, lambda_flow=0.0,
        lambda_reg=0.0, lambda_sigma_reg=0.0, densify_from_iter=100)
    tr = Trainer(read_scene(root), opt, str(tmp_path / "out"), capacity=512,
                 env_resolution=32, capacity_quantum=1024, order_args=ORDER,
                 device="cpu")
    tr.train(iterations=4, save_iterations=[5], test_iterations=[5])
    grown = tr.capacity
    assert grown > 512, "overflowed capacity was not grown"
    cam, _, _ = tr._get_frame("train", 0)
    out_g = render_lib.render(cam, tr.params, tr.state, tr.config,
                              capacity=grown)
    out_big = render_lib.render(cam, tr.params, tr.state, tr.config,
                                capacity=1 << 15)
    np.testing.assert_allclose(out_g["render"].numpy(),
                               out_big["render"].numpy(), rtol=1e-5,
                               atol=1e-5)
    tr.close()


def test_step_failure_dumps_repro_state(tmp_path):
    root = make_kitti_scene(str(tmp_path / "scene"), width=W, height=H)
    opt = OptimizationConfig(iterations=3, lambda_flow=0.0,
                             densify_from_iter=100)
    out = str(tmp_path / "out")
    tr = Trainer(read_scene(root), opt, out, capacity=2048,
                 env_resolution=32, device="cpu")
    tr._build_step()

    def boom(*a, **k):
        raise RuntimeError("injected kernel fault")
    tr._step_fn = boom
    with pytest.raises(RuntimeError, match="injected"):
        tr.train(iterations=2, save_iterations=[3], test_iterations=[3])
    snaps = [f for f in os.listdir(out) if f.startswith("snapshot_fail_")]
    assert snaps, "no failure snapshot written"
    path = os.path.join(out, snaps[0])
    _, _, _, it = tckpt.load_state(path, TrainableState(tr.params, tr.env),
                                   tr.opt_state, tr.state)
    assert it >= 1
    with np.load(path) as z:
        assert "extra.failed_frame_idx" in z
        assert int(z["extra.instance_capacity"]) == 2048
    tr.close()


@pytest.mark.parametrize("arg", ["devices", "batch_cameras"])
def test_multi_device_refused(tmp_path, arg):
    """A multi-device Trainer needs the ranks' process group: without it,
    it refuses (cli.train starts and joins the ranks)."""
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(None, OptimizationConfig(), str(tmp_path), **{arg: 2})


def test_layout_from_env(monkeypatch):
    monkeypatch.delenv("ADGS_RM", raising=False)
    assert tcommon.layout_from_env() == "gather"
    monkeypatch.setenv("ADGS_RM", "1")
    assert tcommon.layout_from_env() == "rows"


def test_profiling_trace_and_timer(tmp_path):
    """profiling.trace writes one Chrome trace; the program's spans opened
    inside it lie in that trace as ranges, nested as they were opened,
    and their counters reach summary()."""
    profiling.reset()
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("serve.frame", 3):
            with profiling.span("render.deform"):
                torch.ones(64).sum()
                profiling.count("host_syncs", 2)
    (f,) = os.listdir(tmp_path / "prof")
    assert f.endswith(".json")
    events = json.load(open(tmp_path / "prof" / f))["traceEvents"]
    got = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation"}
    outer, inner = got["serve.frame"], got["render.deform"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    (root,) = profiling.roots()
    assert root.number == 3 and root.children[0].name == "render.deform"
    s = profiling.summary()["serve.frame"]
    assert s["roots"] == 1
    assert s["spans"]["serve.frame"]["counts"] == {"host_syncs": 2}
    profiling.reset()


def test_growing_densify_grows_instance_capacity_ahead(tmp_path,
                                                       monkeypatch):
    """A densify that adds Gaussians sizes the instance capacity for the
    largest num_rendered since the last densify, grown as the alive count
    grew, before the next step: no step after it overflows (the JAX
    trainer grows on an overflow or at the next interval). A densify that
    adds nothing leaves the capacity alone. Step, densify and refresh
    stubbed: num_rendered 3400 before the densify at 4 (under 0.97 of
    4096), which adds a third of the alive Gaussians."""
    root = make_kitti_scene(str(tmp_path / "scene"), width=W, height=H)
    opt = OptimizationConfig(densification_interval=4, densify_from_iter=0,
                             lambda_flow=0.0)
    tr = Trainer(read_scene(root), opt, str(tmp_path / "out"),
                 order_args=ORDER, env_resolution=32, capacity=4096,
                 capacity_quantum=256, device="cpu")
    alive0 = int(tr.state.num_scene) + int(tr.state.num_obj)
    ran, builds, densified = [], [], []

    def step(params, env, opt_state, state, cam, batch, rays, it,
             active_sh_degree=3):
        alive = int(state.num_scene) + int(state.num_obj)
        nr = 3400 * alive // alive0 - 5 * (it % 4)
        ran.append((int(it), nr, tr.capacity))
        return (params, env, opt_state, state,
                {"total_loss": torch.tensor(1.0),
                 "num_rendered": torch.tensor(nr)})

    def build():
        builds.append((tr.iteration, tr.capacity))
        tr._step_fn = step

    def densify(trainables, opt_state, state, generator, *args):
        added = alive0 // 3 if not densified else 0
        densified.append(added)
        dead = torch.nonzero(~state.scene_alive)[:added, 0]
        alive = state.scene_alive.clone()
        alive[dead] = True
        zero = torch.zeros((), dtype=torch.int64)
        report = tdensify.DensifyReport(
            torch.tensor(added), *[zero] * 7)
        return (trainables, opt_state,
                dataclasses.replace(state, scene_alive=alive), report)

    tr._build_step = build
    monkeypatch.setattr(tr, "refresh_near_idx", lambda: None)
    monkeypatch.setattr(tdensify, "densify_and_prune", densify)
    tr.train(iterations=10, save_iterations=[99], test_iterations=[99])
    tr.close()
    assert densified == [alive0 // 3, 0]
    assert builds == [(0, 4096), (4, 8192)]
    assert [it for it, _, _ in ran] == list(range(1, 11))
    assert all(nr <= cap for _, nr, cap in ran)
    assert max(nr for it, nr, _ in ran if it > 4) > 4096
