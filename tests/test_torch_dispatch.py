"""The one rule by which the port chooses between a hand kernel and its
plain twin (adgs_tpu_torch._kernels.use and plain()), on the CPU:
  - plain() nests, restores its state on exit, after an exception too,
    holds in every thread of the process, and keeps its count under
    threads that open and close it at once;
  - an autograd Function's backward follows its forward's decision, also
    when it runs on another thread with the override changed meanwhile;
  - the routing of a served frame (both layouts) and a training step:
    with `use` true outside plain() and each kernel's launch replaced by a
    recorder that runs its twin, the path goes through chip_smoke.py's
    SERVING_KERNELS / TRAINING_KERNELS, and through none under plain();
  - ModelConfig.backend's four names route a served frame the same way,
    and an unknown one raises.
No kernel is compiled here: the recorders stand in for the launches."""

import contextlib
import os
import sys
import threading
import types

import pytest
import torch

import chip_smoke
from adgs_tpu_torch import _kernels
from adgs_tpu_torch.cli import common as tcommon
from adgs_tpu_torch.data.readers import read_scene
from adgs_tpu_torch.models import gaussians as gm
from adgs_tpu_torch.ops import grid_sample as gs
from adgs_tpu_torch.raster import binning
from adgs_tpu_torch.raster import preprocess as prep
from adgs_tpu_torch.raster import render as rrender
from adgs_tpu_torch.render import make_staged_render_fn, render
from adgs_tpu_torch.train import losses
from adgs_tpu_torch.train.config import OptimizationConfig
from adgs_tpu_torch.train.optim import TrainableState, from_leaves, leaves
from adgs_tpu_torch.train.trainer import Trainer
from tests.test_data_cli import make_kitti_scene

ORDER = dict(xyz=[4, 2, 0, 2, 0, 0], rotation=[0, 0, 0, 0, 4, 2],
             shs=[0, 0, 0, 2, 0, 0], background=[0, 0, 0, 0, 0, 0])
CARD = types.SimpleNamespace(is_cuda=True)   # what use() reads of a tensor
BACKWARD_KERNELS = {"deform_bwd", "preprocess_bwd", "composite_bwd",
                    "segment_sum", "grid_sample_bwd"}


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """A Trainer on a 64x48 KITTI-format scene, its KNN groups set, and
    the (camera, batch, rays) of its first training frame."""
    tmp = tmp_path_factory.mktemp("dispatch")
    root = str(tmp / "scene")
    make_kitti_scene(root, width=64, height=48)
    tr = Trainer(read_scene(root), OptimizationConfig(), str(tmp / "out"),
                 order_args=ORDER, env_resolution=32, capacity=4096,
                 capacity_quantum=256, seed=1, device="cpu")
    tr._build_step()
    tr.refresh_near_idx()
    return tr, tr._frames_for_step([0], tr.opt)


def _p1_twin(means3d, scales, rotations, shs, screen_offset, opac, active,
             settings):
    """P1's outputs, as _preprocess_fwd returns them, from the plain
    version."""
    p = prep.preprocess_torch(means3d, scales, rotations, opac, shs,
                              settings, screen_offset=screen_offset,
                              active_mask=active)
    return (p.mean2d, p.depth, p.conic, p.rgb, p.radii, p.extent,
            p.rect_min, p.rect_max, p.tiles_touched, p.visible)


@pytest.fixture
def routed(monkeypatch):
    """`_kernels.use` reading every tensor as a CUDA one, and each kernel's
    launch replaced by a recorder that runs its twin; returns the list of
    kernels launched. A wrapper is replaced whole: the stand-in decides
    by `_kernels.use` as the wrapper does, then records the launch.
    adam_leaves, preprocess and deform decide and launch in one function,
    so they are recorded where they launch: P1 and P2 at _preprocess_fwd
    and _preprocess_bwd, T1 and T2 at _deform_fwd and _deform_bwd, Adam
    where it resolves its entry point, its outputs left unwritten (only
    the routing is checked)."""
    seen = []
    use = _kernels.use

    def wrapper(name, twin):
        def decide(*args, **kwargs):
            if _kernels.use(args[0]):
                seen.append(name)
            return twin(*args, **kwargs)
        return decide

    def launch(name, twin):
        def record(*args, **kwargs):
            seen.append(name)
            return twin(*args, **kwargs)
        return record

    def entry(name, symbol, signature):
        seen.append(name)
        return lambda *args: 0

    monkeypatch.setattr(_kernels, "use", lambda t: use(CARD))
    monkeypatch.setattr(_kernels, "entry", entry)
    monkeypatch.setattr(_kernels, "stream", lambda t: 0)
    for module, attr, name, twin in (
            (binning, "compact_live", "compact_live",
             binning.compact_live_torch),
            (binning, "expand", "expand", binning.expand_torch),
            (rrender, "composite_fwd", "composite_fwd",
             rrender.composite_fwd_torch),
            (rrender, "composite_bwd", "composite_bwd",
             rrender.composite_bwd_torch),
            (rrender, "segment_sum", "segment_sum",
             rrender.segment_sum_torch),
            (losses, "segment_sum", "segment_sum",
             rrender.segment_sum_torch),
            (rrender, "pad_to_lanes", "pad_lanes",
             rrender.pad_to_lanes_torch),
            (gs, "grid_sample", "grid_sample", gs.grid_sample_torch),
            (gs, "grid_sample_bwd", "grid_sample_bwd",
             gs.grid_sample_bwd_torch)):
        monkeypatch.setattr(module, attr, wrapper(name, twin))
    monkeypatch.setattr(prep, "_preprocess_fwd", launch("preprocess",
                                                        _p1_twin))
    monkeypatch.setattr(prep, "_preprocess_bwd", launch(
        "preprocess_bwd", prep.preprocess_bwd_torch))
    monkeypatch.setattr(gm, "_deform_fwd", launch("deform",
                                                  gm.deform_fwd_torch))
    monkeypatch.setattr(gm, "_deform_bwd", launch("deform_bwd",
                                                  gm.deform_bwd_torch))
    return seen


def _serve(tr, frame, layout="gather"):
    cam, _, rays = frame
    fn = make_staged_render_fn(tr.config, capacity=tr.capacity,
                               layout=layout)
    return fn(cam, tr.params, tr.state, tr.env, rays)


def _train(tr, frame, layout="gather"):
    tr.layout = layout
    tr._build_step()
    cam, batch, rays = frame
    return tr._step_fn(tr.params, tr.env, tr.opt_state, tr.state, cam,
                       batch, rays, 1, active_sh_degree=tr.active_sh_degree)


@pytest.mark.parametrize("exit_by", ["return", "exception"])
def test_plain_nests_and_restores(exit_by):
    """use() gives the kernel to a CUDA tensor and the twin to any other;
    plain() blocks nest, and each gives back the state it found, also
    when an exception leaves it."""
    assert _kernels.use(CARD) and not _kernels.use(torch.zeros(1))
    with _kernels.plain():
        assert not _kernels.use(CARD)
        try:
            with _kernels.plain():
                assert not _kernels.use(CARD) and _kernels._plain == 2
                if exit_by == "exception":
                    raise KeyError("inner")
        except KeyError:
            assert exit_by == "exception"
        assert not _kernels.use(CARD) and _kernels._plain == 1
    assert _kernels.use(CARD) and _kernels._plain == 0


def test_plain_holds_in_every_thread():
    """Process-wide: a block opened on one thread sends another thread's
    wrappers to their twins (autograd runs a CUDA backward on a thread of
    its own)."""
    got = {}

    def read(key):
        got[key] = _kernels.use(CARD)

    with _kernels.plain():
        t = threading.Thread(target=read, args=("inside",))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    t = threading.Thread(target=read, args=("after",))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert got == {"inside": False, "after": True}


def test_plain_count_survives_threads():
    """Threads (more than the cores) open and close plain() blocks at a
    short switch interval: the count ends at zero, which a lost update
    of it would break."""
    def churn():
        for _ in range(2000):
            with _kernels.plain():
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=churn)
                   for _ in range(2 * (os.cpu_count() or 4))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert _kernels._plain == 0 and _kernels.use(CARD)


@pytest.mark.parametrize("forward_plain", [False, True])
def test_backward_follows_forward(routed, trainer, forward_plain):
    """A frame's forward under one decision, its backward started on
    another thread under the other: the backward takes the kernels (B4,
    B5, B8, P2, T2) exactly when the forward did."""
    tr, (cam, batch, rays) = trainer
    trainables = TrainableState(gaussians=tr.params, env=tr.env)
    inputs = [x.detach().requires_grad_(True) for x in leaves(trainables)]
    t = from_leaves(trainables, inputs)
    so = torch.zeros((tr.params.capacity, 2), requires_grad=True)
    with _kernels.plain() if forward_plain else contextlib.nullcontext():
        pkg = render(cam, t.gaussians, tr.state, tr.config, env_map=t.env,
                     cam_rays=rays, flow_time=batch.flow.time,
                     render_objmask=True, screen_offset=so,
                     capacity=tr.capacity)
        total, _ = losses.compute_losses(
            pkg, batch, t.gaussians, tr.state, tr.config, tr.opt,
            tr.scene.frame_gap, tr.scene.scene_extent)
    forward = set(routed)
    routed.clear()
    errors = []

    def backward():
        try:
            total.backward(inputs=inputs + [so])
        except Exception as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)

    with contextlib.nullcontext() if forward_plain else _kernels.plain():
        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=120)
    assert not worker.is_alive() and not errors, errors
    if forward_plain:
        assert forward == set() and routed == []
    else:
        assert forward == set(chip_smoke.SERVING_KERNELS)
        assert set(routed) == BACKWARD_KERNELS
    assert so.grad is not None and bool(so.grad.abs().sum() > 0)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("path", ["serve", "serve_rows", "train"])
def test_routing(routed, trainer, path, plain):
    """The kernels a served frame and a training step go through, by
    name, as chip_smoke.py checks them on the card; none under plain()."""
    tr, frame = trainer
    want = {"serve": set(chip_smoke.SERVING_KERNELS),
            "serve_rows": set(chip_smoke.SERVING_KERNELS) | {"pad_lanes"},
            "train": set(chip_smoke.TRAINING_KERNELS)}[path]
    run = _train if path == "train" else _serve
    layout = "rows" if path == "serve_rows" else "gather"
    with _kernels.plain() if plain else contextlib.nullcontext():
        run(tr, frame, layout)
    assert set(routed) == (set() if plain else want)


@pytest.mark.parametrize("name", ["auto", "pallas", "xla", "reference",
                                  "mosaic"])
def test_model_config_backend(routed, trainer, name):
    """cfg_args.json's backend: "xla" and "reference" serve through the
    twins, "auto" and "pallas" through the kernels; others raise."""
    tr, frame = trainer
    if name == "mosaic":
        with pytest.raises(ValueError, match="unknown backend"):
            tcommon.backend_context(name)
        return
    with tcommon.backend_context(name):
        _serve(tr, frame)
    plain = name in ("xla", "reference")
    assert set(routed) == (set() if plain
                           else set(chip_smoke.SERVING_KERNELS))
    assert _kernels._plain == 0
