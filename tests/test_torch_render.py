"""The slice end to end: adgs_tpu_torch.render against
adgs_tpu.render.render(backend="pallas") on one KITTI-75 scene with an
environment map (1e-4), plus the port's device and import contracts."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu import render as jrender
from adgs_tpu.core.camera import Camera as JCamera
from adgs_tpu.models.env_map import EnvironmentMap as JEnv
from adgs_tpu.models.env_map import camera_rays
from adgs_tpu_torch import _kernels, convert
from adgs_tpu_torch import render as trender
from adgs_tpu_torch.core.camera import Camera as TCamera
from tests.test_torch_gaussians import _jax_model, _port_model

TOL = dict(rtol=1e-4, atol=1e-4)
# horizon-looking pose: camera +z -> world +x (the sky sits on the equator)
M = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("t", [0.2, 0.7])
def test_render_matches_jax(rng, t):
    cfg_j, params, state = _jax_model(rng, n=800)
    params = dataclasses.replace(
        params, scene_scaling=params.scene_scaling + 0.5,
        obj_scaling=params.obj_scaling + 0.5,
        scene_opacity=params.scene_opacity + 2.0,
        obj_opacity=params.obj_opacity + 2.0)
    cfg, tp, ts = _port_model(cfg_j, params, state)
    w, h = 64, 48
    kw = dict(R=M, T=np.array([0.0, 0.0, 4.0]), fovx=1.2, fovy=0.9,
              width=w, height=h, time=t)
    jcam, tcam = JCamera.create(**kw), TCamera.create(device="cpu", **kw)
    rays = camera_rays(jcam.focal_x, h, w)
    from scipy.ndimage import zoom
    grid = zoom(rng.normal(size=(3, 16, 16)), (1, 16, 16),
                order=1).astype(np.float32)
    jenv = JEnv(grid=jnp.asarray(grid))
    tenv = convert.env_from_numpy(grid, device="cpu")

    ref = jrender.render(jcam, params, state, cfg_j, env_map=jenv,
                         cam_rays=jnp.asarray(rays), backend="pallas",
                         capacity=1 << 14)
    fn = trender.make_staged_render_fn(cfg, capacity=1 << 14)
    port = fn(tcam, tp, ts, tenv, torch.as_tensor(rays))
    for k in ("render", "foreground", "background", "depth", "img_opacity"):
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(port["radii"].numpy(),
                                  np.asarray(ref["radii"]))
    assert float(port["img_opacity"].max()) > 0.5   # the scene is on screen
    # the plain override agrees with the wrappers' CPU twins
    with _kernels.plain():
        plain = trender.make_staged_render_fn(cfg, capacity=1 << 14)(
            tcam, tp, ts, tenv, torch.as_tensor(rays))
    np.testing.assert_array_equal(plain["render"].numpy(),
                                  port["render"].numpy())


def test_served_frame_holds_no_graph(rng):
    """make_staged_render_fn serves under torch.no_grad(): with every
    weight requiring a gradient, no output of a served frame holds an
    autograd graph, while render() itself builds one (for training)."""
    cfg_j, params, state = _jax_model(rng, n=300)
    cfg, tp, ts = _port_model(cfg_j, params, state)
    tp = dataclasses.replace(tp, **{
        f.name: getattr(tp, f.name).requires_grad_(True)
        for f in dataclasses.fields(tp)})
    tenv = convert.env_from_numpy(rng.normal(size=(3, 32, 32)), device="cpu")
    tenv.grid.requires_grad_(True)
    kw = dict(R=M, T=np.array([0.0, 0.0, 4.0]), fovx=1.2, fovy=0.9,
              width=32, height=24, time=0.4)
    tcam = TCamera.create(device="cpu", **kw)
    rays = torch.as_tensor(camera_rays(tcam.focal_x, 24, 32))
    served = trender.make_staged_render_fn(cfg, capacity=1 << 14)(
        tcam, tp, ts, tenv, rays)
    tensors = {k: v for k, v in served.items() if torch.is_tensor(v)}
    assert "render" in tensors
    assert not any(v.requires_grad for v in tensors.values())
    trained = trender.render(tcam, tp, ts, cfg, env_map=tenv, cam_rays=rays,
                             capacity=1 << 14)
    assert trained["render"].requires_grad


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCamera.create(R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=1.0,
                       width=8, height=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.env_from_numpy(np.zeros((3, 4, 4), np.float32))
    # a kernel wrapper sent to its kernel refuses a tensor off the card
    from adgs_tpu_torch.ops.grid_sample import grid_sample
    monkeypatch.setattr(_kernels, "use", lambda t: True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        grid_sample(torch.zeros(3, 4, 4, device="meta"),
                    torch.zeros(2, 2, 2, device="meta"))


# modules the walk must reach (the evaluation entry point and its
# dependencies, and the lab), so that a package missing its __init__.py
# cannot drop out of the check unnoticed
NEEDED = ("cli.common", "cli.render", "cli.train", "data.colmap",
          "data.frames", "data.ply", "data.readers", "exp.lab_rowmajor",
          "ops.knn", "ops.lpips", "profiling", "train.checkpoint",
          "raster.render", "scripts.quality_gate", "train.densify",
          "train.step", "train.trainer", "data.tfrecord",
          "data.waymo_proto", "data.lidar", "geometry",
          "geometry.scene_meta", "geometry.segment",
          "geometry.pseudo_labels", "geometry.triangulate",
          "scripts.convert_kitti", "scripts.convert_waymo",
          "scripts.convert_nuscenes", "scripts.segment_pcd",
          "scripts.triangulate", "scripts.validate_scene",
          "scripts.generate_depth", "scripts.generate_flow",
          "scripts.generate_semantic", "scripts.bench_scaling", "parallel",
          "parallel.mesh", "parallel.collectives", "parallel.launch",
          "parallel.shard", "parallel.data_parallel")


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor
    adgs_tpu (nor does chip_smoke.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import adgs_tpu_torch\n"
        "names = {m.name for m in pkgutil.walk_packages("
        "adgs_tpu_torch.__path__, 'adgs_tpu_torch.')}\n"
        "for name in sorted(names):\n"
        "    importlib.import_module(name)\n"
        f"missing = sorted(set('adgs_tpu_torch.' + n for n in {NEEDED!r}) "
        "- names)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'adgs_tpu' or "
        "k.startswith('adgs_tpu.'))\n"
        "print('BAD', bad, 'MISSING', missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result on a machine
    without CUDA."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "kernels" not in r.stdout
