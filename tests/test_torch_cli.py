"""The port's evaluation entry point (cli/render.py, with cli/common.py)
against the JAX package's on one checkpoint directory: a model made by
JAX create_from_pcd from tests/test_data_cli.py's synthetic KITTI scene
(64x48), written with JAX save_ply, env.npy and save_cfg_args, untrained.
Each package renders a copy of it: results.json PSNR and SSIM agree within
1e-4 and every PNG pixel within 1; the port with ADGS_RM=1 (the rows
instance layout) writes PNGs bitwise equal to its default run; the deform,
time and env modes run and write their files, the env PLY within 1e-5 of
JAX's."""

import argparse
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from adgs_tpu.cli import common as jcommon
from adgs_tpu.cli import render as jrender_cli
from adgs_tpu.data.readers import read_scene
from adgs_tpu.models import gaussians as jgm
from adgs_tpu.models.env_map import EnvironmentMap
from adgs_tpu.ops.knn import mean_knn_sq_dist
from adgs_tpu.train import checkpoint as jckpt
from adgs_tpu.train.config import OptimizationConfig
from adgs_tpu_torch import _kernels
from adgs_tpu_torch.cli import common as tcommon
from adgs_tpu_torch.cli import render as trender_cli
from adgs_tpu_torch.data.ply import read_ply
from tests.test_data_cli import make_kitti_scene

ITER = 7
ORDER = dict(xyz=[4, 2, 0, 2, 0, 0], rotation=[0, 0, 0, 0, 4, 2],
             shs=[0, 0, 0, 2, 0, 0], background=[0, 0, 0, 0, 0, 0])


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """An untrained checkpoint directory as the JAX trainer lays it out."""
    tmp = tmp_path_factory.mktemp("cli")
    root = make_kitti_scene(str(tmp / "scene"), width=64, height=48)
    scene = read_scene(root)
    cfg = jgm.GaussianConfig.from_order_args(
        ORDER, int(round(1.0 / scene.frame_gap)), sh_degree=3)
    params, state = jgm.create_from_pcd(
        scene.points, scene.colors, scene.obj_id, scene.times, cfg,
        mean_knn_sq_dist(scene.points), capacity_quantum=256)
    # opaque enough to cover much of the frame
    params = jgm.GaussianParams(**{
        **{f: getattr(params, f) for f in params.__dataclass_fields__},
        "scene_opacity": params.scene_opacity + 3.0,
        "obj_opacity": params.obj_opacity + 3.0})
    out = str(tmp / "model")
    base = os.path.join(out, "point_cloud", f"iteration_{ITER}")
    jckpt.save_ply(os.path.join(base, "point_cloud.ply"), params, state, cfg)
    np.save(os.path.join(base, "env.npy"),
            np.asarray(EnvironmentMap.create(32, seed=3).grid) * 1e3)
    jcommon.save_cfg_args(out, jcommon.ModelConfig(
        source_path=root, model_path=out, capacity=1 << 14,
        max_per_tile=256, chunk=32, env_resolution=32, order_args=ORDER),
        OptimizationConfig())
    return out


def _copy(model_dir, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(model_dir, dst)
    return dst


def _no_lpips(monkeypatch, tmp_path):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "no_torch_home"))
    monkeypatch.setenv("ADGS_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))


def _pngs(model, split):
    d = os.path.join(model, split, f"ours_{ITER}")
    out = {}
    for kind in ("renders", "gt"):
        for f in sorted(os.listdir(os.path.join(d, kind))):
            out[f"{kind}/{f}"] = np.asarray(Image.open(os.path.join(d, kind,
                                                                    f)))
    return out


def _results(model, split):
    name = "results.json" if split == "test" else "results-train.json"
    with open(os.path.join(model, name)) as f:
        return json.load(f)[f"ours_{ITER}"]


def test_render_matches_jax(model_dir, tmp_path, monkeypatch):
    _no_lpips(monkeypatch, tmp_path)
    jdir = _copy(model_dir, tmp_path, "jax")
    tdir = _copy(model_dir, tmp_path, "port")
    rdir = _copy(model_dir, tmp_path, "port_rows")
    jrender_cli.main(["-m", jdir])
    trender_cli.main(["-m", tdir, "--device", "cpu"])
    monkeypatch.setenv("ADGS_RM", "1")
    trender_cli.main(["-m", rdir, "--device", "cpu", "--skip_train"])
    for split in ("train", "test"):
        want, got = _results(jdir, split), _results(tdir, split)
        assert "LPIPS(VGG)" not in got and np.isfinite(got["FPS"])
        for k in ("PSNR", "SSIM"):
            assert abs(got[k] - want[k]) <= 1e-4, (split, k, got[k], want[k])
        jp, tp = _pngs(jdir, split), _pngs(tdir, split)
        assert jp.keys() == tp.keys() and tp
        for k in jp:
            diff = np.abs(tp[k].astype(int) - jp[k].astype(int))
            assert diff.max() <= 1, (split, k, diff.max())
    # the rows layout (test split): bitwise the default layout's output
    assert _results(rdir, "test")["PSNR"] == _results(tdir, "test")["PSNR"]
    rp, tp = _pngs(rdir, "test"), _pngs(tdir, "test")
    assert rp.keys() == tp.keys()
    for k in tp:
        np.testing.assert_array_equal(rp[k], tp[k], err_msg=k)
    # the scene is on screen: the renders are not the sky alone
    assert np.std(tp["renders/00000.png"]) > 0


def test_deform_time_env_modes(model_dir, tmp_path, monkeypatch):
    _no_lpips(monkeypatch, tmp_path)
    tdir = _copy(model_dir, tmp_path, "port")
    for mode in ("deform", "time", "env"):
        trender_cli.main(["-m", tdir, "--mode", mode, "--device", "cpu"])
    deform = os.path.join(tdir, "train", f"ours_{ITER}", "deform")
    assert len(os.listdir(deform)) == 10
    renders = os.path.join(tdir, "interp_time", f"ours_{ITER}", "renders")
    assert len(os.listdir(renders)) == 150
    jdir = _copy(model_dir, tmp_path, "jax")
    jrender_cli.main(["-m", jdir, "--mode", "env"])
    rel = os.path.join("env", f"ours_{ITER}", "env_map.ply")
    got, want = read_ply(os.path.join(tdir, rel)), read_ply(
        os.path.join(jdir, rel))
    assert got.keys() == want.keys()
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    for k in ("red", "green", "blue"):
        # colours are stored as uint8: within one step of the rounding
        assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1


def _bytes(model, split):
    d = os.path.join(model, split, f"ours_{ITER}")
    return {f"{kind}/{f}": open(os.path.join(d, kind, f), "rb").read()
            for kind in ("renders", "gt")
            for f in sorted(os.listdir(os.path.join(d, kind)))}


def test_render_set_serves_each_timestamp_as_one_rig(model_dir, tmp_path,
                                                      monkeypatch):
    """The scene's two cameras at each timestamp, served as one rig frame
    (cli.render's rig_groups), write the same PNG bytes and the same
    surround video as each frame served alone, and deform once a
    timestamp."""
    import imageio
    import adgs_tpu_torch.render as trender
    _no_lpips(monkeypatch, tmp_path)
    videos, deforms = [], []
    monkeypatch.setattr(imageio, "mimwrite",
                        lambda path, video, **kw: videos.append(video))
    real = trender.deform

    def counted(*args, **kwargs):
        deforms.append(float(args[3]))
        return real(*args, **kwargs)

    monkeypatch.setattr(trender, "deform", counted)
    rigs = _copy(model_dir, tmp_path, "rigs")
    trender_cli.main(["-m", rigs, "--device", "cpu", "--skip_test",
                      "--video"])
    grouped = list(deforms)
    deforms.clear()
    monkeypatch.setattr(trender_cli, "rig_groups",
                        lambda frames: [[fr] for fr in frames])
    alone = _copy(model_dir, tmp_path, "alone")
    trender_cli.main(["-m", alone, "--device", "cpu", "--skip_test",
                      "--video"])
    times = [fr.time for fr in read_scene(
        tcommon.load_cfg_args(model_dir)[0].source_path).train_frames]
    assert deforms == pytest.approx(times)
    assert len(grouped) == len(set(times)) < len(times)
    assert grouped == pytest.approx(sorted(set(times)))
    assert _bytes(rigs, "train") == _bytes(alone, "train")
    assert len(videos) == 2 and videos[0].shape[2] == 2 * 64
    np.testing.assert_array_equal(videos[0], videos[1])


def test_cfg_args_backend_names(model_dir):
    model_cfg, opt = tcommon.load_cfg_args(model_dir)
    assert model_cfg.capacity == 1 << 14 and model_cfg.order_args == ORDER
    assert opt == tcommon.OptimizationConfig(**json.load(open(os.path.join(
        model_dir, "cfg_args.json")))["opt"])
    for name, plain in (("auto", 0), ("pallas", 0), ("xla", 1),
                        ("reference", 1)):
        with tcommon.backend_context(name):
            assert _kernels._plain == plain, name
    with pytest.raises(ValueError):
        tcommon.backend_context("mosaic")


def test_config_layers_match_jax(tmp_path):
    """Defaults < config module (-c) < command-line flags, as the JAX
    package merges them."""
    cfg = tmp_path / "cfg.py"
    cfg.write_text("capacity = 4096\nsplit_mode = 'nvs-50'\n"
                   "order_args = dict(xyz=[4, 2, 0, 2, 0, 0])\n")
    argv = ["--sh_degree", "2", "--no-inv_depth", "--num_cam", "3"]
    got, want = [], []
    for mod, out in ((tcommon, got), (jcommon, want)):
        parser = argparse.ArgumentParser()
        mod.add_dataclass_args(parser, mod.ModelConfig)
        merged = mod.merge(mod.ModelConfig(),
                           mod.load_config_module(str(cfg)),
                           parser.parse_args(argv))
        out.append(dataclasses.asdict(merged))
    assert got == want
    assert got[0]["capacity"] == 4096 and got[0]["sh_degree"] == 2
    assert got[0]["inv_depth"] is False and got[0]["num_cam"] == 3
