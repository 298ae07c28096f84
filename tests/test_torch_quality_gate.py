"""The port's quality gate (adgs_tpu_torch/scripts/quality_gate.py) against
scripts/quality_gate.py on the CPU, at tests/test_quality_gate.py's size
(48x32, 6 frames, 300 Gaussians, seed 0), with ADGS_KNN_HOST=1 in both
packages (the host KNN refresh draws its anchors from the same numpy
seed):
  - the scene files: poses.npz and both PLY files bitwise, PNG values
    within 1, depth at rtol 1e-4 / atol 1e-5, sky masks equal except at
    pixels whose JAX transmittance lies within 1e-4 of the 0.95 cut,
    semantic and flow files equal;
  - run_gate's 12-iteration curve (evaluations at 1, 6, 12; capacity
    1 << 13, sky 64): iterations equal, test and train PSNR within 0.01
    dB, test SSIM within 1e-3;
  - the first densify: both curve runs trained on to iteration 20 and
    densifying there; its statistics (denom and max_radii2d equal,
    xyz_grad_accum at rtol 1e-4 and 1e-4 of its largest value) and its
    report equal. At the gate's thresholds (2e-4) nothing would densify
    there (the test checks that the largest mean screen gradient is
    below them), so both thresholds are 5e-5;
  - the gate's verdicts and assertions, and the guard: one evaluation
    point gives gain_db None and main fails with "too few evaluation
    points".
The scenes and both curves are made once per module, without TensorBoard.
The file takes ~45 s of process time alone with a cold JAX compilation
cache, most of it the JAX package's compiles."""

import dataclasses
import functools
import json
import os
import shutil

import jax
import numpy as np
import pytest
from PIL import Image

import adgs_tpu.train.trainer as jtrainer_mod
import adgs_tpu_torch.train.trainer as ttrainer_mod
from adgs_tpu.train import densify as jdensify
from adgs_tpu.train.trainer import Trainer as JTrainer
from adgs_tpu_torch.scripts import quality_gate as qg
from adgs_tpu_torch.train import densify as tdensify
from adgs_tpu_torch.train.trainer import Trainer
from scripts import quality_gate as jqg

SIZE = dict(width=48, height=32, n_frames=6, n_gt=300, seed=0)
RUN = dict(iters=12, eval_every=6, capacity=1 << 13, env_resolution=64)


def _capture(make, store):
    """make, recording each object it returns in store."""
    def capture(*args, **kwargs):
        store.append(make(*args, **kwargs))
        return store[-1]
    return capture


def _record_final_t(store):
    """jax.jit that records the transmittance (its third output) of each
    call of JAX build_gt_scene's render_pose."""
    real = jax.jit

    def jit(fn, *args, **kwargs):
        compiled = real(fn, *args, **kwargs)
        if fn.__name__ != "render_pose":
            return compiled

        def render_pose(cam):
            out = compiled(cam)
            store.append(np.asarray(out[2]))
            return out
        return render_pose
    return jit


def _no_tensorboard(mp):
    """Both packages' MetricsLogger without TensorBoard (its import pulls
    in TensorFlow where that is installed, seconds of the file's time;
    test_torch_trainer.py covers its panels)."""
    for module in (jtrainer_mod, ttrainer_mod):
        mp.setattr(module, "MetricsLogger", functools.partial(
            module.MetricsLogger, use_tensorboard=False))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both packages' scenes (and JAX's transmittance of each render),
    12-iteration curves and the trainers that ran them (the port's left
    open, to train on)."""
    base = tmp_path_factory.mktemp("gate")
    jtrainers, ttrainers, final_t = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ADGS_KNN_HOST", "1")
        mp.setenv("ADGS_LPIPS_WEIGHTS", str(base / "absent.npz"))
        mp.setenv("TORCH_HOME", str(base / "no_torch_home"))
        _no_tensorboard(mp)
        mp.setattr(jtrainer_mod, "Trainer", _capture(JTrainer, jtrainers))
        mp.setattr(qg, "Trainer", _capture(Trainer, ttrainers))
        mp.setattr(Trainer, "close", lambda self: None)
        jroot, troot = str(base / "jax"), str(base / "torch")
        with pytest.MonkeyPatch.context() as jit_mp:
            jit_mp.setattr(jax, "jit", _record_final_t(final_t))
            jqg.build_gt_scene(jroot, **SIZE)
        nr = qg.build_gt_scene(troot, **SIZE, device="cpu")
        jcurve = jqg.run_gate(jroot, str(base / "jax_out"), **RUN)
        tcurve = qg.run_gate(troot, str(base / "torch_out"), **RUN,
                             device="cpu")
    (jtr,), (ttr,) = jtrainers, ttrainers
    yield dict(base=base, jax=jroot, torch=troot, nr=nr, jcurve=jcurve,
               tcurve=tcurve, jtrainer=jtr, ttrainer=ttr,
               jax_final_t=final_t)
    ttr.close()


def _files(root, sub):
    return sorted(os.listdir(os.path.join(root, sub)))


def _pair(world, sub):
    names = _files(world["jax"], sub)
    assert names == _files(world["torch"], sub) and names
    return [(os.path.join(world["jax"], sub, n),
             os.path.join(world["torch"], sub, n)) for n in names]


def test_poses_and_point_clouds_bitwise(world):
    a = np.load(os.path.join(world["jax"], "poses.npz"))
    b = np.load(os.path.join(world["torch"], "poses.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("points3d-75.ply", "colmap-75.ply"):
        with open(os.path.join(world["jax"], name), "rb") as f:
            ja = f.read()
        with open(os.path.join(world["torch"], name), "rb") as f:
            assert f.read() == ja, name


def test_images_within_one(world):
    differ = 0
    for ja, tb in _pair(world, "image"):
        a = np.asarray(Image.open(ja), np.int32)
        b = np.asarray(Image.open(tb), np.int32)
        assert a.shape == b.shape == (32, 48, 3)
        assert np.abs(a - b).max() <= 1, ja
        differ += int((a != b).sum())
    print(f"images: {differ} PNG values differ (by 1)")


def test_depth_close(world):
    gap = 0.0
    for ja, tb in _pair(world, "depth"):
        a, b = np.load(ja), np.load(tb)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
        gap = max(gap, float(np.abs(a - b).max()))
    print(f"depth: max abs difference {gap:.3e}")


def test_sky_masks_equal_off_the_cut(world):
    """Masks equal wherever JAX's transmittance is more than 1e-4 from
    0.95; the pixels within 1e-4 of it are counted, and JAX's own mask is
    its transmittance's cut."""
    final_t = world["jax_final_t"]
    near = differ = 0
    for t, (ja, tb) in zip(final_t, _pair(world, "sky")):
        a, b = np.load(ja), np.load(tb)
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, (t > 0.95).astype(np.uint8))
        close = np.abs(t - 0.95) <= 1e-4
        assert not ((a != b) & ~close).any(), ja
        near += int(close.sum())
        differ += int((a != b).sum())
    print(f"sky masks: {differ} pixels differ, {near} of "
          f"{len(final_t) * final_t[0].size} within 1e-4 of the cut")
    assert differ <= near


def test_semantic_and_flow_equal(world):
    for ja, tb in _pair(world, "semantic"):
        a, b = np.load(ja), np.load(tb)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for ja, tb in _pair(world, os.path.join("flow", "nvs-75")):
        (a,) = np.load(ja, allow_pickle=True)["flow"]
        (b,) = np.load(tb, allow_pickle=True)["flow"]
        assert len(a) == len(b) == 6
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_gt_renders_within_capacity(world):
    assert 0 < world["nr"] <= qg.GT_CAPACITY


def test_curve_matches_jax(world):
    j, t = world["jcurve"], world["tcurve"]
    assert j["iters"] == t["iters"] == [1, 6, 12]
    np.testing.assert_allclose(t["test_psnr"], j["test_psnr"], rtol=0,
                               atol=0.01)
    np.testing.assert_allclose(t["train_psnr"], j["train_psnr"], rtol=0,
                               atol=0.01)
    np.testing.assert_allclose(t["test_ssim"], j["test_ssim"], rtol=0,
                               atol=1e-3)
    assert t["test_psnr"][-1] > t["test_psnr"][0]
    print("curve: largest differences " + ", ".join(
        f"{k} {np.abs(np.subtract(t[k], j[k])).max():.4f}"
        for k in ("test_psnr", "train_psnr", "test_ssim")))


def _spy(monkeypatch, module, records, to_np, wrap=lambda f: f):
    """Record the statistics and the report of module.densify_and_prune's
    calls; wrap: how the real function is called."""
    real = wrap(module.densify_and_prune)

    def spy(trainables, opt_state, state, *args):
        out = real(trainables, opt_state, state, *args)
        records.append(dict(
            report={k: int(v) for k, v in out[3]._asdict().items()},
            **{k: to_np(getattr(state, k)) for k in
               ("xyz_grad_accum", "denom", "max_radii2d")}))
        return out
    monkeypatch.setattr(module, "densify_and_prune", spy)


def test_first_densify_matches_jax(world, monkeypatch):
    """Both curve runs trained on to iteration 20, densifying there."""
    monkeypatch.setenv("ADGS_KNN_HOST", "1")
    n, recs = 20, {}
    # JAX's densify jitted: eager, it compiles each op anew, several
    # times slower
    for name, module, to_np, wrap in (
            ("jax", jdensify, np.asarray, jax.jit),
            ("torch", tdensify, lambda x: x.numpy(), lambda f: f)):
        tr = world[name[0] + "trainer"]
        _spy(monkeypatch, module, recs.setdefault(name, []), to_np, wrap)
        tr.opt = dataclasses.replace(
            tr.opt, densify_from_iter=0, densification_interval=n,
            densify_until_iter=n + 1, densify_scene_grad_threshold=5e-5,
            densify_obj_grad_threshold=5e-5)
        tr.train(iterations=n, save_iterations=[0], test_iterations=[0])
    (j,), (t,) = recs["jax"], recs["torch"]
    grads = j["xyz_grad_accum"] / np.maximum(j["denom"], 1e-12)
    assert grads.max() < qg.gate_config(n).densify_scene_grad_threshold
    rep = j["report"]
    assert rep["scene_split"] + rep["scene_cloned"] + rep["obj_split"] \
        + rep["obj_cloned"] > 0, rep
    assert t["report"] == rep
    np.testing.assert_array_equal(t["denom"], j["denom"])
    np.testing.assert_array_equal(t["max_radii2d"], j["max_radii2d"])
    scale = float(np.abs(j["xyz_grad_accum"]).max())
    np.testing.assert_allclose(t["xyz_grad_accum"], j["xyz_grad_accum"],
                               rtol=1e-4, atol=1e-4 * scale)
    gap = float(np.abs(t["xyz_grad_accum"] - j["xyz_grad_accum"]).max())
    print(f"first densify: {rep}; xyz_grad_accum within {gap:.3e} of "
          f"values up to {scale:.3e}; largest mean gradient "
          f"{grads.max():.3e}")


def test_one_point_guard(world, tmp_path, monkeypatch):
    """One evaluation point: gain_db None, and main fails with a clear
    assertion instead of comparing None."""
    monkeypatch.setenv("ADGS_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    _no_tensorboard(monkeypatch)
    shutil.copytree(world["torch"], str(tmp_path / "scene"))
    out = tmp_path / "q.json"
    with pytest.raises(AssertionError, match="too few evaluation points"):
        qg.main(["--iters", "1", "--eval_every", "1", "--scene_dir",
                 str(tmp_path), "--out", str(out), "--device", "cpu"])
    res = json.loads(out.read_text())
    assert res["iters"] == [1] and res["gain_db"] is None
    assert res["backend"] == "cpu" and np.isfinite(res["final_test_psnr"])


def _result(t):
    curve = dict(iters=list(range(len(t))), test_psnr=t,
                 train_psnr=[None] * len(t), test_ssim=[0.5] * len(t))
    return qg.summarize(curve, "cpu")


def test_summarize_verdicts():
    """gain, final and monotonicity as scripts/quality_gate.py main
    computes them."""
    r = _result([8.0, 20.0, 19.6, 25.0])
    assert r["gain_db"] == 17.0 and r["final_test_psnr"] == 25.0
    assert r["monotone_ok"] and r["backend"] == "cpu"
    qg.check_gate(r, 4.0, 22.0)
    assert not _result([8.0, 20.0, 19.4, 25.0])["monotone_ok"]


@pytest.mark.parametrize("t, match", [
    ([], "no test PSNR"),
    ([8.0, float("nan")], "non-finite"),
    ([8.0], "too few evaluation points"),
    ([8.0, 20.0, 19.0, 25.0], "not monotone"),
    ([20.0, 23.0], "gain"),
    ([8.0, 21.0], "final PSNR"),
])
def test_check_gate_fails(t, match):
    with pytest.raises(AssertionError, match=match):
        qg.check_gate(_result(t), 4.0, 22.0)
