"""cli.render --mode deform and --mode time of the port against the JAX
package's, on tests/test_torch_cli.py's checkpoint with its deformation
coefficients perturbed by N(0, 0.05) (seed 0), so that the Gaussians
move, and Python's `random` (which picks the time mode's frame) seeded
alike in both runs: the deform PNGs bitwise equal, the time renders
within 1 of 255, the time ground truths bitwise equal."""

import os
import random

import numpy as np
import pytest
from PIL import Image

from adgs_tpu.cli import render as jrender_cli
from adgs_tpu_torch.cli import render as trender_cli
from tests.test_torch_cli import ITER, _copy, _no_lpips, model_dir  # noqa: F401

DEFORM_KEYS = ("xyz_deform", "rotation_deform", "shs_deform_scene",
               "shs_deform_obj", "background_deform")


@pytest.fixture(scope="module")
def moving_model(model_dir, tmp_path_factory):  # noqa: F811
    out = _copy(model_dir, tmp_path_factory.mktemp("moving"), "model")
    path = os.path.join(out, "point_cloud", f"iteration_{ITER}",
                        "deform.npz")
    arrays = dict(np.load(path))
    rng = np.random.default_rng(0)
    for k in DEFORM_KEYS:
        arrays[k] = (arrays[k] + rng.normal(0.0, 0.05, arrays[k].shape)
                     ).astype(arrays[k].dtype)
    np.savez(path, **arrays)
    return out


def _pngs(d):
    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("mode", ["deform", "time"])
def test_render_mode_matches_jax(moving_model, tmp_path, monkeypatch, mode):
    _no_lpips(monkeypatch, tmp_path)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = _copy(moving_model, tmp_path, side)
        random.seed(0)
        if side == "jax":
            jrender_cli.main(["-m", dirs[side], "--mode", mode])
        else:
            trender_cli.main(["-m", dirs[side], "--mode", mode,
                              "--device", "cpu"])
    if mode == "deform":
        rel = os.path.join("train", f"ours_{ITER}", "deform")
        got, want = (_pngs(os.path.join(dirs[s], rel))
                     for s in ("port", "jax"))
        assert list(got) == list(want) and len(got) == 10
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert any(np.std(want[f]) > 0 for f in want)
        return
    base = os.path.join("interp_time", f"ours_{ITER}")
    for sub, tol in (("gt", 0), ("renders", 1)):
        got, want = (_pngs(os.path.join(dirs[s], base, sub))
                     for s in ("port", "jax"))
        assert list(got) == list(want) and len(got) == 150
        for f in want:
            diff = np.abs(got[f].astype(int) - want[f].astype(int)).max()
            assert diff <= tol, (sub, f, diff)
    renders = list(_pngs(os.path.join(dirs["port"], base, "renders"))
                   .values())
    assert not np.array_equal(renders[0], renders[-1])    # it moves
