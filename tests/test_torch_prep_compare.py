"""Comparisons shared by the port's scene-preparation tests
(tests/test_torch_{lidar,waymo,geometry,pseudo_labels,rehearsal}.py), and
tests of the comparisons themselves; the tolerances those files state:
  - bitwise: integer, boolean and id outputs, poses.npz / cameras.npz /
    meta.npz, every PLY column that holds times or ids (and the PLY's
    uint8 colours), images, masks, depth maps, flow packages;
  - one float32 ulp on float32 geometry, the ulp taken at the magnitude
    of the row (a point's largest coordinate), since a coordinate that
    cancels to ~0 carries the rounding of its row;
  - 1e-9 relative on float64 geometry, at the same row magnitude.
JAX scripts run in-process through `run_jax_script` (sys.argv patched),
so no test pays a second interpreter's JAX import."""

from __future__ import annotations

import os
import runpy
import sys

import numpy as np
import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

def as_np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _row_scale(a, b, axis):
    s = np.maximum(np.abs(a), np.abs(b))
    return s if axis is None else s.max(axis=axis, keepdims=True)


def assert_f32_ulp(got, want, axis=-1, what=""):
    got, want = as_np(got), as_np(want)
    assert got.dtype == want.dtype == np.float32, (what, got.dtype,
                                                  want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = np.spacing(_row_scale(got, want, axis).astype(np.float32))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (diff <= tol).all(), (
        f"{what}: {int((diff > tol).sum())} values beyond one float32 ulp, "
        f"max {diff.max()}")


def assert_f64_rel(got, want, axis=-1, rtol=1e-9, what=""):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rtol * _row_scale(got, want, axis)
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (diff <= tol).all(), (
        f"{what}: {int((diff > tol).sum())} values beyond {rtol} relative, "
        f"max {diff.max()}")


def assert_bitwise(got, want, what=""):
    got, want = as_np(got), as_np(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f"), (
        f"{what}: {int((got != want).sum())} values differ")


def dlt_well_conditioned(xy, frame, track_of, n_tracks, proj,
                         bound=1e-10):
    """[n_tracks] bool: tracks whose DLT point is fixed to ~1e-10 relative
    by its normal matrix. Two eigensolvers may return different vectors
    where the two smallest eigenvalues of the trace-normalised A^T A lie
    close: the vector moves by ~eps / gap, the point by that over |h3|
    (numpy float64, the JAX module's arithmetic)."""
    sel = track_of >= 0
    t_id = track_of[sel]
    P = proj[frame[sel]]
    x = xy[sel].astype(np.float64)
    r0 = x[:, 0:1] * P[:, 2, :] - P[:, 0, :]
    r1 = x[:, 1:2] * P[:, 2, :] - P[:, 1, :]
    ata = np.zeros((n_tracks, 4, 4))
    np.add.at(ata, t_id, r0[:, :, None] * r0[:, None, :])
    np.add.at(ata, t_id, r1[:, :, None] * r1[:, None, :])
    scale = np.maximum(np.sqrt(np.trace(ata, axis1=1, axis2=2)), 1e-12)
    w, v = np.linalg.eigh(ata / scale[:, None, None])
    gap = np.maximum(w[:, 1] - w[:, 0], 1e-300)
    h3 = np.maximum(np.abs(v[:, 3, 0]), 1e-300)
    return 1e-15 / (gap * h3) < bound


def run_jax_script(name, args):
    """scripts/<name>.py's main() in this process."""
    old = sys.argv
    sys.argv = [name] + [str(a) for a in args]
    try:
        runpy.run_path(os.path.join(REPO, "scripts", name + ".py"),
                       run_name="__main__")
    finally:
        sys.argv = old


def _compare_npz(path, got, want):
    with np.load(got, allow_pickle=True) as g, \
            np.load(want, allow_pickle=True) as w:
        assert sorted(g.files) == sorted(w.files), path
        for k in w.files:
            if k == "flow":
                ge, we = g[k], w[k]
                assert len(ge) == len(we), path
                for a, b in zip(ge, we):
                    for i, (x, y) in enumerate(zip(a, b)):
                        assert_bitwise(x, y, f"{path} flow entry item {i}")
            else:
                # poses / cameras / meta and lidar depth maps: bitwise
                assert_bitwise(g[k], w[k], f"{path}:{k}")


def ply_xyz(v):
    return np.stack([v["x"], v["y"], v["z"]], 1)


def _compare_ply(path, got, want):
    from adgs_tpu_torch.data.ply import read_ply
    g, w = read_ply(got), read_ply(want)
    assert list(g) == list(w), path
    for k in w:
        if k in ("x", "y", "z"):
            continue
        assert_bitwise(g[k], w[k], f"{path}:{k}")
    assert_f32_ulp(ply_xyz(g), ply_xyz(w), axis=-1, what=f"{path}:xyz")


def compare_scene_dirs(got_root, want_root, skip=()):
    """Every file under want_root has its twin under got_root, held at the
    tolerances above; returns the relative paths compared."""
    seen = []
    for dirpath, _, files in os.walk(want_root):
        for f in sorted(files):
            want = os.path.join(dirpath, f)
            rel = os.path.relpath(want, want_root)
            if rel in skip:
                continue
            got = os.path.join(got_root, rel)
            assert os.path.exists(got), f"missing in the port's scene: {rel}"
            if f.endswith(".npz"):
                _compare_npz(rel, got, want)
            elif f.endswith(".ply"):
                _compare_ply(rel, got, want)
            elif f.endswith(".npy"):
                assert_bitwise(np.load(got), np.load(want), rel)
            else:
                with open(got, "rb") as a, open(want, "rb") as b:
                    assert a.read() == b.read(), rel
            seen.append(rel)
    got_files = {os.path.relpath(os.path.join(d, f), got_root)
                 for d, _, fs in os.walk(got_root) for f in fs}
    extra = got_files - set(seen) - set(skip)
    assert not extra, f"files only in the port's scene: {sorted(extra)}"
    return seen


def test_ulp_tolerances_hold_one_ulp_and_reject_two():
    row = np.array([[1000.0, 1e-3, -2.5]], np.float32)
    one = row.copy()
    one[0, 1] = np.nextafter(np.float32(1e-3) + np.spacing(np.float32(
        1000.0)) * 0.9, np.float32(1.0))        # within the row's ulp
    assert_f32_ulp(one, row)
    two = row.copy()
    two[0, 0] = np.nextafter(np.nextafter(row[0, 0], np.float32(2e3)),
                             np.float32(2e3))    # two ulps at 1000
    with pytest.raises(AssertionError, match="beyond one float32 ulp"):
        assert_f32_ulp(two, row)
    a = np.array([[10.0, 0.0, 0.0]])
    assert_f64_rel(a + [[0.0, 9e-9, 0.0]], a)
    with pytest.raises(AssertionError, match="relative"):
        assert_f64_rel(a + [[0.0, 2e-8, 0.0]], a)


def test_compare_scene_dirs_flags_missing_extra_and_changed(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        (d / "sub").mkdir(parents=True)
        np.save(d / "sub" / "m.npy", np.arange(4, dtype=np.int32))
    assert compare_scene_dirs(str(a), str(b)) == ["sub/m.npy"]
    (a / "extra.txt").write_text("x")
    with pytest.raises(AssertionError, match="only in the port's scene"):
        compare_scene_dirs(str(a), str(b))
    (a / "extra.txt").unlink()
    np.save(a / "sub" / "m.npy", np.arange(4, dtype=np.int64))
    with pytest.raises(AssertionError):
        compare_scene_dirs(str(a), str(b))
    (b / "more.bin").write_bytes(b"1")
    with pytest.raises(AssertionError, match="missing"):
        compare_scene_dirs(str(a), str(b))
