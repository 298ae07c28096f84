"""The port's pseudo-label packagers (adgs_tpu_torch/geometry/
pseudo_labels.py) against adgs_tpu/geometry/pseudo_labels.py on the same
seeded inputs, on the CPU.

Tolerances: bitwise everywhere — the query coordinates, the flow and
visibility grids (queries that round to the same pixel included: the
later query wins in both), and every written file (flow packages entry
by entry, semantic, sky and depth .npy files)."""

import os

import numpy as np
import pytest
import torch

from adgs_tpu.geometry import pseudo_labels as jpk
from adgs_tpu_torch.geometry import pseudo_labels as tpk
from tests.test_torch_prep_compare import assert_bitwise, compare_scene_dirs
from tests.test_pseudo_labels import H, N_FRAMES, NUM_CAMS, W, \
    _make_kitti_scene

T = torch.as_tensor


def test_queries_from_mask(rng):
    m = rng.uniform(size=(H, W)).astype(np.float32)
    m[4, 7] = 0.5                       # not above the 0.5 threshold
    assert_bitwise(tpk.queries_from_mask(T(m)), jpk.queries_from_mask(m))
    assert_bitwise(tpk.queries_from_mask(T(m > 0.9)),
                   jpk.queries_from_mask(m > 0.9))


@pytest.mark.parametrize("vis_dtype", [np.float32, np.float64, bool])
def test_tracks_to_flow_colliding_queries_bitwise(rng, vis_dtype):
    """Queries that round to the same pixel (many per pixel, ties at .5),
    queries off the grid, float64 targets: the later query wins."""
    n = 6000
    q = rng.uniform(-2, [W + 1, H + 1], (n, 2)).astype(np.float32)
    q[:40] = np.floor(q[:40]) + 0.5
    tgt = rng.normal(scale=30, size=(n, 2))
    vis = rng.uniform(size=n) > 0.3 if vis_dtype is bool else \
        rng.uniform(size=n).astype(vis_dtype)
    fl_j, vi_j = jpk.tracks_to_flow(H, W, q, tgt, vis)
    fl_t, vi_t = tpk.tracks_to_flow(H, W, T(q), T(tgt), T(vis))
    r = np.round(q).astype(np.int64)
    ok = (r[:, 0] >= 0) & (r[:, 0] < W) & (r[:, 1] >= 0) & (r[:, 1] < H)
    assert ok.sum() > 2 * len(np.unique(r[ok, 1] * W + r[ok, 0]))
    assert_bitwise(fl_t, fl_j, "flow")
    assert_bitwise(vi_t, vi_j, "vis")
    empty = np.zeros((0, 2), np.float32)
    for a, b in zip(tpk.tracks_to_flow(H, W, T(empty), T(empty),
                                       T(np.zeros(0))),
                    jpk.tracks_to_flow(H, W, empty, empty, np.zeros(0))):
        assert_bitwise(a, b, "no queries")


def _tracks(rng, gidx):
    out = {}
    for g in gidx:
        q = rng.uniform(0, [W, H], (60, 2)).astype(np.float32)
        tr = dict(query=q, fwd=q + rng.normal(size=q.shape),
                  fwd_vis=(rng.uniform(size=60) > 0.2).astype(np.float32))
        if g % 3:
            tr.update(bwd=q - 1.0, bwd_vis=np.ones(60, np.float32))
        out[int(g)] = tr
    return out


@pytest.mark.parametrize("source", ["dict", "dir"])
@pytest.mark.parametrize("window,split", [(1, "nvs-75"), (2, "nvs-50")])
def test_package_scene_flow_files_match_jax(tmp_path, rng, source, window,
                                            split):
    troot, jroot = str(tmp_path / "t"), str(tmp_path / "j")
    _make_kitti_scene(troot)
    _make_kitti_scene(jroot)
    tracks = _tracks(rng, range(N_FRAMES * NUM_CAMS))
    kw = dict(slide_window=window, split_mode=split)
    if source == "dir":
        tdir = str(tmp_path / "tracks")
        os.makedirs(tdir)
        for g, tr in tracks.items():
            np.savez(os.path.join(tdir, f"{g:06d}.npz"), **tr)
        kw["tracks_dir"] = tdir
    else:
        kw["tracks"] = tracks
    want = jpk.package_scene_flow(jroot, **kw)
    got = tpk.package_scene_flow(troot, device="cpu", **kw)
    assert [os.path.relpath(p, troot) for p in got] == [
        os.path.relpath(p, jroot) for p in want]
    assert len(want) > 3
    compare_scene_dirs(troot, jroot)


def test_importers_files_match_jax(tmp_path, rng):
    troot, jroot = str(tmp_path / "t"), str(tmp_path / "j")
    sem = {f"{i:06d}": rng.integers(0, 5, (H, W)) for i in range(3)}
    sem["000003"] = rng.uniform(size=(H, W)) > 0.5
    sky = {k: (v > 2) for k, v in sem.items() if k != "000003"}
    depth = {"000000": rng.uniform(2, 60, (H, W)),
             "000001": rng.uniform(0, 1, (H, W, 1)).astype(np.float32),
             "000002": np.full((H, W), 3.0)}
    for pk, root in ((tpk, troot), (jpk, jroot)):
        pk.import_semantic_masks(root, sem)
        pk.import_semantic_masks(root, sky, kind="sky")
        pk.import_depth_maps(root, depth)
        pk.import_depth_maps(os.path.join(root, "raw"), depth,
                             normalize=False)
    compare_scene_dirs(troot, jroot)
