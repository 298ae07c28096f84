"""The port's offline geometry (adgs_tpu_torch/geometry/{triangulate,
segment,scene_meta}.py) against adgs_tpu/geometry on the same seeded
inputs, on the CPU, with test_geometry.py's fixtures.

Tolerances: track ids, valid and keep flags, match sets, object tags and
scene metadata bitwise; float64 geometry (triangulated points) within
1e-9 relative at the point's magnitude, on the tracks whose DLT is
well conditioned (test_torch_prep_compare.dlt_well_conditioned: where the two
smallest eigenvalues lie close, torch.linalg.eigh and np.linalg.eigh may
return different vectors; the degenerate-baseline fixture is all such
tracks, and there only the flags are held). The match sets are held to
cv2.BFMatcher's (the JAX module's matcher) on seeded descriptors whose
ratios d0 / d1 all lie more than 1e-4 from the 0.8 cut, and on SIFT
output of test_geometry.py's two-view plane. Also: every entry point of
the scene-preparation slice raises without CUDA rather than falling back
to the CPU, and the two geometry scripts answer --help with jax blocked."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from adgs_tpu.geometry import segment as jseg
from adgs_tpu.geometry import triangulate as jtri
from adgs_tpu.geometry.scene_meta import load_scene_meta as jmeta
from adgs_tpu_torch.geometry import segment as tseg
from adgs_tpu_torch.geometry import triangulate as ttri
from adgs_tpu_torch.geometry.scene_meta import load_scene_meta as tmeta
from tests.test_torch_prep_compare import (
    REPO, assert_bitwise, assert_f64_rel, dlt_well_conditioned)
from tests.test_geometry import lookat_cameras, make_obs

T = torch.as_tensor
K0 = np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]])


def _proj(K, Rs, Ts):
    return np.broadcast_to(K, (len(Rs), 3, 3)) @ np.concatenate(
        [Rs, Ts[:, :, None]], axis=2)


def _tobs(obs):
    return ttri.Observations(xy=T(obs.xy), frame=T(obs.frame),
                             offset=obs.offset, color=obs.color)


def _dlt_case(name, rng):
    if name == "recover":
        pts = rng.uniform(-1.5, 1.5, size=(60, 3))
        Rs, Ts = lookat_cameras(4)
        return make_obs(pts, K0, Rs, Ts, noise=0.3, rng=rng) + (Rs, Ts)
    if name == "corrupted":
        pts = rng.uniform(-1.5, 1.5, size=(40, 3))
        Rs, Ts = lookat_cameras(3)
        obs, tracks = make_obs(pts, K0, Rs, Ts)
        obs.xy[40 + 0] += 60.0
        return obs, tracks, Rs, Ts
    if name == "degenerate":
        pts = rng.uniform(-1.0, 1.0, size=(10, 3))
        Rs = np.stack([np.eye(3)] * 2)
        Ts = np.stack([[0.0, 0.0, 8.0], [1e-5, 0.0, 8.0]])
        return make_obs(pts, K0, Rs, Ts) + (Rs, Ts)
    # behind both cameras, and a track of one observation
    Rs = np.stack([np.eye(3)] * 2)
    Ts = np.stack([[0.0, 0.0, 5.0], [2.0, 0.0, 5.0]])
    obs, tracks = make_obs(np.array([[0.0, 0.0, -9.0], [0.5, 0.2, 3.0]]),
                           K0, Rs, Ts)
    track_of = tracks.track_of.copy()
    track_of[3] = -1
    return obs, jtri.Tracks(track_of, 2), Rs, Ts


@pytest.mark.parametrize("case", ["recover", "corrupted", "degenerate",
                                  "behind"])
def test_triangulate_and_filter_match_jax(rng, case):
    obs, tracks, Rs, Ts = _dlt_case(case, rng)
    proj = _proj(K0, Rs, Ts)
    xyz_j, valid_j = jtri.triangulate_tracks(obs, tracks, proj)
    keep_j = jtri.filter_tracks(xyz_j, valid_j, obs, tracks, proj, Rs, Ts)
    xyz_t, valid_t = ttri.triangulate_tracks(_tobs(obs), tracks, T(proj))
    keep_t = ttri.filter_tracks(xyz_t, valid_t, _tobs(obs), tracks,
                                T(proj), T(Rs), T(Ts))
    assert_bitwise(valid_t, valid_j, "valid")
    assert_bitwise(keep_t, keep_j, "keep")
    well = dlt_well_conditioned(obs.xy, obs.frame, tracks.track_of,
                                tracks.n_tracks, proj)
    # the degenerate baseline and a one-observation track have no gap
    assert well.all() == (case in ("recover", "corrupted"))
    assert_f64_rel(xyz_t[well], xyz_j[well], what="xyz")
    if case == "corrupted":
        assert not keep_t[0] and keep_t[1:].all()
    if case in ("degenerate", "behind"):
        assert not keep_t.any()


def test_build_tracks_bitwise(rng):
    """Random matches over many frame pairs: same-frame conflicts, chains
    and merges; track ids bitwise (they fix every later file)."""
    counts = rng.integers(5, 40, size=12)
    offset = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    pairs = []
    for a in range(12):
        for b in range(a + 1, min(a + 4, 12)):
            m = np.stack([rng.integers(0, counts[a], 15),
                          rng.integers(0, counts[b], 15)], 1)
            pairs.append((a, b, m))
    pairs.append((2, 3, np.zeros((0, 2), np.int64)))
    got, want = ttri.build_tracks(offset, pairs), jtri.build_tracks(
        offset, pairs)
    assert got.n_tracks == want.n_tracks
    assert_bitwise(got.track_of, want.track_of, "track_of")
    for offset, matches in (
            (np.array([0, 2, 4, 6]), [(0, 1, np.array([[0, 0]])),
                                      (1, 2, np.array([[0, 0]]))]),
            (np.array([0, 1, 3]), [(0, 1, np.array([[0, 0], [0, 1]]))]),
            (np.array([0, 2, 4]), [(0, 1, np.array([[0, 1], [1, 0]]))])):
        assert_bitwise(ttri.build_tracks(offset, matches).track_of,
                       jtri.build_tracks(offset, matches).track_of)


def test_sequential_pairs():
    steps = [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
    cams = [0, 1] * 5
    for window in (0, 1, 3):
        assert (ttri.sequential_pairs(steps, cams, window)
                == jtri.sequential_pairs(steps, cams, window))


def _ratios(a, b):
    d = np.sqrt(((a[:, None, :].astype(np.float64) - b[None]) ** 2).sum(-1))
    d.sort(axis=1)
    return d[:, 0] / d[:, 1]


@pytest.mark.parametrize("na,nb", [(300, 50), (80, 400), (30, 1), (0, 5),
                                   (5, 0)])
def test_match_descriptors_matches_cv2(rng, na, nb):
    pytest.importorskip("cv2")
    a = rng.normal(size=(na, 128)).astype(np.float32) * 40 + 60
    b = rng.normal(size=(nb, 128)).astype(np.float32) * 40 + 60
    # so that near-duplicates pass the ratio test
    k = min(na, nb) // 3
    b[:k] = a[:k] + rng.normal(size=(k, 128)).astype(np.float32)
    if na and nb > 1:
        r = _ratios(a, b)
        keep = np.abs(r - 0.8) > 1e-4
        a = a[keep]
        assert (np.abs(_ratios(a, b) - 0.8) > 1e-4).all()
    want = jtri.match_descriptors(a, b)
    got = ttri.match_descriptors(T(a), T(b))
    assert_bitwise(got, want, "matches")
    if na and nb > 1:
        assert len(want) >= k // 2, "fixture passes too few matches"


def test_match_descriptors_sift_two_view(rng):
    """SIFT descriptors (integer-valued, norms ~512) of test_geometry's
    two-view plane; also the pipeline's points against JAX's."""
    cv2 = pytest.importorskip("cv2")
    H, W = 240, 320
    K = np.array([[260.0, 0, W / 2], [0, 260.0, H / 2], [0, 0, 1]])
    tex = (rng.uniform(size=(30, 40, 3)) * 255).astype(np.uint8)
    tex = cv2.resize(tex, (W * 2, H * 2), interpolation=cv2.INTER_NEAREST)

    def render(Rw2c, Tv):
        A = np.array([[1 / 6.0 * (2 * W), 0, W], [0, 1 / 6.0 * (2 * H), H],
                      [0, 0, 1.0]])
        M = K @ np.stack([Rw2c[:, 0], Rw2c[:, 1], Rw2c[:, 2] * 5.0 + Tv],
                         axis=1)
        return cv2.warpPerspective(tex, M @ np.linalg.inv(A), (W, H))

    views = [(np.eye(3), np.array([0.0, 0.0, 1.0])),
             (np.eye(3), np.array([-0.8, 0.0, 1.0])),
             (np.eye(3), np.array([0.8, 0.2, 1.0]))]
    images = [render(R, Tv) for R, Tv in views]
    _, da = ttri.detect_features(images[0], max_features=3000)
    _, db = ttri.detect_features(images[1], max_features=3000)
    want = jtri.match_descriptors(da, db)
    assert len(want) > 100
    assert_bitwise(ttri.match_descriptors(T(da), T(db)), want, "matches")
    Rs = np.stack([v[0] for v in views])
    Ts = np.stack([v[1] for v in views])
    kw = dict(max_features=3000, max_reproj_err=2.0, min_tri_angle_deg=0.5)
    xyz_j, rgb_j = jtri.triangulate_known_poses(images, [None] * 3, K, Rs,
                                                Ts, **kw)
    xyz_t, rgb_t = ttri.triangulate_known_poses(images, [None] * 3, K, Rs,
                                                Ts, device="cpu", **kw)
    assert len(xyz_j) > 50
    assert_bitwise(rgb_t, rgb_j, "rgb")
    assert_f64_rel(xyz_t, xyz_j, what="xyz")


def test_nearest_sample_and_tagging_match_jax(rng):
    H, W = 37, 53
    mask = rng.integers(0, 5, size=(H, W)).astype(np.float32)
    px = np.concatenate([rng.uniform(0.3, W - 0.3, 400), [0.5, W - 0.5]])
    py = np.concatenate([rng.uniform(0.3, H - 0.3, 400), [0.5, H - 0.5]])
    assert_bitwise(tseg.nearest_sample_aligned(T(mask), T(px), T(py)),
                   jseg.nearest_sample_aligned(mask, px, py))
    # a cloud over 5 frames at 3 timestamps, 4 frames sharing times
    F = 5
    pts = rng.uniform(-3, 3, (3000, 3)).astype(np.float32)
    times = rng.integers(0, 3, 3000).astype(np.float32) * 0.5
    frame_time = [0.0, 0.0, 0.5, 1.0, 0.5]
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]])
    Rs, Ts = lookat_cameras(F, radius=5.0)
    sems = [rng.integers(0, 4, size=(H, W)).astype(np.float32)
            for _ in range(F)]
    want = jseg.tag_object_points(pts, times, frame_time, K, Rs, Ts, sems)
    got = tseg.tag_object_points(T(pts), T(times), frame_time, T(K), T(Rs),
                                 T(Ts), [T(s) for s in sems])
    assert (want > 0).sum() > 500
    assert_bitwise(got, want, "obj")


def test_tag_first_frame_wins_and_out_of_view():
    K = T(np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]))
    R = np.eye(3)
    pts = T(np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -9.0]], np.float32))
    sem1 = np.zeros((48, 64), np.float32)
    sem1[20:28, 28:36] = 3.0
    sem2 = np.full((48, 64), 7.0, np.float32)
    obj = tseg.tag_object_points(
        pts, T(np.array([0.0, 0.0], np.float32)), [0.0, 0.0], K,
        T(np.stack([R, R])), T(np.array([[0.0, 0, 4], [0.0, 0, 12]])),
        [T(sem1), T(sem2)])
    assert obj.tolist() == [3.0, 7.0]     # frame 1 first; behind it -> 2
    obj = tseg.tag_object_points(
        T(np.array([[100.0, 0.0, 0.0]], np.float32)),
        T(np.array([0.0], np.float32)), [0.0], K, T(np.eye(3)[None]),
        T(np.array([[0.0, 0.0, 4.0]])), [T(np.full((48, 64), 5.0,
                                                   np.float32))])
    assert obj.tolist() == [0.0]
    # numpy compares a float32 time with a Python float in float32 and
    # with a numpy float64 in float64, where 0.1 matches nothing
    for ft, tag in (([0.1], 3.0), (np.array([0.1]), 0.0)):
        obj = tseg.tag_object_points(
            pts[:1], T(np.array([0.1], np.float32)), ft, K,
            T(np.eye(3)[None]), T(np.array([[0.0, 0, 4]])), [T(sem1)])
        assert obj.tolist() == jseg.tag_object_points(
            pts[:1].numpy(), np.array([0.1], np.float32), ft, K.numpy(),
            np.eye(3)[None], np.array([[0.0, 0, 4]]), [sem1]).tolist() == [
                tag]


def _waymo_nusc_meta(root, dataset, rng):
    os.makedirs(os.path.join(root, "image"), exist_ok=True)
    F = 9 if dataset == "nuscenes" else 6
    for i in range(F):
        open(os.path.join(root, "image", f"{i:06d}.png"), "wb").close()
    R = rng.normal(size=(F, 3, 3))
    Tv = rng.normal(size=(F, 3))
    if dataset == "waymo":
        K = np.tile([100.0, 101.0, 32.0, 24.0, 0, 0, 0, 0, 0], (F, 1))
        K = K[:, :4]
        name = "cameras.npz"
    else:
        K = np.tile(np.array([[90.0, 0, 40.0], [0, 91.0, 30.0],
                              [0, 0, 1.0]]), (F, 1, 1))
        name = "meta.npz"
    np.savez(os.path.join(root, name), K=K, R=R, T=Tv,
             time_stamps=np.arange(F, dtype=np.float32) // (3 if dataset ==
                                                             "nuscenes"
                                                             else 1),
             is_val_list=np.arange(F) % 4 == 3)
    return root


@pytest.mark.parametrize("dataset", ["kitti", "waymo", "nuscenes"])
def test_load_scene_meta_matches_jax(tmp_path, rng, dataset):
    if dataset == "kitti":
        from tests.test_data_cli import make_kitti_scene
        root = make_kitti_scene(str(tmp_path / "scene"), n_frames=5,
                                width=64, height=48)
    else:
        root = _waymo_nusc_meta(str(tmp_path / "scene"), dataset, rng)
    for split in ("nvs-75", "nvs-50", "nvs-25"):
        got, want = tmeta(root, split), jmeta(root, split)
        assert got.dataset == want.dataset == dataset
        for k in want._fields:
            g, w = getattr(got, k), getattr(want, k)
            if isinstance(w, np.ndarray):
                assert_bitwise(g, w, k)
            else:
                assert g == w, k
        if dataset != "kitti":
            break


def test_entry_points_raise_without_cuda(tmp_path):
    """No entry point of the slice runs on the CPU unless asked."""
    from adgs_tpu_torch.geometry import pseudo_labels
    from adgs_tpu_torch.scripts import (convert_kitti, convert_nuscenes,
                                        convert_waymo, segment_pcd,
                                        triangulate, validate_scene)
    d = str(tmp_path)
    calls = [(convert_kitti.main, [d, d, "0001"]),
             (convert_waymo.main, [d, d]),
             (convert_nuscenes.main, [d, d, "scene"]),
             (segment_pcd.main, [d]), (triangulate.main, [d]),
             (validate_scene.main, [d])]
    for fn, args in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pseudo_labels.package_scene_flow(d, tracks={})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttri.triangulate_known_poses([], [], np.eye(3), np.zeros((0, 3, 3)),
                                     np.zeros((0, 3)))


def test_geometry_scripts_help_without_jax():
    """segment_pcd and triangulate answer --help with jax and adgs_tpu
    blocked from import."""
    code = (
        "import importlib.abc, runpy, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'adgs_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "for m in ('segment_pcd', 'triangulate'):\n"
        "    sys.argv = [m, '--help']\n"
        "    try:\n"
        "        runpy.run_module('adgs_tpu_torch.scripts.' + m,\n"
        "                         run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (m, e.code)\n"
        "    else:\n"
        "        raise AssertionError(m + ' did not exit')\n"
        "print('HELP OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "HELP OK" in r.stdout, r.stdout + r.stderr
    assert "usage:" in r.stdout
