"""The port's range-image geometry (adgs_tpu_torch/data/lidar.py) and its
nuScenes converter against adgs_tpu/data/lidar.py and
scripts/convert_nuscenes.py on the same seeded numpy inputs, on the CPU.

Tolerances (tests/test_torch_prep_compare.py): integer, boolean and id outputs
bitwise, the depth map bitwise (colliding pixels included), the camera
matrix bitwise (it is written to cameras.npz); float32 geometry within
one float32 ulp at the row's magnitude; float64 geometry within 1e-9
relative; the converters' files as compare_scene_dirs holds them."""

import os

import numpy as np
import pytest
import torch

from adgs_tpu.data import lidar as jl
from adgs_tpu_torch.data import lidar as tl
from adgs_tpu_torch.scripts import convert_nuscenes as t_nusc
from tests.test_torch_prep_compare import (
    assert_bitwise, assert_f32_ulp, assert_f64_rel, compare_scene_dirs,
    run_jax_script)
from tests.test_lidar import make_nuscenes_fixture

T = torch.as_tensor


def _yawed(phi, shift=(1.2, -0.3, 1.9)):
    ext = np.eye(4)
    ext[:2, :2] = [[np.cos(phi), -np.sin(phi)], [np.sin(phi), np.cos(phi)]]
    ext[:3, 3] = shift
    return ext


def _range_case(rng, H=6, W=16):
    ranges = rng.uniform(1.0, 40.0, (H, W)).astype(np.float32)
    ranges[rng.uniform(size=(H, W)) < 0.2] = 0.0          # no return
    ranges[0, 0] = -1.0
    rpy = np.zeros((H, W, 6), np.float32)
    rpy[..., :3] = rng.normal(scale=0.05, size=(H, W, 3))
    rpy[..., 3] = np.linspace(100.0, 101.0, W)[None, :]    # ego moving
    rpy[..., 4] = 50.0 + rng.normal(scale=0.01, size=(H, W))
    rpy[..., 5] = 0.3
    frame = np.eye(4)
    frame[:3, :3] = jl.pixel_pose_matrices(
        np.array([[[0.01, -0.02, 0.4, 0, 0, 0]]]))[0, 0, :3, :3]
    frame[:3, 3] = [100.5, 50.0, 0.3]
    return ranges, rpy, frame


def test_beam_inclinations_and_azimuths():
    assert_f64_rel(tl.beam_inclinations(-0.4, 0.2, 64),
                   jl.beam_inclinations(-0.4, 0.2, 64), axis=None)
    for phi in (0.0, 0.3, -2.9):
        ext = _yawed(phi)
        assert_f64_rel(tl.azimuths(2650, T(ext)), jl.azimuths(2650, ext),
                       axis=None)


@pytest.mark.parametrize("explicit_incl", [False, True])
@pytest.mark.parametrize("rolling", [False, True])
def test_range_image_to_points(rng, explicit_incl, rolling):
    ranges, rpy, frame = _range_case(rng)
    ext = _yawed(0.7)
    incl = np.sort(rng.uniform(-0.3, 0.05, len(ranges)))[::-1].copy()
    kw_j = dict(incl_min=-0.3, incl_max=0.05)
    kw_t = dict(kw_j)
    if explicit_incl:
        kw_j = dict(inclinations=incl)
        kw_t = dict(inclinations=T(incl))
    if rolling:
        pp = jl.pixel_pose_matrices(rpy.astype(np.float64))
        kw_j.update(pixel_pose=pp, frame_pose=frame)
        kw_t.update(pixel_pose=tl.pixel_pose_matrices(T(rpy)),
                    frame_pose=T(frame))
    want = jl.range_image_to_points(ranges, ext, **kw_j)
    got = tl.range_image_to_points(T(ranges), T(ext), **kw_t)
    assert len(want) == int((ranges > 0).sum())
    assert_f32_ulp(got, want, axis=-1, what="points")


def test_pixel_pose_matrices(rng):
    _, rpy, _ = _range_case(rng)
    assert_f64_rel(tl.pixel_pose_matrices(T(rpy)),
                   jl.pixel_pose_matrices(rpy.astype(np.float64)),
                   axis=(-2, -1))


def test_camera_world_to_cam_bitwise(rng):
    for i in range(20):
        ego = _yawed(rng.uniform(-3, 3), rng.normal(size=3) * 50)
        cam = _yawed(rng.uniform(-1, 1), rng.normal(size=3))
        assert_bitwise(tl.camera_world_to_cam(T(ego), T(cam)),
                       jl.camera_world_to_cam(ego, cam), f"pose {i}")


def _projection_case(rng, n=4000, W=64, H=48):
    pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    pts[:, 0] = np.abs(pts[:, 0]) + 1.0
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1.0]])
    RT = jl.camera_world_to_cam(_yawed(0.1, (0.5, 0.2, -0.1)), _yawed(0.05))
    return pts, K, RT, W, H


def test_project_points(rng):
    pts, K, RT, W, H = _projection_case(rng)
    uv_j, d_j, m_j = jl.project_points(pts.astype(np.float64), K, RT, W, H)
    uv_t, d_t, m_t = tl.project_points(T(pts), T(K), T(RT), W, H)
    assert_bitwise(m_t, m_j, "mask")
    assert_f64_rel(uv_t, uv_j, what="uv")
    assert_f64_rel(d_t, d_j, axis=None, what="depth")


def test_sample_colors_aligned(rng):
    img = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    uv = np.concatenate([rng.uniform(0, [63, 47], (500, 2)),
                         [[0, 0], [63, 47], [63, 0], [0, 47]]])
    assert_f64_rel(tl.sample_colors_aligned(T(img), T(uv)),
                   jl.sample_colors_aligned(img, uv), what="colors")


def test_lidar_depth_map_collisions_bitwise(rng):
    """Many points per pixel: the later point wins, bit for bit."""
    W, H = 16, 12
    n = 3000
    uv = rng.uniform(0, [W - 1, H - 1], (n, 2))
    uv[:50] = np.floor(uv[:50]) + 0.5                       # ties at .5
    depth = rng.uniform(1.0, 50.0, n)
    mask = rng.uniform(size=n) < 0.8
    dm_j, mk_j = jl.lidar_depth_map(uv, depth, mask, W, H)
    dm_t, mk_t = tl.lidar_depth_map(T(uv), T(depth), T(mask), W, H)
    ij = np.round(uv[mask]).astype(np.int64)
    assert len(np.unique(ij[:, 1] * W + ij[:, 0])) < mask.sum() // 5
    assert_bitwise(dm_t, dm_j, "depth map")
    assert_bitwise(mk_t, mk_j, "validity")


def test_host_helpers(rng):
    for kw in (dict(test_every=4), dict(test_every=2), dict(train_every=4),
               dict(train_every=1)):
        assert tl.get_val_frames(17, **kw) == jl.get_val_frames(17, **kw)
    q = rng.normal(size=4)
    assert_bitwise(tl.quat_to_rotation(q), jl.quat_to_rotation(q))
    assert_bitwise(tl.pose_rt(q, [1.0, 2, 3]), jl.pose_rt(q, [1.0, 2, 3]))
    ts = rng.uniform(0, 1e6, 40)
    for qt in rng.uniform(0, 1e6, 10):
        assert tl.nearest_by_timestamp(ts, qt) == jl.nearest_by_timestamp(
            ts, qt)


def test_nuscenes_converter_matches_jax(tmp_path, rng):
    root = make_nuscenes_fixture(str(tmp_path / "nusc"), rng)
    args = [root, None, "scene-0001", "--version", "v1.0-mini",
            "--first_frame", "1", "--last_frame", "7", "--use_color",
            "--use_depth", "-r", "0.7"]
    jdst, tdst = str(tmp_path / "jax"), str(tmp_path / "port")
    run_jax_script("convert_nuscenes", [a if a else jdst for a in args])
    t_nusc.main([a if a else tdst for a in args] + ["--device", "cpu"])
    seen = compare_scene_dirs(tdst, jdst)
    assert "scene-0001/meta.npz" in seen
    assert "scene-0001/lidar_depth/000000.npz" in seen
    assert "scene-0001/points3d.ply" in seen
    # the random colours of the no-colour path, in the same draw order
    for d in (jdst, tdst):
        os.rename(os.path.join(d, "scene-0001"), os.path.join(d, "c"))
    args = [a for a in args if a != "--use_color"]
    run_jax_script("convert_nuscenes", [a if a else jdst for a in args])
    t_nusc.main([a if a else tdst for a in args] + ["--device", "cpu"])
    compare_scene_dirs(os.path.join(tdst, "scene-0001"),
                       os.path.join(jdst, "scene-0001"))
