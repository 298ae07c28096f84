"""The port's scene-preparation chain on test_rehearsal.py's raw KITTI-MOT
fixture (96x64, 6 stereo frames of a textured plane): convert_kitti ->
pseudo-label import and packaging -> segment_pcd -> triangulate
(--window 4) -> validate_scene, each step through the port's entry
points on the CPU and through the JAX package's (scripts/*.py, in
process), the two scenes compared file for file; then a few iterations
of the port's Trainer on the port's scene, with every loss finite.

Tolerances (tests/test_torch_prep_compare.py): poses.npz, images, masks, depth and
flow files, PLY times, ids and colours bitwise; PLY xyz within one float32
ulp at the point's magnitude (the triangulated points are float64 DLT
solutions cast to float32)."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("cv2")

from adgs_tpu.geometry import pseudo_labels as jpk  # noqa: E402
from adgs_tpu_torch.geometry import pseudo_labels as tpk  # noqa: E402
from adgs_tpu_torch.scripts import (convert_kitti, segment_pcd,  # noqa: E402
                                    triangulate, validate_scene)
from tests.test_torch_prep_compare import (  # noqa: E402
    compare_scene_dirs, run_jax_script)
from tests.test_rehearsal import H, N_FRAMES, PLANE_Z, W, make_raw_kitti  # noqa: E402,E501


def write_pseudo_labels(dst, pk, **device):
    """test_rehearsal.write_pseudo_labels through either package's
    packagers (`pk`); the port's take a device."""
    n_imgs = 2 * N_FRAMES
    sem = np.zeros((H, W), np.int32)
    sem[H // 3: H // 2, W // 3: W // 2] = 1
    sky = np.zeros((H, W), np.uint8)
    sky[: H // 8] = 1
    names = [f"{i:06d}" for i in range(n_imgs)]
    pk.import_depth_maps(dst, {n: np.full((H, W), 1.0 / PLANE_Z, np.float32)
                               for n in names}, normalize=False)
    pk.import_semantic_masks(dst, {n: sem for n in names})
    pk.import_semantic_masks(dst, {n: sky for n in names}, kind="sky")
    if device:
        import torch
        q = tpk.queries_from_mask(torch.as_tensor(sem)).numpy()
    else:
        q = jpk.queries_from_mask(sem.astype(np.float32))
    tracks = {g: dict(query=q, fwd=q, fwd_vis=np.ones(len(q), np.float32),
                      bwd=q, bwd_vis=np.ones(len(q), np.float32))
              for g in range(n_imgs)}
    return pk.package_scene_flow(dst, tracks=tracks, slide_window=1,
                                 split_mode="nvs-75", **device)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rehearsal")
    raw, scene = make_raw_kitti(str(tmp / "raw"), np.random.default_rng(3))
    out = {}
    for who in ("jax", "port"):
        root = str(tmp / who)
        args = [raw, root, scene, "--first_frame", "0", "--last_frame",
                str(N_FRAMES - 1), "--use_color"]
        dst = os.path.join(root, scene)
        if who == "jax":
            run_jax_script("convert_kitti", args)
            assert write_pseudo_labels(dst, jpk)
            run_jax_script("segment_pcd", [dst])
            run_jax_script("triangulate", [dst, "--window", "4"])
            run_jax_script("validate_scene", [dst])
        else:
            cpu = ["--device", "cpu"]
            convert_kitti.main(args + cpu)
            assert write_pseudo_labels(dst, tpk, device="cpu")
            segment_pcd.main([dst] + cpu)
            triangulate.main([dst, "--window", "4"] + cpu)
            validate_scene.main([dst] + cpu)
        out[who] = dst
    return out


def test_chain_files_match_jax(scenes):
    seen = compare_scene_dirs(scenes["port"], scenes["jax"])
    for f in ("poses.npz", "points3d-75.ply", "points3d-25.ply",
              "colmap-75.ply", "flow/nvs-75/000002.npz",
              "semantic/mask_000000.npy", "depth/000011.npy"):
        assert f in seen, f
    from adgs_tpu_torch.data.ply import fetch_point_cloud
    xyz, _, _, _ = fetch_point_cloud(os.path.join(scenes["port"],
                                                  "colmap-75.ply"))
    assert len(xyz) > 20
    assert np.mean(np.abs(xyz[:, 2] - PLANE_Z) < 0.3) > 0.8
    _, _, _, obj = fetch_point_cloud(os.path.join(scenes["port"],
                                                  "points3d-75.ply"))
    assert (obj > 0).any()


def test_validate_scene_reports_problems(scenes, tmp_path, capsys):
    """A scene without priors fails the contract check with exit code 2,
    and a directory without a sentinel with 1, as the JAX script does."""
    import shutil
    bad = str(tmp_path / "bad")
    shutil.copytree(scenes["port"], bad)
    shutil.rmtree(os.path.join(bad, "sky"))
    with pytest.raises(SystemExit) as e:
        validate_scene.main([bad, "--device", "cpu"])
    assert e.value.code == 2
    assert "sky/: no priors found" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        validate_scene.main([str(tmp_path), "--device", "cpu"])
    assert e.value.code == 1


def test_trainer_on_port_scene(scenes, tmp_path, monkeypatch):
    """A few iterations of the port's Trainer on the scene its chain
    wrote: every loss finite."""
    import functools
    import adgs_tpu_torch.train.trainer as trainer_mod
    from adgs_tpu_torch.data.readers import read_scene
    from adgs_tpu_torch.train.config import OptimizationConfig
    monkeypatch.setattr(trainer_mod, "MetricsLogger", functools.partial(
        trainer_mod.MetricsLogger, use_tensorboard=False))
    opt = OptimizationConfig(iterations=4, densify_from_iter=100,
                             lambda_flow=0.01)
    out = str(tmp_path / "model")
    tr = trainer_mod.Trainer(read_scene(scenes["port"]), opt, out,
                             capacity=4096, env_resolution=32,
                             capacity_quantum=1024, device="cpu")
    tr.train(iterations=4, log_every=1)
    tr.close()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["total_loss"] for r in rows if r.get("split") == "train"
              and "total_loss" in r]
    assert len(losses) == 4, rows
    assert np.isfinite(losses).all()
