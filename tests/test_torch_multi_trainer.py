"""The port's multi-device entry points on gloo CPU ranks.

cli.train --devices 2 --device cpu: the port's trainer on two gloo CPU
ranks that cli.train starts itself, on tests/test_data_cli.py's KITTI
scene at 64x48. Densify, KNN refresh and an opacity reset fire, an
exchange capacity of 8 rows a pair overflows and grows, and so does the
instance capacity; every densify's fingerprint check finds both ranks'
models bitwise equal; only rank 0 writes (one metrics line per logged
step, one checkpoint); cli.render of the checkpoint (one device) gives
the PSNR that rank 0's evaluation logged; the logged splat instances, both slabs'
sum, lie between the larger slab's count and twice it. And scripts/bench_scaling.py
on one and two CPU ranks."""

import json
import os

import numpy as np

from adgs_tpu_torch.cli import common as tcommon
from tests.test_data_cli import make_kitti_scene
from tests.test_torch_trainer import ORDER, _no_lpips, _smooth_images

W, H = 64, 48


def test_cli_train_two_ranks(tmp_path, monkeypatch, capfd):
    from adgs_tpu_torch.cli import render as render_cli
    from adgs_tpu_torch.cli import train as train_cli
    _no_lpips(monkeypatch, tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    root = make_kitti_scene(str(tmp_path / "scene"), width=W, height=H)
    _smooth_images(root)
    out = str(tmp_path / "out")
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "iterations = 12\n"
        "env_resolution = 32\n"
        "capacity = 512\n"
        "densify_from_iter = 0\n"
        "densification_interval = 4\n"
        "opacity_reset_interval = 8\n"
        "near_idx_reset_interval = 5\n"
        "densify_scene_grad_threshold = 1e-6\n"
        "densify_obj_grad_threshold = 1e-6\n"
        f"order_args = {ORDER!r}\n")
    assert train_cli.main([
        "-s", root, "-m", out, "-c", str(cfg), "--devices", "2",
        "--device", "cpu", "--exchange_capacity", "8",
        "--test_iterations", "12"]) is None
    text = capfd.readouterr()
    logs = text.out + text.err
    assert "[dist] gloo: 2 local ranks, the CPU" in logs
    # densify at 4, 8 and 12, each checked across the ranks
    checks = [ln for ln in logs.splitlines() if ln.startswith("[replicas]")]
    assert len(checks) == 3 and all("bitwise equal" in c for c in checks)
    assert "[autotune] exchange_capacity -> 16" in logs
    assert "[capacity] instance capacity grew to" in logs

    recs = [json.loads(line) for line in open(os.path.join(out,
                                                           "metrics.jsonl"))]
    train = [r for r in recs if "total_loss" in r]
    assert [r["step"] for r in train] == [10], train     # rank 0's only
    assert all(np.isfinite(r["total_loss"]) for r in train)
    # the step's splat instances add up both slabs; num_rendered is the
    # larger slab's (what sizes each rank's instance capacity)
    for r in train:
        assert r["num_rendered"] <= r["splat_instances"] \
            <= 2 * r["num_rendered"]
    psnr = {r["step"]: r["psnr"] for r in recs if r["split"] == "test"}
    assert list(psnr) == [12]
    assert sorted(os.listdir(os.path.join(out, "point_cloud"))) == [
        "iteration_12"]

    model_cfg, _ = tcommon.load_cfg_args(out)
    assert model_cfg.devices == 2 and model_cfg.capacity > 512
    render_cli.main(["-m", out, "--skip_train", "--device", "cpu"])
    res = json.load(open(os.path.join(out, "results.json")))["ours_12"]
    np.testing.assert_allclose(res["PSNR"], psnr[12], rtol=0, atol=1e-3)


def test_bench_scaling_on_cpu_ranks(monkeypatch, capsys):
    """scripts/bench_scaling.py with --force_cpu_devices 2: a line for 1
    and 2 gloo CPU ranks, each labelled structural, the same step loss at
    both counts."""
    from adgs_tpu_torch.scripts import bench_scaling
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    bench_scaling.main(["--force_cpu_devices", "2", "--n_gauss", "2000",
                        "--width", "48", "--height", "32", "--iters", "1"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [r["devices"] for r in lines] == [1, 2]
    assert all(r["structural"] and r["device"] == "CPU" for r in lines)
    assert all(r["pixels_per_sec"] > 0 for r in lines)
    np.testing.assert_allclose(lines[1]["loss"], lines[0]["loss"], rtol=1e-5)
