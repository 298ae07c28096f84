"""Quality convergence gate (counterpart of scripts/quality_gate.py): train
on a synthetic KITTI-format scene whose ground-truth images are renders of
a known Gaussian world, and record the test-split PSNR curve as JSON.

    python -m adgs_tpu_torch.scripts.quality_gate            # full gate
    python -m adgs_tpu_torch.scripts.quality_gate --device cpu --iters 12 \\
        --eval_every 6 --width 48 --height 32 --n_frames 6 --n_gt 300

The world is the JAX gate's, drawn from the same numpy seed in the same
order; its renders go through the plain twins (`_kernels.plain()`), so the
targets do not depend on the kernels being trained with. Training is the port's
Trainer with the JAX gate's OptimizationConfig, on the card unless
--device says otherwise. A falling or flat curve fails the gate: a
regression anywhere in the pipeline (binning, kernels, losses,
densification, optimizer) shows up there.

Writes --out (default QUALITY.json):
  {"iters": [...], "test_psnr": [...], "train_psnr": [...],
   "test_ssim": [...], "final_test_psnr": ..., "gain_db": ...,
   "monotone_ok": ..., "backend": <torch device type>}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from .. import _kernels
from .._device import resolve_device
from ..core.camera import Camera, focal2fov
from ..data import ply as ply_lib
from ..data.readers import read_scene
from ..raster.api import rasterize
from ..render import settings_for_camera
from ..train.config import OptimizationConfig
from ..train.trainer import Trainer

# instance capacity of the ground-truth renders (rasterize's default); a
# render that needs more would truncate its targets, so it raises
GT_CAPACITY = 1 << 18


def build_gt_scene(root: str, width: int, height: int, n_frames: int,
                   n_gt: int, seed: int = 0, device=None) -> int:
    """Write a KITTI-format scene directory (poses.npz, image/, depth/,
    semantic/, sky/, flow/nvs-75/, points3d-75.ply, colmap-75.ply) whose
    images are renders, on `device` (the card unless given), of a random
    static Gaussian world seen from a driving-like stereo camera path.

    The init point cloud is a subsampled, jittered copy of the world's
    means, so training is a recoverable inverse problem: PSNR must rise.
    Returns the largest num_rendered of the renders."""
    from PIL import Image

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for d in ["image", "depth", "semantic", "sky", "flow/nvs-75"]:
        os.makedirs(os.path.join(root, d), exist_ok=True)

    # --- ground-truth world: a static Gaussian "street" slab ------------
    xyz = np.zeros((n_gt, 3), np.float32)
    xyz[:, 2] = rng.uniform(3.0, 40.0, n_gt)              # depth ahead
    xyz[:, 0] = rng.uniform(-1.0, 1.0, n_gt) * xyz[:, 2] * 0.55
    xyz[:, 1] = rng.uniform(-0.6, 0.85, n_gt) * xyz[:, 2] * 0.35
    K = 16
    shs = np.zeros((n_gt, K, 3), np.float32)
    # smooth albedo field so neighbouring gaussians correlate like a scene
    freq = rng.normal(size=(3, 3)) * 0.35
    shs[:, 0] = 0.9 * np.sin(xyz @ freq.T) + rng.normal(size=(n_gt, 3)) * 0.25
    shs[:, 1:] = rng.normal(size=(n_gt, K - 1, 3)) * 0.03
    scales = (np.exp(rng.normal(size=(n_gt, 3)) * 0.35)
              * xyz[:, 2:3] * 0.012).astype(np.float32)
    quats = rng.normal(size=(n_gt, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.35, 0.95, n_gt).astype(np.float32)

    focal = 0.62 * width
    fovx, fovy = focal2fov(focal, width), focal2fov(focal, height)

    # KITTI format: stereo pairs sharing a timestamp (the reader's kitti
    # spec pins num_cam=2; the nvs-75 split holds out every 4th TIME,
    # both cameras)
    num_cam = 2
    total = n_frames * num_cam
    time_stamp = np.repeat(np.arange(n_frames), num_cam).astype(np.float64)
    t_idx = np.arange(total) // num_cam
    c_idx = np.arange(total) % num_cam
    R = np.tile(np.eye(4), (total, 1, 1))
    T = np.zeros((total, 4))
    # forward drive with slight lateral sway + a stereo baseline
    # (reader convention: x_cam = R x + T)
    T[:, 2] = 4.0 - 0.35 * t_idx
    T[:, 0] = 0.08 * np.sin(t_idx * 0.9) + 0.25 * c_idx
    np.savez(os.path.join(root, "poses.npz"), time_stamp=time_stamp,
             R=R, T=T, height=height, width=width, focal=focal)

    gt = dict(means3d=xyz, shs=shs, scales=scales, rotations=quats,
              opacities=opac)
    gt = {k: torch.as_tensor(v, device=dev) for k, v in gt.items()}
    max_rendered = 0
    for i in range(total):
        cam = Camera.create(R=R[i, :3, :3], T=T[i, :3], fovx=fovx,
                            fovy=fovy, width=width, height=height, device=dev)
        settings = settings_for_camera(cam, sh_degree=3, inv_depth=True)
        with torch.no_grad(), _kernels.plain():
            out = rasterize(settings=settings, capacity=GT_CAPACITY, **gt)
        nr = int(out.num_rendered)
        if nr > GT_CAPACITY:
            raise RuntimeError(f"ground-truth render {i}: {nr} instances, "
                               f"more than its capacity {GT_CAPACITY}")
        max_rendered = max(max_rendered, nr)
        color = out.color.cpu().numpy()
        depth = out.depth[0].cpu().numpy()
        final_t = (1.0 - out.opacity[0]).cpu().numpy()
        img = np.clip(color.transpose(1, 2, 0), 0.0, 1.0)
        name = f"{i:06d}"
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(root, "image", name + ".png"))
        np.save(os.path.join(root, "depth", name + ".npy"),
                depth[..., None].astype(np.float32))
        np.save(os.path.join(root, "semantic", "mask_" + name + ".npy"),
                np.zeros((height, width), np.int32))
        np.save(os.path.join(root, "sky", "mask_" + name + ".npy"),
                (final_t > 0.95).astype(np.uint8))
        Kmat = np.array([[focal, 0, width / 2], [0, focal, height / 2],
                         [0, 0, 1.0]])
        pkg = [np.float64(time_stamp[i]), Kmat, R[i, :3, :3], T[i, :3],
               np.zeros((2, height, width), np.float32),
               np.zeros((height, width), np.float32)]
        np.savez(os.path.join(root, "flow", "nvs-75", name + ".npz"),
                 flow=np.asarray([pkg], dtype=object))

    # --- init point cloud: recoverable-but-imperfect ---------------------
    sub = rng.permutation(n_gt)[: max(256, n_gt // 2)]
    pts = xyz[sub] + rng.normal(size=(len(sub), 3)).astype(np.float32) * 0.10
    C0 = 0.28209479177387814
    cols = np.clip(shs[sub, 0] * C0 + 0.5, 0.0, 1.0) * 255.0
    obj = (rng.random(len(sub)) < 0.25).astype(np.float32)
    tms = rng.uniform(0, n_frames - 1, len(sub)).astype(np.float32)
    ply_lib.store_point_cloud(os.path.join(root, "points3d-75.ply"),
                              pts, cols, tms, obj)
    ply_lib.store_point_cloud(os.path.join(root, "colmap-75.ply"),
                              pts[::4], cols[::4])
    return max_rendered


def gate_config(iters: int) -> OptimizationConfig:
    """The gate's schedule: densify from min(500, iters / 4) to 0.8 iters
    every 100, no opacity reset, KNN refresh every 200, no flow loss."""
    return OptimizationConfig(
        iterations=iters,
        densify_from_iter=min(500, iters // 4),
        densification_interval=100,
        densify_until_iter=int(iters * 0.8),
        opacity_reset_interval=max(3000, iters + 1),
        near_idx_reset_interval=200,
        lambda_flow=0.0,
        data_sample="stack")


def run_gate(scene_root: str, out_dir: str, iters: int, eval_every: int,
             capacity: int = 1 << 15, env_resolution: int = 512,
             device=None) -> dict:
    """Train the scene for `iters` iterations, evaluating at 1, every
    `eval_every` and the last; returns the curve read back from
    metrics.jsonl."""
    scene = read_scene(scene_root)
    tr = Trainer(scene, gate_config(iters), out_dir, capacity=capacity,
                 env_resolution=env_resolution, capacity_quantum=1024,
                 device=device)
    evals = sorted({1, *range(eval_every, iters + 1, eval_every), iters})
    try:
        tr.train(iterations=iters, save_iterations=[iters],
                 test_iterations=evals)
    finally:
        tr.close()
    rows = []
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        for line in f:
            rows.append(json.loads(line))
    curve = {"iters": [], "test_psnr": [], "train_psnr": [],
             "test_ssim": []}
    for it in evals:
        te = [r for r in rows if r.get("step") == it
              and r.get("split") == "test" and "psnr" in r]
        trn = [r for r in rows if r.get("step") == it
               and r.get("split") == "train" and "psnr" in r]
        if te:
            curve["iters"].append(it)
            curve["test_psnr"].append(round(te[-1]["psnr"], 3))
            curve["test_ssim"].append(round(te[-1]["ssim"], 4))
            curve["train_psnr"].append(
                round(trn[-1]["psnr"], 3) if trn else None)
    return curve


def summarize(curve: dict, device_type: str) -> dict:
    """The curve with the gate's verdicts: final test PSNR, gain over the
    curve (None below two points) and monotonicity (every point within
    0.5 dB of the best seen so far, for evaluation noise)."""
    t = curve["test_psnr"]
    result = dict(curve)
    result["final_test_psnr"] = t[-1] if t else None
    result["gain_db"] = round(t[-1] - t[0], 3) if len(t) > 1 else None
    result["monotone_ok"] = bool(all(t[i] >= max(t[: i + 1]) - 0.5
                                     for i in range(len(t))))
    result["backend"] = device_type
    return result


def check_gate(result: dict, min_gain_db: float, min_final_db: float):
    """The gate's assertions; raises AssertionError on the first failed."""
    t = result["test_psnr"]
    if not t:
        raise AssertionError("no test PSNR rows recorded")
    if not np.isfinite(t).all():
        raise AssertionError(f"non-finite PSNR: {t}")
    if len(t) < 2:
        raise AssertionError(f"too few evaluation points for a gain: "
                             f"iterations {result['iters']}")
    if not result["monotone_ok"]:
        raise AssertionError(f"test PSNR not monotone-rising: {t}")
    if result["gain_db"] < min_gain_db:
        raise AssertionError(f"gain {result['gain_db']} dB < {min_gain_db}")
    if t[-1] < min_final_db:
        raise AssertionError(f"final PSNR {t[-1]} < {min_final_db}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--eval_every", type=int, default=250)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=160)
    p.add_argument("--n_frames", type=int, default=16)
    p.add_argument("--n_gt", type=int, default=6000)
    p.add_argument("--out", default="QUALITY.json")
    p.add_argument("--scene_dir", default=None,
                   help="keep/reuse the generated scene here")
    p.add_argument("--min_gain_db", type=float, default=4.0)
    p.add_argument("--min_final_db", type=float, default=22.0)
    p.add_argument("--no-assert", dest="do_assert", action="store_false")
    p.add_argument("--device", default=None,
                   help="the card unless given (e.g. cpu)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"# device: {dev} ({name})", file=sys.stderr)

    ctx = (tempfile.TemporaryDirectory() if args.scene_dir is None
           else None)
    base = ctx.name if ctx is not None else args.scene_dir
    try:
        scene_root = os.path.join(base, "scene")
        if not os.path.exists(os.path.join(scene_root, "poses.npz")):
            build_gt_scene(scene_root, args.width, args.height,
                           args.n_frames, args.n_gt, device=dev)
        curve = run_gate(scene_root, os.path.join(base, "out"),
                         args.iters, args.eval_every, device=dev)
    finally:
        if ctx is not None:
            ctx.cleanup()

    result = summarize(curve, dev.type)
    print(json.dumps(result))
    with open(args.out, "w") as f:
        json.dump(result, f)
    if args.do_assert:
        check_gate(result, args.min_gain_db, args.min_final_db)
        print("QUALITY GATE OK", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
