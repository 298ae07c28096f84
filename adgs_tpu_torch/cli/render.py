"""Evaluation/render CLI (counterpart of adgs_tpu/cli/render.py, the
reference render.py:155-214 surface).

    python -m adgs_tpu_torch.cli.render -m <model_path> [--mode render]
        [--skip_train] [--skip_test] [--iteration N] [--device cpu]

Modes:
  render  — render train/test splits, metrics into results.json
  deform  — motion-magnitude visualization (override_color)
  time    — 150-step time interpolation on one fixed camera
  env     — export the environment map as a colored point cloud PLY

The model path holds what either package's trainer writes: cfg_args.json
and point_cloud/iteration_<N>/{point_cloud.ply, deform.npz, env.npy}.
ADGS_RM=1 in the environment selects the compositor's "rows" instance
layout, as it does for the JAX package (cli/common.layout_from_env).
--device defaults to the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import time as time_mod

import numpy as np
import torch

from .._device import resolve_device
from ..data.frames import load_frame
from ..data.ply import store_point_cloud
from ..data.readers import read_scene
from ..models import gaussians as gm
from ..models.env_map import angles_to_direction, camera_rays
from ..ops.image import psnr, ssim
from ..train import checkpoint as ckpt_lib
from .. import render as render_lib
from .common import backend_context, layout_from_env, load_cfg_args


def _latest_iteration(model_path: str) -> int:
    base = os.path.join(model_path, "point_cloud")
    iters = [int(d.split("_")[-1]) for d in os.listdir(base)
             if d.startswith("iteration_")]
    return max(iters)


def _to_uint8(img: torch.Tensor) -> np.ndarray:
    return (np.clip(img.detach().cpu().numpy().transpose(1, 2, 0), 0, 1)
            * 255).astype(np.uint8)


def _save_png(path: str, img: torch.Tensor) -> None:
    from PIL import Image
    Image.fromarray(_to_uint8(img)).save(path)


def _lpips_fns(device):
    """(vgg_fn, alex_fn) or Nones when pretrained weights are unavailable
    (ops/lpips.py). The miss is loud: a headline metric silently missing
    from results.json hides a broken evaluation setup."""
    from ..ops.lpips import lpips_fn
    vgg, alex = lpips_fn("vgg", device=device), lpips_fn("alex", device=device)
    if vgg is None or alex is None:
        print("WARNING: LPIPS weights not found (set ADGS_LPIPS_WEIGHTS or "
              "export them with tools/export_lpips_weights.py on a machine "
              "with torchvision); results.json will omit LPIPS",
              file=sys.stderr)
    return vgg, alex


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rig_groups(frames) -> list:
    """Runs of consecutive frames that share one time (a camera rig at one
    timestamp), each served as one frame: one deformation for the rig."""
    groups: list = []
    for fr in frames:
        if groups and groups[-1][0].time == fr.time:
            groups[-1].append(fr)
        else:
            groups.append([fr])
    return groups


def render_set(model_path, name, iteration, frames, params, state, config,
               env, model_cfg, active_sh, device, layout="gather",
               cal_metrics=True, output_video=False, cam_order=()):
    render_path = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)

    psnrs, ssims, lpips_vgg, lpips_alex = [], [], [], []
    lp_vgg, lp_alex = _lpips_fns(device)
    total_time = 0.0
    rays_cache = {}
    renderings: dict = {}
    render_fn = render_lib.make_staged_render_fn(
        config, active_sh_degree=active_sh, inv_depth=model_cfg.inv_depth,
        capacity=model_cfg.capacity, layout=layout)
    idx = 0
    for rig in rig_groups(frames):
        loaded = [load_frame(fr, model_cfg.resolution, device=device)
                  for fr in rig]
        for fr, (cam, _, _) in zip(rig, loaded):
            if fr.cam_id not in rays_cache:
                rays_cache[fr.cam_id] = torch.as_tensor(
                    camera_rays(cam.focal_x, cam.height, cam.width),
                    dtype=torch.float32, device=device)
        t0 = time_mod.time()
        outs = render_fn([cam for cam, _, _ in loaded], params, state, env,
                         [rays_cache[fr.cam_id] for fr in rig])
        imgs = [torch.clamp(out["render"], 0.0, 1.0) for out in outs]
        _sync(device)
        total_time += time_mod.time() - t0
        for fr, (_, batch, _), img in zip(rig, loaded, imgs):
            if cal_metrics:
                psnrs.append(float(psnr(img, batch.image)))
                ssims.append(float(ssim(img, batch.image)))
                if lp_vgg is not None:
                    lpips_vgg.append(float(lp_vgg(img, batch.image)))
                if lp_alex is not None:
                    lpips_alex.append(float(lp_alex(img, batch.image)))
            _save_png(os.path.join(render_path, f"{idx:05d}.png"), img)
            _save_png(os.path.join(gts_path, f"{idx:05d}.png"), batch.image)
            if output_video:
                renderings.setdefault(fr.cam_id, []).append(_to_uint8(img))
            idx += 1

    if output_video and renderings:
        # per-camera videos concatenated side by side (render.py:72-86)
        import imageio
        order = list(cam_order) or sorted(renderings.keys())
        video = np.concatenate(
            [np.stack(renderings[c]) for c in order], axis=2)
        vpath = os.path.join(model_path, name, f"ours_{iteration}",
                             "video.mp4")
        imageio.mimwrite(vpath, video, fps=10, quality=8)
        print("wrote", vpath)

    if cal_metrics and frames:
        fps = len(frames) / total_time
        entry = {"SSIM": float(np.mean(ssims)), "PSNR": float(np.mean(psnrs)),
                 "FPS": fps}
        if lpips_vgg:
            entry["LPIPS(VGG)"] = float(np.mean(lpips_vgg))
        if lpips_alex:
            entry["LPIPS(ALEX)"] = float(np.mean(lpips_alex))
        res = {f"ours_{iteration}": entry}
        print(name, json.dumps(res, indent=1))
        out_name = "results.json" if name == "test" else "results-train.json"
        with open(os.path.join(model_path, out_name), "w") as f:
            json.dump(res, f, indent=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description="adgs_tpu_torch rendering")
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--mode", default="render", type=str)
    parser.add_argument("--source_path", "-s", default=None)
    parser.add_argument("--video", "-v", action="store_true")
    parser.add_argument("--cam_order", nargs="+", type=int, default=[])
    parser.add_argument("--device", default=None,
                        help="the card unless given (e.g. cpu)")
    args = parser.parse_args(argv)
    model_cfg, _ = load_cfg_args(args.model_path)
    if args.source_path:
        model_cfg = dataclasses.replace(model_cfg,
                                        source_path=args.source_path)
    with backend_context(model_cfg.backend):
        _run(args, model_cfg)


def _run(args, model_cfg):
    """main's mode on the loaded model."""
    device = resolve_device(args.device)
    layout = layout_from_env()
    iteration = (args.iteration if args.iteration > 0
                 else _latest_iteration(args.model_path))
    base = os.path.join(args.model_path, "point_cloud",
                        f"iteration_{iteration}")

    scene = read_scene(model_cfg.source_path, use_colmap=model_cfg.use_colmap,
                       split_mode=model_cfg.split_mode,
                       num_cam=model_cfg.num_cam, load_priors=False)
    cfg0 = gm.GaussianConfig.from_order_args(
        model_cfg.order_args or dict(
            xyz=[None, 5, 0, 6, 0, 0], rotation=[0, 0, 0, 0, None, 5],
            shs=[0, 0, 0, 6, 0, 0], background=[0, 0, 0, 0, 0, 0]),
        int(round(1.0 / scene.frame_gap)),
        model_cfg.default_order_downsample_ratio,
        sh_degree=model_cfg.sh_degree)
    params, state, config = ckpt_lib.load_ply(
        os.path.join(base, "point_cloud.ply"), cfg0, device=device)
    env = ckpt_lib.load_env(os.path.join(base, "env.npy"), device=device)
    active_sh = config.sh_degree

    if args.mode == "render":
        if not args.skip_train:
            render_set(args.model_path, "train", iteration,
                       scene.train_frames, params, state, config, env,
                       model_cfg, active_sh, device, layout,
                       output_video=args.video, cam_order=args.cam_order)
        if not args.skip_test:
            render_set(args.model_path, "test", iteration, scene.test_frames,
                       params, state, config, env, model_cfg, active_sh,
                       device, layout, output_video=args.video,
                       cam_order=args.cam_order)
    elif args.mode == "deform":
        # render_deform (render.py:108-137): per-Gaussian motion magnitude
        # between t and t+dt as override color on the foreground
        frames = scene.train_frames
        out_dir = os.path.join(args.model_path, "train",
                               f"ours_{iteration}", "deform")
        os.makedirs(out_dir, exist_ok=True)
        rays_cache = {}
        for idx, fr in enumerate(frames):
            cam, _, _ = load_frame(fr, model_cfg.resolution, device=device)
            with torch.no_grad():
                x1 = gm.deformed_xyz(params, config, _f32(fr.time, device))
                x2 = gm.deformed_xyz(params, config, _f32(
                    fr.time + 1.0 / len(frames), device))
                d = torch.abs(x2 - x1) * len(frames)
                d = (d - d.min()) / torch.clamp(d.max() - d.min(), min=1e-12)
                if fr.cam_id not in rays_cache:
                    rays_cache[fr.cam_id] = torch.as_tensor(
                        camera_rays(cam.focal_x, cam.height, cam.width),
                        dtype=torch.float32, device=device)
                out = render_lib.render(
                    cam, params, state, config, env_map=env,
                    cam_rays=rays_cache[fr.cam_id],
                    override_color=torch.clamp(d, 0.0, 1.0),
                    active_sh_degree=active_sh,
                    capacity=model_cfg.capacity, layout=layout)
            _save_png(os.path.join(out_dir, f"{idx:05d}.png"),
                      out["foreground"])
        print("saved deform renders to", out_dir)
    elif args.mode == "time":
        frames = scene.train_frames
        fr = frames[random.randint(0, len(frames) - 1)]
        num = 150
        views = [fr._replace(time=i / num) for i in range(num)]
        render_set(args.model_path, "interp_time", iteration, views, params,
                   state, config, env, model_cfg, active_sh, device, layout,
                   cal_metrics=False)
    elif args.mode == "env":
        out_dir = os.path.join(args.model_path, "env", f"ours_{iteration}")
        os.makedirs(out_dir, exist_ok=True)
        rng = np.random.default_rng(0)
        n = 500_000
        ang = np.stack([rng.uniform(-np.pi, np.pi, n),
                        rng.uniform(-np.pi / 2, np.pi / 2, n)], -1)
        ang_t = torch.as_tensor(ang, dtype=torch.float32, device=device)
        with torch.no_grad():
            rgb = env.color(ang_t, input_angle=True)
            pts = angles_to_direction(ang_t)
        store_point_cloud(os.path.join(out_dir, "env_map.ply"),
                          pts.cpu().numpy(), rgb.cpu().numpy().T * 255.0)
        print("saved", os.path.join(out_dir, "env_map.ply"))
    else:
        raise SystemExit(f"unsupported mode: {args.mode}")


if __name__ == "__main__":
    main()
