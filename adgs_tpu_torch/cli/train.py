"""Training CLI (counterpart of adgs_tpu/cli/train.py, the reference
train.py surface).

    python -m adgs_tpu_torch.cli.train -s <scene> -m <out> [-c config.py]
        [--test_iterations ...] [--save_iterations ...] [--iterations N]
        [--profile DIR] [--device cpu] ...

Takes the JAX CLI's arguments (ModelConfig and OptimizationConfig fields,
a python config file) and runs the JAX trainer's schedule on one device:
the card unless --device says otherwise. ADGS_RM=1 selects the rows
instance layout, as for cli.render. --profile DIR writes a torch.profiler
Chrome trace of steps 20-39 into DIR.

The model directory holds cfg_args.json and point_cloud/iteration_<N>/
{point_cloud.ply, deform.npz, env.npy, train_state.npz}, which either
package's cli.render reads. After training, cfg_args.json is written
again with the instance capacity the trainer grew to, so that cli.render
renders the model without overflow.
"""

from __future__ import annotations

import argparse
import dataclasses

from ..data.readers import read_scene
from ..train.config import OptimizationConfig
from ..train.trainer import Trainer
from .common import (ModelConfig, add_dataclass_args, layout_from_env,
                     load_config_module, merge, render_backend,
                     save_cfg_args)


def main(argv=None) -> Trainer:
    """Train as the command line says; returns the trainer."""
    parser = argparse.ArgumentParser(description="adgs_tpu_torch training")
    parser.add_argument("--config", "-c", type=str, default=None)
    parser.add_argument("--source_path", "-s", dest="source_path", type=str,
                        default=None)
    parser.add_argument("--model_path", "-m", dest="model_path", type=str,
                        default=None)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--start_checkpoint", type=str, default=None,
                        help="train_state.npz to resume from")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler trace of steps 20-39 "
                             "to DIR")
    parser.add_argument("--device", default=None,
                        help="the card unless given (e.g. cpu)")
    mc = ModelConfig()
    oc = OptimizationConfig()
    add_dataclass_args(parser, mc)
    add_dataclass_args(parser, oc)
    args = parser.parse_args(argv)

    cfg_dict = load_config_module(args.config) if args.config else None
    model_cfg = merge(mc, cfg_dict, args)
    opt_cfg = merge(oc, cfg_dict, args)
    if not model_cfg.model_path:
        import uuid
        model_cfg = dataclasses.replace(
            model_cfg, model_path=f"./output/{uuid.uuid4().hex[:10]}")
    order_args = (cfg_dict or {}).get("order_args", model_cfg.order_args)

    print(f"Optimizing {model_cfg.model_path}")
    save_cfg_args(model_cfg.model_path, model_cfg, opt_cfg)

    scene = read_scene(model_cfg.source_path,
                       use_colmap=model_cfg.use_colmap,
                       split_mode=model_cfg.split_mode,
                       num_cam=model_cfg.num_cam,
                       seed=args.seed)
    print(f"Cameras: train {len(scene.train_frames)} "
          f"test {len(scene.test_frames)}; extent cam "
          f"{scene.cameras_extent:.1f} scene {scene.scene_extent:.1f}; "
          f"frame_gap {scene.frame_gap:.4f}; init pts {len(scene.points)}")

    trainer = Trainer(
        scene, opt_cfg, model_cfg.model_path,
        order_args=order_args,
        sh_degree=model_cfg.sh_degree,
        env_resolution=model_cfg.env_resolution,
        resolution=model_cfg.resolution,
        default_order_downsample_ratio=model_cfg.default_order_downsample_ratio,
        backend=render_backend(model_cfg.backend),
        capacity=model_cfg.capacity,
        inv_depth=model_cfg.inv_depth,
        seed=args.seed,
        white_background=model_cfg.white_background,
        profile_dir=args.profile,
        devices=model_cfg.devices,
        batch_cameras=model_cfg.batch_cameras,
        device=args.device,
        layout=layout_from_env())

    if args.start_checkpoint:
        trainer.resume(args.start_checkpoint)

    save_iters = sorted(set(args.save_iterations + [opt_cfg.iterations]))
    test_iters = sorted(set(args.test_iterations + [opt_cfg.iterations]))
    try:
        trainer.train(iterations=opt_cfg.iterations,
                      save_iterations=save_iters, test_iterations=test_iters)
    finally:
        trainer.close()
    if trainer.capacity != model_cfg.capacity:
        save_cfg_args(model_cfg.model_path, dataclasses.replace(
            model_cfg, capacity=trainer.capacity), opt_cfg)
        print(f"cfg_args.json: instance capacity {trainer.capacity}")
    print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
