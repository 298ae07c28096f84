"""Training CLI (counterpart of adgs_tpu/cli/train.py, the reference
train.py surface).

    python -m adgs_tpu_torch.cli.train -s <scene> -m <out> [-c config.py]
        [--test_iterations ...] [--save_iterations ...] [--iterations N]
        [--profile DIR] [--device cpu] ...

Takes the JAX CLI's arguments (ModelConfig and OptimizationConfig fields,
a python config file) and runs the JAX trainer's schedule on the card
unless --device says otherwise. ADGS_RM=1 selects the rows instance
layout, as for cli.render. --profile DIR writes a torch.profiler Chrome
trace of steps 20-39 into DIR, with the program's spans in it
(adgs_tpu_torch.profiling), and their summary to metrics.jsonl (split
"profile", at step 40).

Multi-device training, as the JAX command line means it: --devices D
shards each frame's tile rows over D ranks (--primitive_exchange routes
the primitives by exchange, --exchange_capacity sets its rows a pair)
and --batch_cameras B trains B cameras a step, on B * max(D, 1) ranks.
Started under a launcher that sets WORLD_SIZE (torchrun, several nodes),
each process joins its group (env://); otherwise cli.train starts that
many local ranks itself. --dist_backend: nccl (a card per rank) or gloo
(CPU ranks, and ranks that share a card); by default gloo on the CPU and
where the local ranks outnumber the cards, else nccl. Rank 0 writes the
model directory.

The model directory holds cfg_args.json and point_cloud/iteration_<N>/
{point_cloud.ply, deform.npz, env.npy, train_state.npz}, which either
package's cli.render reads. After training, cfg_args.json is written
again with the instance capacity the trainer grew to, so that cli.render
renders the model without overflow.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from ..data.readers import read_scene
from ..train.config import OptimizationConfig
from ..train.trainer import Trainer
from .common import (ModelConfig, add_dataclass_args, backend_context,
                     layout_from_env, load_config_module, merge,
                     save_cfg_args)


def dist_backend(device, local_ranks: int, asked=None) -> str:
    """The backend of a multi-device run: as asked, else gloo for CPU
    ranks and for ranks that share a card, nccl for a card each."""
    cpu = device is not None and torch.device(device).type == "cpu"
    cards = 0 if cpu else torch.cuda.device_count()
    shared = local_ranks > cards
    if asked is None:
        asked = "gloo" if cpu or shared else "nccl"
        print(f"[dist] {asked}: {local_ranks} local ranks, "
              f"{'the CPU' if cpu else f'{cards} card(s)'}")
    elif asked == "nccl" and (cpu or shared):
        raise ValueError(f"nccl needs a card per rank ({local_ranks} local "
                         f"ranks, {cards} cards); use --dist_backend gloo")
    return asked


def main(argv=None):
    """Train as the command line says; returns the trainer (None in the
    process that started the ranks of a multi-device run)."""
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
                             "to DIR, with the program's spans, and their "
                             "summary (host ms, h2d_bytes, host_syncs per "
                             "iteration) to metrics.jsonl, split profile")
    parser.add_argument("--device", default=None,
                        help="the card unless given (e.g. cpu)")
    parser.add_argument("--exchange_capacity", type=int, default=0,
                        help="primitive-exchange rows a rank pair (0: 2x "
                             "the uniform share; grown on overflow)")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"),
                        default=None)
    mc = ModelConfig()
    oc = OptimizationConfig()
    add_dataclass_args(parser, mc)
    add_dataclass_args(parser, oc)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    cfg_dict = load_config_module(args.config) if args.config else None
    model_cfg = merge(mc, cfg_dict, args)
    opt_cfg = merge(oc, cfg_dict, args)
    if not model_cfg.model_path:
        import uuid
        model_cfg = dataclasses.replace(
            model_cfg, model_path=f"./output/{uuid.uuid4().hex[:10]}")
    order_args = (cfg_dict or {}).get("order_args", model_cfg.order_args)

    world = max(model_cfg.devices, 1) * max(model_cfg.batch_cameras, 1)
    joined = False
    if world > 1 and not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            from ..parallel.launch import spawn_module
            spawn_module("adgs_tpu_torch.cli.train",
                         argv + ["--model_path", model_cfg.model_path], world)
            return None
        from ..parallel.mesh import initialize_multihost
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        initialize_multihost(dist_backend(args.device, local,
                                          args.dist_backend))
        joined = True
    main_rank = not dist.is_initialized() or dist.get_rank() == 0

    if main_rank:
        print(f"Optimizing {model_cfg.model_path}")
        save_cfg_args(model_cfg.model_path, model_cfg, opt_cfg)

    scene = read_scene(model_cfg.source_path,
                       use_colmap=model_cfg.use_colmap,
                       split_mode=model_cfg.split_mode,
                       num_cam=model_cfg.num_cam,
                       seed=args.seed)
    if main_rank:
        print(f"Cameras: train {len(scene.train_frames)} "
              f"test {len(scene.test_frames)}; extent cam "
              f"{scene.cameras_extent:.1f} scene {scene.scene_extent:.1f}; "
              f"frame_gap {scene.frame_gap:.4f}; init pts "
              f"{len(scene.points)}")

    with backend_context(model_cfg.backend):
        trainer = Trainer(
            scene, opt_cfg, model_cfg.model_path,
            order_args=order_args,
            sh_degree=model_cfg.sh_degree,
            env_resolution=model_cfg.env_resolution,
            resolution=model_cfg.resolution,
            default_order_downsample_ratio=(
                model_cfg.default_order_downsample_ratio),
            capacity=model_cfg.capacity,
            inv_depth=model_cfg.inv_depth,
            seed=args.seed,
            white_background=model_cfg.white_background,
            profile_dir=args.profile,
            devices=model_cfg.devices,
            batch_cameras=model_cfg.batch_cameras,
            device=args.device,
            layout=layout_from_env(),
            primitive_exchange=model_cfg.primitive_exchange,
            exchange_capacity=args.exchange_capacity)

        if args.start_checkpoint:
            trainer.resume(args.start_checkpoint)

        last = [opt_cfg.iterations]
        save_iters = sorted(set(args.save_iterations + last))
        test_iters = sorted(set(args.test_iterations + last))
        try:
            trainer.train(iterations=opt_cfg.iterations,
                          save_iterations=save_iters,
                          test_iterations=test_iters)
        finally:
            trainer.close()
    if main_rank and trainer.render_capacity != model_cfg.capacity:
        # a full-frame render's capacity: on a mesh, the slabs' together
        save_cfg_args(model_cfg.model_path, dataclasses.replace(
            model_cfg, capacity=trainer.render_capacity), opt_cfg)
        print(f"cfg_args.json: instance capacity {trainer.render_capacity}")
    if joined:
        dist.barrier()
        dist.destroy_process_group()
    if main_rank:
        print("\nTraining complete.")
    return trainer


if __name__ == "__main__":
    main()
