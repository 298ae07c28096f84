"""Host-side training orchestration (counterpart of
adgs_tpu/train/trainer.py).

Camera-stack sampling, flow-package selection, SH degree warm-up, the
densify / opacity-reset / KNN-refresh schedule, instance and Gaussian
capacity growth, evaluation, failure snapshots, checkpoints and metrics
(JSONL, plus TensorBoard where torch.utils.tensorboard imports), around
the step of train/step.py.

Random state is explicit and owned by the trainer: `rng`
(random.Random(seed): camera picks and flow packages, the same picks as
the JAX trainer), `np_rng` (np.random.default_rng(seed): the host KNN
refresh's anchors) and `generator` (a torch.Generator on the device,
seeded with `seed`, in place of the JAX trainer's PRNG key: the device
KNN refresh's anchors and the split's draws).

The hot loop reads two values from the card each step, as the JAX
trainer does: the loss and num_rendered (for the overflow guard; on a
mesh it comes in one copy with the step's splat instances, the sum over
its cameras' slabs). A densify adds one read of its report (the profiling
counters densify_cloned, _split, _pruned, _dropped) besides the capacity
check's.

Multi-device training (devices > 1 or batch_cameras > 1) runs one
trainer per rank of a joined process group (parallel/mesh.py; cli.train
starts the ranks): every rank holds the replicated model, draws the same
cameras and the same densify, reset and refresh randoms (same seeds, same
inputs, bitwise-equal parameters, which a fingerprint check after every
densify holds), and runs parallel/shard.py's sharded step. Only rank 0
writes files (metrics, TensorBoard, checkpoints, failure snapshots) and
evaluates; the others wait at a barrier. The exchange-overflow flag is
read every step, as the instance-overflow flag is.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..data.frames import flow_package, load_frame
from ..data.readers import SceneData
from ..models import gaussians as gm
from ..models.env_map import EnvironmentMap, camera_rays
from ..ops import knn
from ..ops.image import psnr
from .. import profiling
from ..profiling import copied_in, count, span, trace
from .. import render as render_lib
from . import checkpoint as ckpt_lib
from . import densify as densify_lib
from .config import OptimizationConfig
from .optim import TrainableState, init_adam, leaves
from .step import make_train_step

DEFAULT_ORDER_ARGS = dict(xyz=[None, 5, 0, 6, 0, 0],
                          rotation=[0, 0, 0, 0, None, 5],
                          shs=[0, 0, 0, 6, 0, 0],
                          background=[0, 0, 0, 0, 0, 0])


class MetricsLogger:
    """JSONL scalars, and TensorBoard where it imports."""

    def __init__(self, model_path: str, use_tensorboard: bool = True):
        os.makedirs(model_path, exist_ok=True)
        self.f = open(os.path.join(model_path, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb = SummaryWriter(model_path)

    def scalars(self, step: int, values: dict, prefix: str = "train"):
        """values: {name: number or 0-d tensor} (a tensor on a card is
        read once, a host sync each)."""
        count("host_syncs", sum(isinstance(v, torch.Tensor)
                                for v in values.values()))
        values = {k: float(v) for k, v in values.items()}
        rec = {"step": step, "split": prefix}
        rec.update(values)
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(f"{prefix}/{k}", v, step)

    def image(self, step: int, tag: str, img: np.ndarray):
        """img: [3, H, W] or [H, W] float in [0, 1] -> TensorBoard."""
        if self.tb is None:
            return
        if img.ndim == 2:
            img = np.repeat(img[None], 3, axis=0)
        self.tb.add_image(tag, np.clip(img, 0.0, 1.0), step)

    def flush(self):
        self.f.flush()
        if self.tb is not None:
            self.tb.flush()

    def close(self):
        self.f.close()
        if self.tb is not None:
            self.tb.close()


class _NoLogger:
    """The logger of the ranks that write nothing."""

    tb = None

    def scalars(self, *args, **kw):
        pass

    image = flush = close = scalars


class Trainer:
    """layout: the compositor's instance layout, "gather" or "rows".
    device: None means the card (on a mesh: this rank's card).

    devices > 1: a "tile" mesh of that many ranks (tile-row sharding, the
    primitives sharded 1/D, routed by all-gather or, with
    primitive_exchange, by the exchange of exchange_capacity rows a pair
    (0: shard.default_exchange_capacity)); batch_cameras B > 1 adds a
    "data" axis of B cameras a step. Both need the process group joined
    with B * max(devices, 1) ranks."""

    def __init__(self, scene: SceneData, opt: OptimizationConfig,
                 model_path: str,
                 order_args: Optional[dict] = None,
                 sh_degree: int = 3,
                 env_resolution: int = 8192,
                 resolution: int = 1,
                 default_order_downsample_ratio: int = 3,
                 capacity: int = 1 << 18,
                 inv_depth: bool = True,
                 seed: int = 0,
                 capacity_quantum: int = 4096,
                 white_background: bool = False,
                 profile_dir: Optional[str] = None,
                 devices: int = 0,
                 batch_cameras: int = 1,
                 device=None,
                 layout: str = "gather",
                 primitive_exchange: bool = False,
                 exchange_capacity: int = 0):
        self.devices = int(devices)
        self.primitive_exchange = primitive_exchange
        self.exchange_capacity = int(exchange_capacity)
        self.batch_cameras = max(int(batch_cameras), 1)
        self.mesh = None
        self.tile_d = max(self.devices, 1)
        if self.devices > 1 or self.batch_cameras > 1:
            from ..parallel.mesh import make_mesh
            if not dist.is_initialized():
                raise RuntimeError(
                    "multi-device training runs one process per device: "
                    "join the process group first (parallel.mesh."
                    "initialize_multihost; cli.train starts the ranks)")
            if capacity_quantum % self.tile_d:
                raise ValueError(
                    f"capacity_quantum {capacity_quantum} must divide by "
                    f"devices {self.tile_d} (1/D primitive sharding)")
            shape = {"data": self.batch_cameras} if self.batch_cameras > 1 \
                else {}
            shape["tile"] = self.tile_d
            self.mesh = make_mesh(shape, device)
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.replica_checks = 0
        self.scene = scene
        self.opt = opt
        self.model_path = model_path
        self.capacity = capacity
        self.inv_depth = inv_depth
        self.white_background = white_background
        self.resolution = resolution
        self.capacity_quantum = capacity_quantum
        self.profile_dir = profile_dir
        self.layout = layout
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        order_args = order_args or DEFAULT_ORDER_ARGS
        frame_num = int(round(1.0 / scene.frame_gap))
        self.config = gm.GaussianConfig.from_order_args(
            order_args, frame_num, default_order_downsample_ratio,
            sh_degree=sh_degree, use_time_mask=opt.lambda_sigma > 0.0)

        d2 = knn.mean_knn_sq_dist(scene.points)
        params, state = gm.create_from_pcd(
            scene.points, scene.colors, scene.obj_id, scene.times,
            self.config, d2, capacity_quantum=capacity_quantum, seed=seed,
            device=self.device)
        self.params = gm.set_init_time_sigma(params, scene.frame_gap)
        self.state = state
        self.env = EnvironmentMap.create(env_resolution, seed=seed,
                                         device=self.device)
        self.opt_state = init_adam(TrainableState(self.params, self.env))

        self.use_near_idx = (opt.lambda_reg > 0.0
                             or (opt.lambda_sigma > 0.0
                                 and opt.lambda_sigma_reg > 0.0))
        self.cameras_extent = max(scene.cameras_extent, opt.min_camera_extent)
        self.logger = MetricsLogger(model_path) if self.is_main \
            else _NoLogger()
        self._step_fn = None
        self._ray_cache: dict = {}
        self.active_sh_degree = 0
        self.iteration = 0
        # the largest num_rendered of a step since the last densify
        self._max_rendered = 0
        # frames loaded on first use; also holds the evaluation render
        # functions under ("eval", sh_degree)
        self._frame_cache: dict = {}

    # ------------------------------------------------------------------
    def _get_frame(self, split: str, idx: int):
        keyed = (split, idx)
        if keyed not in self._frame_cache:
            frames = (self.scene.train_frames if split == "train"
                      else self.scene.test_frames)
            self._frame_cache[keyed] = load_frame(
                frames[idx], self.resolution, device=self.device)
        return self._frame_cache[keyed]

    def _rays_for(self, cam, cam_id: int) -> torch.Tensor:
        if cam_id not in self._ray_cache:
            self._ray_cache[cam_id] = torch.as_tensor(
                camera_rays(cam.focal_x, cam.height, cam.width),
                dtype=torch.float32, device=self.device)
            copied_in(self._ray_cache[cam_id])
        return self._ray_cache[cam_id]

    def _frames_for_step(self, picks: list, opt):
        """The step's (camera, batch, rays) for picks = [frame index, ...],
        stacked when batch_cameras > 1. When flow supervision is on and a
        frame has flow packages, one is drawn with `rng`; in a stack the
        frames without one get a zero package gated off by flow_valid, so
        that the stack has one structure."""
        frames = self.scene.train_frames
        loaded = [self._get_frame("train", i) for i in picks]
        want_flow = opt.lambda_flow > 0.0 and any(fl for _, _, fl in loaded)
        cams, batches, rays = [], [], []
        for i, (cam, batch, flow_list) in zip(picks, loaded):
            if want_flow and flow_list:
                raw = flow_list[self.rng.randrange(len(flow_list))]
                batch = batch._replace(
                    flow=flow_package(raw, device=self.device),
                    flow_valid=torch.tensor(True, device=self.device))
                copied_in(batch.flow_valid)
            elif want_flow:
                from ..ops.flow import FlowPackage
                H, W = batch.depth.shape
                z = torch.zeros
                batch = batch._replace(
                    flow=FlowPackage(
                        time=cam.time.clone(),
                        K=torch.eye(3, device=self.device),
                        R=torch.eye(3, device=self.device),
                        T=z(3, device=self.device),
                        flow=z((2, H, W), device=self.device),
                        vis=z((H, W), device=self.device)),
                    flow_valid=torch.tensor(False, device=self.device))
                copied_in(batch.flow_valid)
            cams.append(cam)
            batches.append(batch)
            rays.append(self._rays_for(cam, frames[i].cam_id))
        if self.batch_cameras == 1:
            return cams[0], batches[0], rays[0]
        from ..parallel.data_parallel import stack_batches, stack_cameras
        return stack_cameras(cams), stack_batches(batches), torch.stack(rays)

    def _build_step(self):
        if self.mesh is not None:
            from ..parallel.shard import (default_exchange_capacity,
                                          make_sharded_train_step)
            if not self.exchange_capacity:
                self.exchange_capacity = default_exchange_capacity(
                    self.params.capacity // self.tile_d, self.tile_d)
            self._step_fn = make_sharded_train_step(
                self.config, self.opt, self.scene.frame_gap,
                self.scene.scene_extent, self.scene.cameras_extent,
                mesh=self.mesh, capacity=self.capacity,
                inv_depth=self.inv_depth, layout=self.layout,
                primitive_exchange=self.primitive_exchange,
                exchange_capacity=self.exchange_capacity,
                data_axis="data" if self.batch_cameras > 1 else None)
            return
        self._step_fn = make_train_step(
            self.config, self.opt, self.scene.frame_gap,
            self.scene.scene_extent, self.scene.cameras_extent,
            capacity=self.capacity, inv_depth=self.inv_depth,
            layout=self.layout)

    @property
    def render_capacity(self) -> int:
        """The instance capacity of a full-frame render on one device: on
        a mesh, `capacity` bounds one slab's instances, and the slabs'
        counts add up to the frame's."""
        return self.capacity * self.tile_d

    def _say(self, msg: str, **kw) -> None:
        if self.is_main:
            print(msg, **kw)

    def _sync(self) -> None:
        """The ranks that write nothing wait here for rank 0."""
        if self.mesh is not None:
            dist.barrier()

    def check_replicas(self, what: str) -> None:
        """Every rank must hold bitwise the same model: an integer
        fingerprint of every parameter, moment and state tensor, compared
        across the ranks. Raises where they differ."""
        if self.mesh is None:
            return
        from ..parallel.mesh import check_replicas
        tensors = (leaves(TrainableState(self.params, self.env))
                   + leaves(self.opt_state.m) + leaves(self.opt_state.v)
                   + [getattr(self.state, f.name)
                      for f in dataclasses.fields(self.state)])
        check_replicas(tensors, what)
        self.replica_checks += 1
        self._say(f"[replicas] {what}: {self.mesh.size} ranks' "
                  f"{len(tensors)} tensors bitwise equal")

    def refresh_near_idx(self):
        """set_obj_near_idx: random alive anchors and their K nearest
        object Gaussians in xyz (+ time * scene_extent when time-masked).
        By default on the device (ops/knn.near_idx_device, anchors drawn
        with `generator`); ADGS_KNN_HOST=1 takes the exact host path
        (scipy, anchors drawn with `np_rng`)."""
        if not self.use_near_idx:
            return
        with span("trainer.refresh"):
            K = self.opt.near_num
            a_cap = max(1, self.params.obj_capacity // K)
            if not int(os.environ.get("ADGS_KNN_HOST", "0")):
                pts = self.params.obj_xyz
                if self.config.use_time_mask:
                    pts = torch.cat([pts, self.state.gs_time[:, None]
                                     * self.scene.scene_extent], dim=1)
                r = torch.rand((pts.shape[0],), generator=self.generator,
                               device=self.device)
                idx, valid = knn.near_idx_device(pts, self.state.obj_alive,
                                                 r, K, a_cap)
                self.state = dataclasses.replace(
                    self.state, obj_near_idx=idx, obj_near_valid=valid)
                return
            oa = self.state.obj_alive.cpu().numpy()
            count("host_syncs")
            idx_alive = np.nonzero(oa)[0]
            if len(idx_alive) < K:
                return
            pts = self.params.obj_xyz.detach().cpu().numpy()[idx_alive]
            count("host_syncs")
            if self.config.use_time_mask:
                t = self.state.gs_time.cpu().numpy()[idx_alive]
                count("host_syncs")
                pts = np.concatenate(
                    [pts, t[:, None] * self.scene.scene_extent], axis=1)
            n_anchor = max(1, len(idx_alive) // K)
            perm = self.np_rng.permutation(len(idx_alive))[:n_anchor]
            nn = knn.knn_indices(pts[perm], pts, k=K)
            # map back to padded slot indices; pad anchors to a stable shape
            idx = idx_alive[nn].astype(np.int32)
            out = np.zeros((a_cap, K), np.int32)
            valid = np.zeros(a_cap, bool)
            n = min(a_cap, idx.shape[0])
            out[:n] = idx[:n]
            valid[:n] = True
            self.state = dataclasses.replace(
                self.state,
                obj_near_idx=torch.as_tensor(out, device=self.device),
                obj_near_valid=torch.as_tensor(valid, device=self.device))
            copied_in(self.state.obj_near_idx, self.state.obj_near_valid)

    def _grow_exchange_capacity(self):
        """The primitive exchange dropped rows (shard.py
        exchange_overflow): grow the per-pair capacity 1.5x, to a multiple
        of 8, and rebuild the sharded step."""
        self.exchange_capacity = -(-int(self.exchange_capacity * 1.5)
                                   // 8) * 8
        self._say(f"[autotune] exchange_capacity -> {self.exchange_capacity}",
                  file=sys.stderr)
        self._build_step()

    def _maybe_grow_instance_capacity(self, num_rendered: int):
        """Grow the instance capacity to num_rendered / 0.92 (rounded up to
        4096) once num_rendered passes 0.97 of it; the per-step overflow
        guard in train() calls this on every overflow, so truncation is
        never silent. The step is rebuilt (nothing is compiled) and the
        evaluation render functions, which bind the old capacity, are
        dropped."""
        if num_rendered <= 0.97 * self.capacity:
            return
        q = 4096
        new_cap = -(-int(num_rendered / 0.92) // q) * q
        if new_cap <= self.capacity:
            return
        with span("trainer.grow"):
            count("capacity_grows")
            self.capacity = new_cap
            self._build_step()
            for k in [k for k in self._frame_cache if k[0] == "eval"]:
                del self._frame_cache[k]
        self._say(f"[capacity] instance capacity grew to {new_cap}")

    def _maybe_grow_capacity(self) -> int:
        """Double a Gaussian block that is more than 90% alive. Returns the
        alive Gaussians of both blocks."""
        ns = int(self.state.num_scene)
        no = int(self.state.num_obj)
        count("host_syncs", 2)
        Ns = self.params.scene_capacity
        No = self.params.obj_capacity
        grow_s = Ns if ns > 0.9 * Ns else 0
        grow_o = No if no > 0.9 * No else 0
        if grow_s or grow_o:
            with span("trainer.grow"):
                count("capacity_grows")
                t, self.opt_state, self.state = densify_lib.grow_capacity(
                    TrainableState(self.params, self.env), self.opt_state,
                    self.state, Ns + grow_s, No + grow_o)
                self.params, self.env = t.gaussians, t.env
            self._say(f"[capacity] grew to scene={Ns + grow_s} "
                      f"obj={No + grow_o}")
        return ns + no

    @staticmethod
    def _read_densify(report, alive_before: torch.Tensor) -> tuple:
        """The densify's report and the alive Gaussians before it, read in
        one copy; the report as the counters densify_cloned, densify_split
        (split samples written), densify_pruned and densify_dropped
        (copies with no free slot), each the sum over both blocks.
        Returns (Gaussians added: clones and split samples written, alive
        Gaussians before)."""
        *values, before = torch.stack([*report, alive_before]).tolist()
        count("host_syncs")
        n = dict(zip(report._fields, values))
        for what in ("cloned", "split", "pruned", "dropped"):
            count(f"densify_{what}", n[f"scene_{what}"] + n[f"obj_{what}"])
        return n["scene_cloned"] + n["obj_cloned"] + n["scene_split"] \
            + n["obj_split"], before

    def _dump_failure_snapshot(self, it: int, fidx: int) -> str:
        """Repro capsule on a step failure: the full train state and the
        failing frame index, loadable with checkpoint.load_state to replay
        the step (e.g. under _kernels.plain() to tell a kernel fault from
        a model fault)."""
        path = os.path.join(self.model_path, f"snapshot_fail_{it}.npz")
        if not self.is_main:
            return f"<rank {self.mesh.rank} writes no snapshot>"
        try:
            ckpt_lib.save_state(
                path, TrainableState(self.params, self.env),
                self.opt_state, self.state, it,
                extras={"failed_frame_idx": fidx,
                        "active_sh_degree": self.active_sh_degree,
                        "instance_capacity": self.capacity})
        except Exception as dump_err:  # noqa: BLE001 (reported, then the
            # step's own error is re-raised by the caller)
            return f"<dump failed: {dump_err}>"
        return path

    # ------------------------------------------------------------------
    def train(self, iterations: Optional[int] = None,
              save_iterations: Optional[list] = None,
              test_iterations: Optional[list] = None,
              log_every: int = 10):
        opt = self.opt
        iterations = iterations or opt.iterations
        save_iterations = set(save_iterations or [iterations])
        test_iterations = set(test_iterations or [iterations])
        if self._step_fn is None:
            self._build_step()
        self.refresh_near_idx()

        # --profile: trace a short steady-state window (steps 20-39)
        prof_window = (range(20, 40) if self.profile_dir and self.is_main
                       else range(0))
        prof_ctx = None

        stack: list = []
        ema = 0.0
        t_start = time.time()
        for it in range(self.iteration + 1, iterations + 1):
            self.iteration = it
            if self.profile_dir and it == prof_window.start:
                profiling.reset()
                prof_ctx = trace(self.profile_dir)
                prof_ctx.__enter__()
            if prof_ctx is not None and it == prof_window.stop:
                self._close_profile(prof_ctx, it)
                prof_ctx = None
            with span("trainer.iteration", it):
                if (it % 1000 == 0
                        and self.active_sh_degree < self.config.sh_degree):
                    self.active_sh_degree += 1

                picks = []
                for _ in range(self.batch_cameras):
                    if not stack:
                        stack = list(range(len(self.scene.train_frames)))
                        if opt.data_sample == "stack":
                            self.rng.shuffle(stack)
                    picks.append(stack.pop(
                        0 if opt.data_sample == "order"
                        else self.rng.randrange(len(stack))))
                fidx = picks[0]
                with span("trainer.frames"):
                    cam, batch, rays = self._frames_for_step(picks, opt)

                try:
                    with span("trainer.step"):
                        (self.params, self.env, self.opt_state, self.state,
                         logs) = self._step_fn(
                            self.params, self.env, self.opt_state,
                            self.state, cam, batch, rays, it,
                            active_sh_degree=self.active_sh_degree)
                    with span("trainer.read"):
                        loss = float(logs["total_loss"])  # waits for it
                        if "splat_instances" in logs:
                            # a mesh step: the largest slab's count and
                            # the sum over the step's cameras, one copy
                            num_rendered, instances = torch.stack(
                                [logs["num_rendered"],
                                 logs["splat_instances"]]).tolist()
                        else:
                            num_rendered = instances = int(
                                logs["num_rendered"])
                        count("host_syncs", 2)
                        count("splat_instances", instances)
                except Exception:
                    path = self._dump_failure_snapshot(it, fidx)
                    print(f"[debug] step {it} raised; repro state dumped to "
                          f"{path} (frame {fidx})", file=sys.stderr)
                    raise
                self._max_rendered = max(self._max_rendered, num_rendered)
                ema = 0.4 * loss + 0.6 * ema if it > 1 else loss
                if it % log_every == 0 or it % 200 == 0:
                    with span("trainer.log"):
                        if it % log_every == 0:
                            self.logger.scalars(it, logs)
                        if it % 200 == 0:
                            n = (int(self.state.num_scene)
                                 + int(self.state.num_obj))
                            count("host_syncs", 2)
                            self._say(f"[{it}/{iterations}] loss={ema:.5f} "
                                      f"pts={n} "
                                      f"({(time.time() - t_start):.0f}s)")
                # per-step overflow guard: a frame whose num_rendered
                # exceeds the capacity truncated its tile lists, so grow now
                if (num_rendered > self.capacity
                        or it % opt.densification_interval == 0):
                    self._maybe_grow_instance_capacity(num_rendered)
                # per-step exchange-overflow guard: that step dropped rows
                # routed to an overloaded slab, so grow now (the JAX
                # trainer checks only every densification interval)
                if self.mesh is not None:
                    count("host_syncs")
                    if bool(logs["exchange_overflow"]):
                        self._grow_exchange_capacity()

                # densification (train.py:148-160)
                if it < opt.densify_until_iter:
                    if (it > opt.densify_from_iter
                            and it % opt.densification_interval == 0):
                        with span("trainer.densify"):
                            before = (self.state.num_scene
                                      + self.state.num_obj)
                            t, self.opt_state, self.state, report = \
                                densify_lib.densify_and_prune(
                                    TrainableState(self.params, self.env),
                                    self.opt_state, self.state,
                                    self.generator,
                                    opt.densify_scene_grad_threshold,
                                    opt.densify_obj_grad_threshold,
                                    opt.min_opacity,
                                    it > opt.opacity_reset_interval,
                                    self.scene.scene_extent,
                                    opt.object_extent, opt.percent_dense)
                            self.params, self.env = t.gaussians, t.env
                            added, before = self._read_densify(report,
                                                               before)
                            alive = self._maybe_grow_capacity()
                            if added:
                                # the next steps render the added
                                # Gaussians too: size for the largest
                                # num_rendered since the last densify,
                                # grown as the alive count grew, before a
                                # step overflows
                                self._maybe_grow_instance_capacity(
                                    -(-self._max_rendered * alive
                                      // max(before, 1)))
                            self._max_rendered = 0
                            self.refresh_near_idx()
                            self.check_replicas(f"densify at {it}")
                    elif (self.use_near_idx
                          and it % opt.near_idx_reset_interval == 0):
                        self.refresh_near_idx()
                    if (it % opt.opacity_reset_interval == 0
                            or (self.white_background
                                and it == opt.densify_from_iter)):
                        # white-background scenes also reset once at the
                        # start of densification
                        with span("trainer.densify"):
                            t, self.opt_state = densify_lib.reset_opacity(
                                TrainableState(self.params, self.env),
                                self.opt_state)
                            self.params, self.env = t.gaussians, t.env

                if it in test_iterations:
                    self.evaluate(it)
                if it in save_iterations:
                    self.save(it)
        if prof_ctx is not None:
            self._close_profile(prof_ctx, iterations + 1)
        self.logger.flush()

    def _close_profile(self, prof_ctx, it: int):
        """End the --profile window: write the trace and the program's
        span summary (metrics.jsonl, split "profile", at the step after
        the window)."""
        prof_ctx.__exit__(None, None, None)
        print(f"[profile] trace written to {self.profile_dir}")
        values = {}
        for root, group in profiling.summary().items():
            values[f"{root}/roots"] = group["roots"]
            for name, entry in group["spans"].items():
                values[f"{root}/{name}/ms"] = entry["ms"]
                values[f"{root}/{name}/self_ms"] = entry["self_ms"]
                for k, v in entry["counts"].items():
                    values[f"{root}/{name}/{k}"] = v
        self.logger.scalars(it, values, prefix="profile")

    # ------------------------------------------------------------------
    def eval_render_fn(self):
        """The serving render function at the active SH degree and the
        current instance capacity (cached until the capacity grows)."""
        key = ("eval", self.active_sh_degree)
        if key not in self._frame_cache:
            self._frame_cache[key] = render_lib.make_staged_render_fn(
                self.config, active_sh_degree=self.active_sh_degree,
                inv_depth=self.inv_depth, capacity=self.render_capacity,
                layout=self.layout)
        return self._frame_cache[key]

    def evaluate(self, it: int, max_frames: int = 10, max_panels: int = 3):
        """PSNR / SSIM (and LPIPS(VGG) where its weights exist) over the
        test split and 5 fixed train cameras, and image panels of the
        first frames to TensorBoard. On a mesh, rank 0 evaluates (on its
        own device) and the other ranks wait."""
        if not self.is_main:
            self._sync()
            return
        self._evaluate(it, max_frames, max_panels)
        self._sync()

    def _evaluate(self, it: int, max_frames: int, max_panels: int):
        from ..ops.image import ssim as ssim_fn
        from ..ops.lpips import lpips_fn
        render_fn = self.eval_render_fn()
        lp_vgg = lpips_fn("vgg", device=self.device)
        configs = [("test", range(min(max_frames,
                                      len(self.scene.test_frames))))]
        if self.scene.train_frames:
            n_tr = len(self.scene.train_frames)
            configs.append(("train", [i % n_tr for i in range(5, 30, 5)]))
        for split, idxs in configs:
            frames = (self.scene.test_frames if split == "test"
                      else self.scene.train_frames)
            vals: dict = {"psnr": [], "ssim": [], "lpips": []}
            for j, i in enumerate(idxs):
                cam, batch, _ = self._get_frame(split, i)
                rays = self._rays_for(cam, frames[i].cam_id)
                out = render_fn(cam, self.params, self.state, self.env, rays)
                img = torch.clamp(out["render"], 0, 1)
                vals["psnr"].append(float(psnr(img, batch.image)))
                vals["ssim"].append(float(ssim_fn(img, batch.image)))
                if lp_vgg is not None:
                    vals["lpips"].append(float(lp_vgg(img, batch.image)))
                if j < max_panels and self.logger.tb is not None:
                    self._log_panels(it, f"{split}_view_{i}", out, img,
                                     batch)
            if vals["psnr"]:
                scalars = {"psnr": np.mean(vals["psnr"]),
                           "ssim": np.mean(vals["ssim"])}
                if vals["lpips"]:
                    scalars["lpips_vgg"] = np.mean(vals["lpips"])
                print(f"[ITER {it}] {split} "
                      + " ".join(f"{k.upper()} {v:.3f}"
                                 for k, v in scalars.items()))
                self.logger.scalars(it, scalars, prefix=split)

    def _log_panels(self, it: int, tag: str, out: dict, img, batch):
        """Image panels at test iterations (render, ground truth, error,
        depth, opacity, foreground, background, object mask)."""
        def np_(x):
            return x.detach().cpu().numpy()

        np_img, gt = np_(img), np_(batch.image)
        self.logger.image(it, f"{tag}/render", np_img)
        self.logger.image(it, f"{tag}/ground_truth", gt)
        self.logger.image(it, f"{tag}/error", np.abs(np_img - gt))
        depth = np_(out["depth"])
        dmax = depth.max()
        self.logger.image(it, f"{tag}/depth",
                          depth / dmax if dmax > 0 else depth)
        self.logger.image(it, f"{tag}/opacity", np_(out["img_opacity"]))
        self.logger.image(it, f"{tag}/foreground", np_(out["foreground"]))
        self.logger.image(it, f"{tag}/background", np_(out["background"]))
        if out.get("img_semantic") is not None:
            self.logger.image(it, f"{tag}/objmask",
                              np_(out["img_semantic"])[0])

    def resume(self, path: str):
        """Mid-training resume from a train_state.npz snapshot (of either
        package; the capacities must match)."""
        tr, self.opt_state, self.state, it = ckpt_lib.load_state(
            path, TrainableState(self.params, self.env), self.opt_state,
            self.state)
        self.params, self.env = tr.gaussians, tr.env
        self.iteration = it
        self.active_sh_degree = min(it // 1000, self.config.sh_degree)
        self._say(f"[resume] restored iteration {it}")

    def save(self, it: int):
        if not self.is_main:
            self._sync()
            return
        base = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{it}")
        ckpt_lib.save_ply(os.path.join(base, "point_cloud.ply"),
                          self.params, self.state, self.config)
        np.save(os.path.join(base, "env.npy"), self.env.grid.cpu().numpy())
        ckpt_lib.save_state(
            os.path.join(base, "train_state.npz"),
            TrainableState(self.params, self.env), self.opt_state,
            self.state, it)
        print(f"[ITER {it}] saved to {base}")
        self._sync()

    def close(self):
        self.logger.close()
