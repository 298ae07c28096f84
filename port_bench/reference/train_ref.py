"""The plain reference of a training cell's checked steps, in float32 with
TF32 off (or, for the control, in TF32: tf32.py).

The first stretch: it works out again everything the program derived:
the model, sky and frames from the seed (port_bench.scene, as they were
handed to the program), the trainer's camera and flow-package picks from
its seed (a random.Random drawn in the trainer's order), the KNN groups of
the refresh at the start of `Trainer.train` (the device draw of a
generator seeded with the seed, then the frozen device KNN), the instance
capacity, the learning rates; then runs the frozen plain step from
`start + 1`.

The step after the window (`post`): one frozen plain step from the
program's own state before that step (its model, sky, Adam moments and
statistics after some hundreds of steps, densify and the KNN groups of
its last refresh included), which the reference can only take as it
stands; the camera, the frame and its flow package are worked out again
from the seed and the trainer's picks.

Returns the readings of each stretch (port_bench/readings.py).
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from .. import readings, scene
from ..capture import step_renders
from .plain.core.camera import Camera
from .plain.models.env_map import EnvironmentMap, camera_rays
from .plain.models.gaussians import (GaussianConfig, GaussianParams,
                                     GaussianState)
from .plain.ops.flow import FlowPackage
from .plain.ops.knn import near_idx_device
from .plain.render import compute_binning
from .plain.train.config import OptimizationConfig
from .plain.train.losses import FrameBatch
from .plain.train.optim import (AdamState, TrainableState, from_leaves,
                                init_adam, leaves)
from .plain.train import step as step_mod
from .plain.train.step import make_train_step
from .tf32 import precision


def picks(seed: int, n_train: int, flows_per: list, steps: int,
          data_sample: str, want_flow: bool) -> list:
    """[(frame index, flow package index or None)] of the first steps, as
    the trainer draws them from random.Random(seed)."""
    rng = random.Random(seed)
    stack: list = []
    out = []
    for _ in range(steps):
        if not stack:
            stack = list(range(n_train))
            if data_sample == "stack":
                rng.shuffle(stack)
        i = stack.pop(0 if data_sample == "order"
                      else rng.randrange(len(stack)))
        j = rng.randrange(flows_per[i]) if want_flow and flows_per[i] \
            else None
        out.append((i, j))
    return out


def model(spec: dict, traffic: dict, seed: int, dev):
    """(params, state, env, w): the model as the program was handed it,
    and the benchmark's draw it came from."""
    w = scene.make_weights(spec, seed, dev,
                           capacity_factor=int(traffic["capacity_factor"]))
    params = GaussianParams(**{name: w[name] for name in scene.LEAVES})
    zeros = torch.zeros(params.capacity, dtype=torch.float32, device=dev)
    state = GaussianState(
        scene_alive=w["scene_alive"], obj_alive=w["obj_alive"],
        gs_time=w["gs_time"], max_radii2d=zeros, xyz_grad_accum=zeros.clone(),
        denom=zeros.clone(),
        obj_near_idx=torch.zeros((1, 1), dtype=torch.int32, device=dev),
        obj_near_valid=torch.zeros((1,), dtype=torch.bool, device=dev))
    return params, state, EnvironmentMap(grid=w["env"]), w


def follow(spec: dict, traffic: dict, seed: int, dev, steps: int,
           tf32: bool = False, post: dict = None) -> list:
    """[readings of the first `steps` steps] and, given the program's state
    before the step after the window (`post`, as the train driver keeps
    it), the readings of that step."""
    with precision(tf32):
        return _follow(spec, traffic, seed, dev, steps, post)


def _follow(spec, traffic, seed, dev, steps, post):
    opt = scene.optimization(spec, OptimizationConfig)
    params, state, env, w = model(spec, traffic, seed, dev)
    views = scene.views(spec)
    train_views = [v for v in views if not v.is_test]
    n_images = len(views)
    frame_gap = float(spec["num_cam"]) / n_images
    cfg = GaussianConfig.from_order_args(
        spec["order_args"], int(round(1.0 / frame_gap)), 3,
        sh_degree=int(spec["sh_degree"]), use_time_mask=opt.lambda_sigma > 0)
    scene_extent = scene.scene_extent(spec, w)
    cameras_extent = max(scene.cameras_extent(train_views),
                         opt.min_camera_extent)
    del w
    flow_per = int(traffic["flow_per_frame"])
    n_picks = steps if post is None else max(steps, post["k"] + 1)
    chosen = picks(seed, len(train_views), [flow_per] * len(train_views),
                   n_picks, opt.data_sample, opt.lambda_flow > 0.0)
    wanted = {i for i, _ in chosen[:steps]}
    if post is not None:
        wanted.add(chosen[post["k"]][0])
    frames = scene.make_frames(spec, seed, dev, train_views, flow_per,
                               keep=wanted)

    def one_step(k, it, params, env, opt_state, state):
        i, j = chosen[k]
        return _one_step(spec, opt, cfg, frame_gap, scene_extent,
                         cameras_extent, it, train_views[i], frames[i], j,
                         rays, params, env, opt_state, state, dev)

    # the refresh at the start of Trainer.train
    K = opt.near_num
    if opt.lambda_reg > 0.0 or (opt.lambda_sigma > 0.0
                                and opt.lambda_sigma_reg > 0.0):
        pts = params.obj_xyz
        if cfg.use_time_mask:
            pts = torch.cat([pts, state.gs_time[:, None] * scene_extent], 1)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        r = torch.rand((pts.shape[0],), generator=gen, device=dev)
        idx, valid = near_idx_device(pts, state.obj_alive, r, K,
                                     max(1, params.obj_capacity // K))
        state = dataclasses.replace(state, obj_near_idx=idx,
                                    obj_near_valid=valid)

    start = int(traffic["start_iteration"])
    opt_state = init_adam(TrainableState(params, env))._replace(
        count=torch.tensor(start, dtype=torch.int32))
    p0 = [x.detach().clone() for x in leaves(TrainableState(params, env))]
    s0 = {n: t.clone() for n, t in readings.stat_tensors(state).items()}
    rays = {}
    losses, grad_norms, stats, images = [], None, None, []
    with step_renders(step_mod, images, lambda: True):
        for k in range(steps):
            params, env, opt_state, state, loss = one_step(
                k, start + k + 1, params, env, opt_state, state)
            losses.append(loss)
            if k == 0:
                grad_norms = readings.gradient_norms(leaves(opt_state.m))
                stats = readings.stat_changes(readings.stat_tensors(state),
                                              s0)
    now = leaves(TrainableState(params, env))
    out = [dict(losses=losses, grad_norms=grad_norms,
                change_norms=readings.change_norms(now, p0), stats=stats,
                images=images)]
    del params, env, opt_state, state, now, p0
    if post is not None:
        out.append(_post_step(post, one_step))
    return out


def _post_step(post: dict, one_step) -> dict:
    """The readings of one plain step from the program's state `post`."""
    g = post["params"]
    params = GaussianParams(**{f.name: g[f.name]
                               for f in dataclasses.fields(GaussianParams)})
    env = EnvironmentMap(grid=post["env"])
    like = TrainableState(params, env)

    def tree(d):
        return from_leaves(like, [d[f.name] for f in
                                  dataclasses.fields(GaussianParams)]
                           + [d["env"]])

    opt_state = AdamState(m=tree(post["m"]), v=tree(post["v"]),
                          count=torch.tensor(post["count"],
                                             dtype=torch.int32))
    state = GaussianState(**{f.name: post["state"][f.name]
                             for f in dataclasses.fields(GaussianState)})
    p0, m0 = leaves(like), leaves(opt_state.m)
    s0 = readings.stat_tensors(state, readings.POST_STATS)
    images = []
    with step_renders(step_mod, images, lambda: True):
        p1, e1, o1, st1, loss = one_step(post["k"], post["it"], params, env,
                                         opt_state, state)
    return dict(losses=[loss],
                grad_norms=readings.gradient_norms(leaves(o1.m), m0),
                change_norms=readings.change_norms(
                    leaves(TrainableState(p1, e1)), p0),
                stats=readings.stat_changes(readings.stat_tensors(st1), s0),
                images=images)


def _one_step(spec, opt, cfg, frame_gap, scene_extent, cameras_extent, it,
              v, frame, j, rays, params, env, opt_state, state, dev):
    """One frozen plain step on view v with flow package j; returns the
    new state and the loss."""
    cam = Camera.create(R=v.R, T=v.T, fovx=v.fovx, fovy=v.fovy,
                        width=v.width, height=v.height, time=v.time,
                        device=dev)
    (image, depth, sky, semantic), flows = frame
    batch = FrameBatch(image=image, depth=depth, sky=sky,
                       semantic=semantic)
    if j is not None:
        t, Kf, R, T, flow, vis = flows[j]

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        batch = batch._replace(
            flow=FlowPackage(time=f32(np.float32(t)), K=f32(Kf),
                             R=f32(R), T=f32(np.asarray(T).reshape(-1)),
                             flow=f32(flow), vis=f32(vis)),
            flow_valid=torch.tensor(True, device=dev))
    if v.cam_id not in rays:
        rays[v.cam_id] = torch.as_tensor(
            camera_rays(cam.focal_x, cam.height, cam.width),
            dtype=torch.float32, device=dev)
    nr = int(compute_binning(cam, params, state, cfg, capacity=1 << 10,
                             backend="torch").num_rendered)
    step = make_train_step(cfg, opt, frame_gap, scene_extent,
                           cameras_extent, backend="torch",
                           capacity=scene.instance_capacity(nr))
    params, env, opt_state, state, logs = step(
        params, env, opt_state, state, cam, batch, rays[v.cam_id], it,
        active_sh_degree=int(spec["sh_degree"]))
    return params, env, opt_state, state, float(logs["total_loss"])
