"""The plain reference of a served frame, in float32 with TF32 off (or,
for the control, in TF32: tf32.py): the model and sky from the seed as
they were handed to the program, the frozen plain render of each camera
(deform, preprocess, binning, compositing, sky), clamped to [0, 1] as the
served image is."""

from __future__ import annotations

import torch

from .. import scene
from .plain.core.camera import Camera
from .plain.models.env_map import EnvironmentMap, camera_rays
from .plain.models.gaussians import (GaussianConfig, GaussianParams,
                                     GaussianState)
from .plain.render import compute_binning, make_staged_render_fn
from .tf32 import precision


def render(spec: dict, traffic: dict, seed: int, dev, views: list,
           tf32: bool = False) -> list:
    """[image [3, H, W] on the host] of each View."""
    with precision(tf32):
        return _render(spec, traffic, seed, dev, views)


@torch.no_grad()
def _render(spec, traffic, seed, dev, views):
    w = scene.make_weights(spec, seed, dev,
                           capacity_factor=int(traffic["capacity_factor"]))
    params = GaussianParams(**{name: w[name] for name in scene.LEAVES})
    zeros = torch.zeros(params.capacity, dtype=torch.float32, device=dev)
    state = GaussianState(
        scene_alive=w["scene_alive"], obj_alive=w["obj_alive"],
        gs_time=w["gs_time"], max_radii2d=zeros, xyz_grad_accum=zeros,
        denom=zeros,
        obj_near_idx=torch.zeros((1, 1), dtype=torch.int32, device=dev),
        obj_near_valid=torch.zeros((1,), dtype=torch.bool, device=dev))
    env = EnvironmentMap(grid=w["env"])
    del w
    cfg = GaussianConfig.from_order_args(
        spec["order_args"], scene.scene_frame_num(spec), 3,
        sh_degree=int(spec["sh_degree"]), use_time_mask=True)
    out = []
    rays = {}
    for v in views:
        cam = Camera.create(R=v.R, T=v.T, fovx=v.fovx, fovy=v.fovy,
                            width=v.width, height=v.height, time=v.time,
                            device=dev)
        if v.cam_id not in rays:
            rays[v.cam_id] = torch.as_tensor(
                camera_rays(cam.focal_x, cam.height, cam.width),
                dtype=torch.float32, device=dev)
        nr = int(compute_binning(cam, params, state, cfg, capacity=1 << 10,
                                 backend="torch").num_rendered)
        fn = make_staged_render_fn(
            cfg, active_sh_degree=int(spec["sh_degree"]), backend="torch",
            capacity=scene.instance_capacity(nr))
        img = fn(cam, params, state, env, rays[v.cam_id])["render"]
        out.append(torch.clamp(img, 0.0, 1.0).cpu())
    return out
