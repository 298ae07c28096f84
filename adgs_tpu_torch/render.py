"""Render bridge: model + environment map -> rasterizer -> composited frame
(counterpart of adgs_tpu/render.py, same entry points and output keys).

Evaluates the temporal deformation at the camera's time, rasterizes with
depth/opacity (and optional flow/semantic) targets, and composites the
environment-map sky behind the splatted foreground via the accumulated
opacity. render() is differentiable (the training step takes its
gradients, and dL/dmean2d through a zero `screen_offset`); the serving
entry point make_staged_render_fn runs it under torch.no_grad().
"""

from __future__ import annotations

import itertools
from typing import Any, Optional

import torch

from ._stages import mark
from .core.camera import Camera
from .models.env_map import EnvironmentMap
from .models.gaussians import (GaussianConfig, GaussianParams, GaussianState,
                               activated_scaling, deform, obj_mask)
from .profiling import count, span
from .raster import binning as binning_lib
from .raster import preprocess as prep_lib
from .raster.api import rasterize
from .raster.types import RasterSettings


def settings_for_camera(cam: Camera, sh_degree: int, inv_depth: bool = True,
                        scale_modifier: float = 1.0) -> RasterSettings:
    return RasterSettings(
        viewmatrix=cam.world_view, projmatrix=cam.full_proj,
        campos=cam.camera_center,
        bg=torch.zeros(3, dtype=torch.float32, device=cam.world_view.device),
        image_height=cam.height, image_width=cam.width,
        tanfovx=cam.tan_fovx, tanfovy=cam.tan_fovy, sh_degree=sh_degree,
        scale_modifier=scale_modifier, inv_depth=inv_depth)


@torch.no_grad()
def compute_binning(camera: Camera, params: GaussianParams,
                    state: GaussianState, config: GaussianConfig,
                    active_sh_degree: Optional[int] = None,
                    inv_depth: bool = True, scaling_modifier: float = 1.0,
                    capacity: int = 1 << 18) -> binning_lib.Binning:
    """The first half of a render: deform + preprocess (geometry only, no
    SH colour) + tile binning."""
    sh_degree = (active_sh_degree if active_sh_degree is not None
                 else config.sh_degree)
    settings = settings_for_camera(camera, sh_degree, inv_depth,
                                   scaling_modifier)
    pkg, _ = deform(params, state, config, camera.time)
    prep = prep_lib.preprocess(pkg["xyz"], activated_scaling(params),
                               pkg["rotation"], pkg["opacity"], None,
                               settings, active_mask=state.alive)
    return binning_lib.bin_gaussians(prep, settings, capacity)


def make_staged_render_fn(config: GaussianConfig,
                          active_sh_degree: Optional[int] = None,
                          inv_depth: bool = True,
                          capacity: int = 1 << 18,
                          render_objmask: bool = False,
                          layout: str = "gather"):
    """The serving entry point: render() with its options bound. Returns
    fn(camera, params, state, env, cam_rays, stage_marks=None), computed
    without an autograd graph. `camera` is a Camera, and fn returns its
    render() dict; or a rig: a sequence of Cameras that share one time,
    with `cam_rays` a matching sequence of ray sets, and fn returns each
    camera's render() dict, in order. The shared time is the caller's
    promise (fn reads nothing from the card to check it): the rig is
    deformed once, at its first camera's time, and each camera rasterizes
    and composites its sky on that one package. The JAX entry point
    splits binning and rendering into two compiled programs; run eagerly,
    one deform and one preprocess feed both, so the port needs no split.
    layout: the compositor's instance layout, "gather" or "rows" (the JAX
    package's ADGS_RM=0/1). Each call is one "serve.frame" root span
    (profiling.span), numbered by the calls of this function, with the
    counters "frame_cameras" and "frame_deforms"; each camera's part is a
    "render.camera" span, numbered by its place in the frame. stage_marks
    takes render()'s marks, the camera stages once for each camera."""
    frames = itertools.count()
    sh_degree = (active_sh_degree if active_sh_degree is not None
                 else config.sh_degree)

    @torch.no_grad()
    def full(camera, params, state, env, cam_rays, stage_marks=None):
        rig = not isinstance(camera, Camera)
        cams = list(camera) if rig else [camera]
        rays = list(cam_rays) if rig else [cam_rays]
        with span("serve.frame", next(frames)):
            count("frame_cameras", len(cams))
            count("frame_deforms", 1)
            settings = [settings_for_camera(c, sh_degree, inv_depth)
                        for c in cams]
            mark(stage_marks, "start")
            deformed = _deformed(params, state, config, cams[0].time, None,
                                 render_objmask)
            mark(stage_marks, "deform")
            outs = []
            for k, (cam, st, r) in enumerate(zip(cams, settings, rays)):
                with span("render.camera", k):
                    outs.append(_camera_part(
                        cam, st, params, state, deformed, env, r,
                        override_color=None, screen_offset=None,
                        capacity=capacity, stage_marks=stage_marks,
                        layout=layout))
        return outs if rig else outs[0]

    return full


def render(camera: Camera, params: GaussianParams, state: GaussianState,
           config: GaussianConfig,
           env_map: Optional[EnvironmentMap] = None,
           cam_rays: Optional[torch.Tensor] = None,
           flow_time: Optional[torch.Tensor] = None,
           render_objmask: bool = False,
           override_color: Optional[torch.Tensor] = None,
           screen_offset: Optional[torch.Tensor] = None,
           active_sh_degree: Optional[int] = None,
           inv_depth: bool = True, scaling_modifier: float = 1.0,
           capacity: int = 1 << 18,
           stage_marks: Optional[list] = None,
           layout: str = "gather") -> dict[str, Any]:
    """screen_offset: [N, 2] zeros whose gradient is dL/dmean2d.
    layout: the compositor's instance layout, "gather" or "rows".
    stage_marks: a list to receive CUDA-event marks "start", "deform",
    "preprocess", "binning", "compositing" and "sky" (adgs_tpu_torch._stages);
    None records nothing."""
    sh_degree = (active_sh_degree if active_sh_degree is not None
                 else config.sh_degree)
    settings = settings_for_camera(camera, sh_degree, inv_depth,
                                   scaling_modifier)
    mark(stage_marks, "start")
    deformed = _deformed(params, state, config, camera.time, flow_time,
                         render_objmask)
    mark(stage_marks, "deform")
    return _camera_part(camera, settings, params, state, deformed, env_map,
                        cam_rays, override_color, screen_offset, capacity,
                        stage_marks, layout)


def _deformed(params, state, config, t, flow_time, render_objmask):
    """render()'s first part, which depends on the time alone: (the
    deformed package, the flow-time xyz, the object mask or None)."""
    with span("render.deform"):
        pkg, flow_points = deform(params, state, config, t, flow_time)
        semantic = None
        if render_objmask:
            semantic = obj_mask(params).to(torch.float32)[:, None]
    return pkg, flow_points, semantic


def _camera_part(camera, settings, params, state, deformed, env_map,
                 cam_rays, override_color, screen_offset, capacity,
                 stage_marks, layout) -> dict[str, Any]:
    """render()'s part for one camera on a deformed package: rasterize,
    then the sky behind the foreground."""
    pkg, flow_points, semantic = deformed
    out = rasterize(
        means3d=pkg["xyz"], opacities=pkg["opacity"],
        scales=activated_scaling(params), rotations=pkg["rotation"],
        settings=settings,
        shs=pkg["shs"] if override_color is None else None,
        colors_precomp=override_color, flow_points=flow_points,
        semantic=semantic, screen_offset=screen_offset,
        active_mask=state.alive, capacity=capacity,
        stage_marks=stage_marks, layout=layout)

    foreground = out.color
    with span("render.sky"):
        if env_map is not None and cam_rays is not None:
            background = env_map.image_background(cam_rays,
                                                  camera.world_view)
            rendered = foreground + (1.0 - out.opacity) * background
        else:
            background = torch.zeros_like(foreground)
            rendered = foreground
    mark(stage_marks, "sky")

    return {
        "render": rendered,
        "foreground": foreground,
        "background": background,
        "depth": out.depth[0],
        "img_opacity": out.opacity[0],
        "img_flow": out.flow,
        "img_semantic": out.semantic,
        "radii": out.radii,
        "visibility_filter": out.radii > 0,
        "num_rendered": out.num_rendered,
        "opacity": pkg["opacity"],
        **pkg,
    }
