"""Equirectangular environment (sky) map (counterpart of
adgs_tpu/models/env_map.py): a [C, R, R] grid sampled by (azimuth,
elevation) with bilinear interpolation and a sigmoid."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from ..ops.grid_sample import GridSample
from ..profiling import copied_in


def camera_rays(focal: float, height: int, width: int) -> np.ndarray:
    """[H, W, 3] unit camera-space rays (K centred on width/2, height/2)."""
    xs = np.arange(width, dtype=np.float32)
    ys = np.arange(height, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    x = (gx - width / 2.0) / focal
    y = (gy - height / 2.0) / focal
    rays = np.stack([x, y, np.ones_like(x)], axis=-1)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return rays


def direction_to_angles(view: torch.Tensor) -> torch.Tensor:
    """[-pi,pi] azimuth x [-pi/2,pi/2] elevation."""
    x, y, z = view.unbind(-1)
    el = torch.atan2(z, torch.hypot(x, y))
    az = torch.atan2(y, x)
    return torch.stack([az, el], dim=-1)


def angles_to_direction(angles: torch.Tensor) -> torch.Tensor:
    """(azimuth, elevation) -> unit direction (theta_to_vector)."""
    az, el = angles[..., 0], angles[..., 1]
    return torch.stack([torch.cos(az) * torch.cos(el),
                        torch.sin(az) * torch.cos(el),
                        torch.sin(el)], dim=-1)


@dataclasses.dataclass(frozen=True)
class EnvironmentMap:
    grid: torch.Tensor  # [C, R, R]

    @classmethod
    def create(cls, resolution: int, num_channel: int = 3, seed: int = 0,
               device=None) -> "EnvironmentMap":
        """U(-1,1) * 1e-4 init from a numpy seed (same values as JAX)."""
        rng = np.random.default_rng(seed)
        g = (rng.random((num_channel, resolution, resolution),
                        dtype=np.float32) * 2.0 - 1.0) * 1e-4
        return cls(grid=torch.as_tensor(g, device=resolve_device(device)))

    def color(self, view: torch.Tensor,
              input_angle: bool = False) -> torch.Tensor:
        """dirs [..., 3] (or, with input_angle, (azimuth, elevation)
        [..., 2]) -> sky colour [C, ...], differentiable with respect to
        the grid (the rays are constants: they get no gradient), through
        GridSample (B7 and B8, or their twins)."""
        if input_angle:
            angles = view
        else:
            view = view / torch.clamp(torch.linalg.vector_norm(
                view, dim=-1, keepdim=True), min=1e-12)
            angles = direction_to_angles(view)
        per_rad = angles.new_tensor([1.0 / math.pi, 2.0 / math.pi])
        copied_in(per_rad)
        coords = angles * per_rad
        return torch.sigmoid(GridSample.apply(
            self.grid, coords.detach().contiguous()))

    def image_background(self, cam_rays: torch.Tensor,
                         world_view: torch.Tensor) -> torch.Tensor:
        """[H, W, 3] camera rays + transposed-stored view matrix ->
        [C, H, W] sky image."""
        return self.color(cam_rays @ world_view[:3, :3].T)
