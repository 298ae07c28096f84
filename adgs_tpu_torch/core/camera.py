"""Camera math and the Camera dataclass (counterpart of
adgs_tpu/core/camera.py).

Conventions kept from the reference: world->view does NOT transpose R (the
dataset readers already store the world->camera rotation), and the stored
`world_view` / `full_proj` are the TRANSPOSED 4x4s, so points transform as
row vectors: p' = [p, 1] @ M.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from ..profiling import copied_in


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world->view in column-vector convention; R is used as is."""
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """Perspective projection, column-vector convention."""
    top = math.tan(fovy / 2) * znear
    right = math.tan(fovx / 2) * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Render camera. Matrices are stored TRANSPOSED (row-vector form)."""

    world_view: torch.Tensor     # [4,4] transposed world->view
    full_proj: torch.Tensor      # [4,4] transposed world->NDC
    camera_center: torch.Tensor  # [3]
    time: torch.Tensor           # 0-d, in [0, 1)
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tan_fovy)

    @classmethod
    def create(cls, R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
               width: int, height: int, time: float = 0.0,
               znear: float = 0.01, zfar: float = 100.0,
               trans: np.ndarray | None = None, scale: float = 1.0,
               device=None) -> "Camera":
        dev = resolve_device(device)
        wv = world_to_view(R, T, trans, scale).T
        full = wv @ projection_matrix(znear, zfar, fovx, fovy).T
        cam_center = np.linalg.inv(wv)[3, :3]

        def f32(a):
            x = torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
            copied_in(x)
            return x

        return cls(world_view=f32(wv), full_proj=f32(full),
                   camera_center=f32(cam_center), time=f32(time),
                   width=int(width), height=int(height),
                   tan_fovx=float(math.tan(fovx / 2)),
                   tan_fovy=float(math.tan(fovy / 2)))

    def at_time(self, time: float) -> "Camera":
        return dataclasses.replace(
            self, time=torch.as_tensor(time, dtype=torch.float32,
                                       device=self.time.device))


def transform_point_4x4(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[N,3] x transposed 4x4 -> [N,4] homogeneous."""
    return p @ m[:3, :4] + m[3, :4]


def transform_point_4x3(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[N,3] x transposed 4x4 -> [N,3] affine."""
    return p @ m[:3, :3] + m[3, :3]


def ndc_to_pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5
