"""Rasterizer settings and outputs (counterpart of adgs_tpu/raster/types.py)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

# Tile size of the reference rasterizer; binning semantics depend on it.
TILE_X = 16
TILE_Y = 16
TILE_PIX = TILE_X * TILE_Y


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    viewmatrix: torch.Tensor  # [4,4] transposed world->view
    projmatrix: torch.Tensor  # [4,4] transposed world->NDC
    campos: torch.Tensor      # [3]
    bg: torch.Tensor          # [3]
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    sh_degree: int = 3
    scale_modifier: float = 1.0
    inv_depth: bool = True

    @property
    def grid_x(self) -> int:
        return (self.image_width + TILE_X - 1) // TILE_X

    @property
    def grid_y(self) -> int:
        return (self.image_height + TILE_Y - 1) // TILE_Y

    @property
    def num_tiles(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def focal_x(self) -> float:
        return self.image_width / (2.0 * self.tanfovx)

    @property
    def focal_y(self) -> float:
        return self.image_height / (2.0 * self.tanfovy)


class RasterOutput(NamedTuple):
    color: torch.Tensor               # [3, H, W] (bg composited)
    radii: torch.Tensor               # [N] int32 (0 = culled)
    depth: torch.Tensor               # [1, H, W] blended (inverse) depth
    opacity: torch.Tensor             # [1, H, W] 1 - final T
    flow: Optional[torch.Tensor]      # [3, H, W]
    semantic: Optional[torch.Tensor]  # [S, H, W]
    # 0-d int32 instance count of the binning (may exceed the capacity);
    # the JAX step reads it from its separate binning program
    num_rendered: Optional[torch.Tensor] = None
