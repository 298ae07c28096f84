"""Public rasterizer API (counterpart of adgs_tpu/raster/api.py).

Backends:
  - "cuda":  the hand-written kernels (default for CUDA tensors; on CPU
             tensors every kernel wrapper runs its plain twin);
  - "torch": the plain PyTorch twins on any device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._stages import mark
from . import binning as binning_lib
from . import preprocess as prep_lib
from . import render as render_lib
from .types import RasterOutput, RasterSettings

BACKENDS = ("cuda", "torch")


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend}")
    return backend


@torch.no_grad()
def rasterize(means3d: torch.Tensor, opacities: torch.Tensor,
              scales: torch.Tensor, rotations: torch.Tensor,
              settings: RasterSettings,
              shs: Optional[torch.Tensor] = None,
              colors_precomp: Optional[torch.Tensor] = None,
              flow_points: Optional[torch.Tensor] = None,
              semantic: Optional[torch.Tensor] = None,
              active_mask: Optional[torch.Tensor] = None,
              backend: Optional[str] = None,
              capacity: int = 1 << 18,
              stage_marks: Optional[list] = None) -> RasterOutput:
    """stage_marks: see adgs_tpu_torch._stages (marks "preprocess",
    "binning" and "compositing")."""
    if shs is None and colors_precomp is None:
        raise ValueError("either shs or colors_precomp is required")
    backend = resolve_backend(backend, means3d.device)
    prep = prep_lib.preprocess(means3d, scales, rotations, opacities, shs,
                               settings, colors_precomp=colors_precomp,
                               active_mask=active_mask)
    mark(stage_marks, "preprocess")
    binning = binning_lib.bin_gaussians(prep, settings, capacity,
                                        backend=backend)
    mark(stage_marks, "binning")
    render = (render_lib.render_cuda if backend == "cuda"
              else render_lib.render_torch)
    out = render(prep, binning, settings, flow_points=flow_points,
                 semantic=semantic)
    mark(stage_marks, "compositing")
    return out
