"""Public rasterizer API (counterpart of adgs_tpu/raster/api.py).

Each kernel wrapper below chooses between its hand-written kernel and its
plain PyTorch twin by `_kernels.use`: the kernel on CUDA tensors unless
`_kernels.plain()` is on. Instance layouts: "gather" (default) or "rows",
the JAX package's ADGS_RM=0/1 (raster/render.py).

Differentiable with respect to the Gaussians' float inputs (and
screen_offset). The binning is integer plumbing: it runs under
torch.no_grad() from the same Preprocessed the gradient pass uses, so a
training step preprocesses once.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._stages import mark
from ..profiling import span
from . import binning as binning_lib
from . import preprocess as prep_lib
from . import render as render_lib
from .types import RasterOutput, RasterSettings

def rasterize(means3d: torch.Tensor, opacities: torch.Tensor,
              scales: torch.Tensor, rotations: torch.Tensor,
              settings: RasterSettings,
              shs: Optional[torch.Tensor] = None,
              colors_precomp: Optional[torch.Tensor] = None,
              flow_points: Optional[torch.Tensor] = None,
              semantic: Optional[torch.Tensor] = None,
              screen_offset: Optional[torch.Tensor] = None,
              active_mask: Optional[torch.Tensor] = None,
              capacity: int = 1 << 18,
              stage_marks: Optional[list] = None,
              layout: str = "gather") -> RasterOutput:
    """stage_marks: see adgs_tpu_torch._stages (marks "preprocess",
    "binning" and "compositing")."""
    if shs is None and colors_precomp is None:
        raise ValueError("either shs or colors_precomp is required")
    with span("render.preprocess"):
        prep = prep_lib.preprocess(means3d, scales, rotations, opacities,
                                   shs, settings,
                                   colors_precomp=colors_precomp,
                                   screen_offset=screen_offset,
                                   active_mask=active_mask)
    mark(stage_marks, "preprocess")
    with span("render.binning"), torch.no_grad():
        binning = binning_lib.bin_gaussians(prep, settings, capacity)
    mark(stage_marks, "binning")
    with span("render.compositing"):
        out = render_lib.render(prep, binning, settings,
                                flow_points=flow_points, semantic=semantic,
                                layout=layout)
    mark(stage_marks, "compositing")
    return out
