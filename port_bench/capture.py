"""Keeps the images that a training step renders, by wrapping the name
`compute_losses` in the step's module (the program's or the frozen
reference's) while inside: each wanted call's composited RGB, on the
host."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def step_renders(step_module, sink: list, want):
    """While inside, each call of step_module.compute_losses for which
    want() is true appends its render package's "render" [3, H, W] to
    `sink`."""
    losses = step_module.compute_losses

    def kept(render_pkg, *args, **kwargs):
        if want():
            sink.append(render_pkg["render"].detach().float().cpu())
        return losses(render_pkg, *args, **kwargs)

    step_module.compute_losses = kept
    try:
        yield sink
    finally:
        step_module.compute_losses = losses
