"""The plain reference of served rig frames: every camera of every rig
rendered on its own through render_ref (the frozen plain tier, float32
with TF32 off, or TF32 for the control), so that each camera pays a plain
deformation of its own, independent of the one deformed package that the
program shares among a rig's cameras."""

from __future__ import annotations

from . import render_ref


def render(spec: dict, traffic: dict, seed: int, dev, rigs: list,
           tf32: bool = False) -> list:
    """[image [3, H, W] on the host] of each camera of each rig (a list of
    Views), rig after rig, camera after camera."""
    return render_ref.render(spec, traffic, seed, dev,
                             [v for rig in rigs for v in rig], tf32=tf32)
