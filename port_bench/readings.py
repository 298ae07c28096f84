"""What each side of a training check reads from its own steps, in the same
way for the program and for the plain reference: norms by leaf, the
gradient as Adam got it, and the change of the step's statistics.

A stretch is a run of checked steps from one state: the first steps of
the call from the benchmark's model, or the step after the window from
the program's own state. Its readings are a dict: `losses` (each step's),
`grad_norms` (the first step's gradient, by leaf), `change_norms` (each
leaf's change over the stretch), `stats` (the norm of each statistic's
change over the first step: the one step whose inputs are the same on
both sides) and `images` (each step's render).
"""

from __future__ import annotations

import torch

ADAM_B1 = 0.9
# GaussianState's statistics that densify reads; a step adds to them
STATS = ("max_radii2d", "xyz_grad_accum", "denom")
# one step after the window: max_radii2d is a running maximum that one
# step raises only where a radius beats its history since the last
# densify, so only the sums are read
POST_STATS = ("xyz_grad_accum", "denom")


def leaf_norms(tensors) -> list:
    return [float(torch.linalg.vector_norm(t.detach().double()))
            for t in tensors]


def gradient_norms(m1: list, m0: list = None) -> list:
    """The norm by leaf of the gradient of a step, from Adam's first moment
    after it (m1) and before it (m0; None for zeros):
    m1 = b1 m0 + (1 - b1) g."""
    if m0 is None:
        return [n / (1.0 - ADAM_B1) for n in leaf_norms(m1)]
    return [float(torch.linalg.vector_norm(
        a.detach().double() - ADAM_B1 * b.to(a.device).double()))
        / (1.0 - ADAM_B1) for a, b in zip(m1, m0)]


def change_norms(after: list, before: list) -> list:
    """The norm of each leaf's change (`before` may be on the host)."""
    return [float(torch.linalg.vector_norm(
        a.detach().double() - b.to(a.device).double()))
        for a, b in zip(after, before)]


def stat_tensors(state, names=STATS) -> dict:
    return {n: getattr(state, n) for n in names}


def stat_changes(after: dict, before: dict) -> dict:
    """{statistic: norm of its change} over the names of `before`."""
    return {n: float(torch.linalg.vector_norm(
        after[n].detach().double() - before[n].to(after[n].device).double()))
        for n in before}
