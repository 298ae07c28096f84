"""The numbers that decide `correct`, worked out from the program's
readings (or the control's) and the plain reference's."""

from __future__ import annotations

import numpy as np


def image_gaps(got: list, ref: list) -> list:
    """Widest pixel gap of each checked step's render."""
    return [float((a.double() - b.double()).abs().max())
            for a, b in zip(got, ref)]


NUMBERS = ("loss_gap", "grad_norm_gap", "change_norm_gap", "image_gap",
           "stats_gap")


def stretch(got: dict, ref: dict) -> dict:
    """The numbers of one stretch of checked steps (port_bench/readings.py).

    loss_gap: the relative gap of the stretch's first loss; grad_norm_gap:
    of the first step's gradient norm, by leaf; change_norm_gap: of the
    norm of a leaf's change over the stretch, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's (they
    move under Adam by round-off alone); image_gap: the widest gap of a
    pixel of the stretch's first render; stats_gap: the worst relative
    gap of the norm of a statistic's change over the first step (the
    statistics that densify reads). The first step is the one whose
    inputs are the same on both sides. A gap of parameter norms is taken
    against the larger of the reference leaf's norm and the median
    leaf's, since some gradients are all but zero; a statistic's, against
    its own (they differ in kind)."""
    loss_gap = abs(got["losses"][0] - ref["losses"][0]) / max(
        abs(ref["losses"][0]), 1e-30)
    gref = np.array(ref["grad_norms"])
    gmed = float(np.median(gref))
    grad_gap = max(abs(a - b) / max(b, gmed, 1e-30)
                   for a, b in zip(got["grad_norms"], gref))
    cref = np.array(ref["change_norms"])
    keep = gref >= 1e-3 * gmed
    cmed = float(np.median(cref[keep]))
    change_gap = max(abs(a - b) / max(b, cmed, 1e-30)
                     for a, b, k in zip(got["change_norms"], cref, keep)
                     if k)
    stats_gap = max(_gap(got["stats"].get(n, float("inf")), b)
                    for n, b in ref["stats"].items())
    first = image_gaps(got["images"][:1], ref["images"][:1])
    return dict(loss_gap=loss_gap, grad_norm_gap=grad_gap,
                change_norm_gap=change_gap,
                image_gap=first[0] if first else float("inf"),
                stats_gap=stats_gap)


def _gap(a: float, b: float) -> float:
    if b == 0.0:
        return 0.0 if a == 0.0 else float("inf")
    return abs(a - b) / b


def train(got: list, ref: list) -> dict:
    """The numbers of `stretch` over the stretches checked (the first
    steps of the call, the step after the window): loss_gap,
    grad_norm_gap and stats_gap the worse of the two, image_gap the first
    stretch's, change_norm_gap the step after the window's. Steps 2 and 3
    of the first stretch start from states that Adam's first step, from
    zeroed moments, set apart by about a learning rate wherever a
    gradient is round-off of either sign: their losses, renders and the
    change over them are read (PERF.md) but not judged; the render after
    the window is judged through its loss. The control, which has no
    step after the window, gives no change_norm_gap. A stretch that one
    side lacks fails every number."""
    if len(got) != len(ref) or any(x is None for x in got):
        return dict.fromkeys(NUMBERS, float("inf"))
    per = [stretch(a, b) for a, b in zip(got, ref)]
    out = {k: max(p[k] for p in per)
           for k in ("loss_gap", "grad_norm_gap", "stats_gap")}
    out["image_gap"] = per[0]["image_gap"]
    if len(per) > 1:
        out["change_norm_gap"] = per[1]["change_norm_gap"]
    return out


def render(got: list, ref: list) -> dict:
    """max_pixel_gap: the widest gap of a pixel's RGB between a served
    image and the reference's; mean_pixel_gap: the largest mean gap of
    one image."""
    widest = mean = 0.0
    for a, b in zip(got, ref):
        d = (a.double() - b.double()).abs()
        widest = max(widest, float(d.max()))
        mean = max(mean, float(d.mean()))
    return dict(max_pixel_gap=widest, mean_pixel_gap=mean)
