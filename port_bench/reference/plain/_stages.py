"""Optional CUDA-event marks between the stages of a render.

A caller that wants per-stage device times passes a list as `stage_marks`
to render(); each stage appends (name, event) when it has been enqueued.
With None (the default) nothing is recorded and nothing is synchronized.
"""

from __future__ import annotations

from typing import Optional

import torch


def mark(marks: Optional[list], name: str) -> None:
    """Record a CUDA event named after the stage that just ended."""
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))


def stage_ms(marks: list) -> dict[str, float]:
    """Device ms of each stage: the time from the previous mark to its own.
    The events must have completed (synchronize first)."""
    return {name: prev.elapsed_time(ev)
            for (_, prev), (name, ev) in zip(marks, marks[1:])}
