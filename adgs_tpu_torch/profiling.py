"""Profiling and tracing hooks (counterpart of adgs_tpu/profiling.py).

- `trace(logdir)`: a context manager around torch.profiler (host and, on
  a card, device activity) that writes one Chrome trace into `logdir`
  (open it in chrome://tracing or Perfetto; no tensorboard package is
  needed). The trainer wraps a short window of steps in it when launched
  with --profile.
- `StepTimer`: EMA wall-clock per-step timer; the trainer logs its
  steps_per_sec beside the losses.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; on exit write
    `<logdir>/trace_<pid>_<ns>.json`."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self._ema_coef = ema
        self.ema_s: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.ema_s = (dt if self.ema_s is None
                      else self._ema_coef * self.ema_s
                      + (1 - self._ema_coef) * dt)

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.ema_s if self.ema_s else 0.0
