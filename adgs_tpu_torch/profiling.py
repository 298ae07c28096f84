"""Profiling and tracing (counterpart of adgs_tpu/profiling.py).

- `trace(logdir)`: a context manager around torch.profiler (host and, on
  a card, device activity) that writes one Chrome trace into `logdir`
  (open it in chrome://tracing or Perfetto; no tensorboard package is
  needed). The trainer wraps a short window of steps in it when launched
  with --profile.
- `span(name)`, `count(name, n)`, `summary()`, `reset()`: the program's
  own spans and counters, recorded only while a torch profiler runs
  (`trace`, or any other `torch.profiler.profile`).

Spans. `with span(name):` around a piece of the program. A span records
when its parent span records; a span with no open parent (a root)
records only if a torch profiler is running when it opens, and is kept
only if one still runs when it closes (a root that outlives the profiler
has a tail that the trace lacks: the profiler's own teardown, where a
caller stops it inside a step). A recording
span opens a `torch.profiler.record_function(name)` range, so that it
lies in the profiler's Chrome trace beside the device's kernels, and
keeps (name, start, end, parent, counters) in memory; its times are
`time.time_ns()`, the clock of the trace's timestamps (unix-epoch ns:
a trace event's `ts` in µs plus the trace's `baseTimeNanoseconds`). The
root carries the number of its iteration or frame, which every span of
that step or frame shares. A span that does not record is one shared
no-op object that only counts its nesting depth, so that no child of it
records or becomes a root of its own (a profiler started in the middle
of a step leaves no orphan roots): the cost off is a flag read and a
call, and nothing is allocated.

Counters. `count(name, n)` adds n to the innermost recording span (and
does nothing when none records). The program counts:
  - "h2d_bytes": bytes copied from host memory to the model's device
    (counted whatever the device is, so that a CPU run counts them too);
  - "host_syncs": the points at which the host waits for the card: reads
    of a device value on the host, and host-to-device copies from
    pageable memory, which PyTorch ends in a stream synchronize (counted
    at the same code points on any device);
  - "splat_instances": the (Gaussian, tile) instances a training step
    rendered, its num_rendered, which the trainer reads for its overflow
    guard anyway (on a mesh, the sum over the step's cameras and slabs):
    the count that sizes the expansion, compositing and reduction
    kernels. Counted on the host value, so it adds no read;
  - "densify_cloned", "densify_split", "densify_pruned",
    "densify_dropped": a densify's clones, split samples written, prunes
    and copies dropped for want of a free slot, both blocks summed (in
    "trainer.densify", from its report read in one copy);
  - "capacity_grows": a growth of the instance capacity or of the
    Gaussian blocks (in its span "trainer.grow");
  - "frame_cameras", "frame_deforms": the cameras that a served frame
    renders and the deformations it evaluates (in its root "serve.frame":
    a rig of three cameras at one time counts 3 and 1, a single camera 1
    and 1).

The served frame (render.make_staged_render_fn) is the root
"serve.frame" > "render.deform", then one "render.camera" for each of
its cameras (numbered by the camera's place in the frame) >
"render.preprocess", "render.binning", "render.compositing",
"render.sky".

The store keeps the last `MAX_ROOTS` roots; `reset()` clears it, and
`summary()` reduces it to per-root means. One store serves the process,
as the profiler does; the program traces from one thread.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

MAX_ROOTS = 1000

_profiler_enabled = torch._C._autograd._profiler_enabled


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


class _State:
    __slots__ = ("open", "off", "roots")

    def __init__(self):
        self.open: list = []     # the open recording spans, outermost first
        self.off = 0             # nesting depth of the open no-op spans
        self.roots = collections.deque(maxlen=MAX_ROOTS)


_state = _State()


class Span:
    """A recording span (see the module docstring): name, number (the
    root's iteration or frame; below it None, or the child's place that
    the caller gave), start_ns / end_ns
    (`time.time_ns()`), parent, children, counts (the counters added while
    it was the innermost recording span, or None)."""

    __slots__ = ("name", "number", "start_ns", "end_ns", "parent",
                 "children", "counts", "_range")

    def __init__(self, name: str, number: Optional[int] = None):
        self.name, self.number = name, number
        self.start_ns = self.end_ns = 0
        self.parent = None
        self.children: list = []
        self.counts: Optional[dict] = None

    def __enter__(self):
        st = _state.open
        self.parent = st[-1] if st else None
        self._range = record_function(self.name)
        self.start_ns = time.time_ns()
        self._range.__enter__()
        st.append(self)
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        self._range = None
        _state.open.pop()
        if self.parent is None:
            if _profiler_enabled():
                _state.roots.append(self)
        else:
            self.parent.children.append(self)
        return False

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def walk(self):
        """This span and every span below it, depth first in order."""
        yield self
        for c in self.children:
            yield from c.walk()


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        _state.off += 1
        return self

    def __exit__(self, *exc):
        _state.off -= 1
        return False


_OFF = _Off()


def span(name: str, number: Optional[int] = None):
    """A context manager that records `name` under the rules of the module
    docstring; `number` labels a root (its iteration or frame), or a child
    among its siblings (a camera's place in a served frame)."""
    if _state.open:
        return Span(name, number)
    if _state.off or not _profiler_enabled():
        return _OFF
    return Span(name, number)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the innermost recording span."""
    if _state.open:
        s = _state.open[-1]
        if s.counts is None:
            s.counts = {}
        s.counts[name] = s.counts.get(name, 0) + n


def copied_in(*tensors: torch.Tensor) -> None:
    """Count host-to-device copies that made `tensors` (one each): their
    bytes under "h2d_bytes" and, since a copy from pageable memory ends in
    a stream synchronize, one "host_syncs" each."""
    if _state.open:
        count("h2d_bytes", sum(t.nbytes for t in tensors))
        count("host_syncs", len(tensors))


def roots() -> list:
    """The stored root spans, oldest first."""
    return list(_state.roots)


def reset() -> None:
    """Clear the store (the spans open now are kept when they close)."""
    _state.roots.clear()


def summary() -> dict:
    """{root name: {"roots": number of roots, "spans": {span name: {"ms":
    host ms, "self_ms": ms outside its child spans, "counts": {counter:
    count, children's included}}}}}, each value per root: the sum over
    every root of that name (and every span of that name below it) over
    the number of roots. The root's own name is among its spans."""
    out: dict = {}
    for root in list(_state.roots):
        group = out.setdefault(root.name, {"roots": 0, "spans": {}})
        group["roots"] += 1
        _add(root, group["spans"])
    for group in out.values():
        n = group["roots"]
        for entry in group["spans"].values():
            entry["ms"] /= n
            entry["self_ms"] /= n
            entry["counts"] = {k: v / n for k, v in entry["counts"].items()}
    return out


def _add(s: Span, spans: dict) -> dict:
    """Add s and its subtree to `spans`; returns s's counts with its
    children's."""
    entry = spans.setdefault(s.name, {"ms": 0.0, "self_ms": 0.0,
                                      "counts": {}})
    own = dict(s.counts or {})
    child_ms = 0.0
    for c in s.children:
        child_ms += c.ms
        for k, v in _add(c, spans).items():
            own[k] = own.get(k, 0) + v
    entry["ms"] += s.ms
    entry["self_ms"] += s.ms - child_ms
    for k, v in own.items():
        entry["counts"][k] = entry["counts"].get(k, 0) + v
    return own
