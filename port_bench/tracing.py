"""What a traced run reads besides the host clock: launches of the hand
kernels with their shapes (recorded by wrapping the program's kernel
wrappers from here), and a torch.profiler sub-window reduced to device
busy time, per-kernel device time, the device's idle gaps and what the
host was doing in them.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import tempfile
import time

import torch

# the CUDA kernels of each hand kernel's source (adgs_tpu_torch/csrc)
KERNEL_NAMES = {
    "B2": ("count_kernel", "scan_kernel", "scatter_kernel"),
    "B1": ("expand_kernel",),
    "B3": ("composite_fwd_kernel", "fwd_order_kernel"),
    "B4": ("composite_bwd_kernel", "tile_order_kernel"),
    "B5": ("spans_kernel", "tiles_kernel"),
    "B6": ("pad_lanes_kernel",),
    "B7": ("grid_sample_kernel",),
    "B8": ("pixel_keys_kernel", "tap_values_kernel", "sum_fill_kernel"),
}
_BY_NAME = {k: kid for kid, names in KERNEL_NAMES.items() for k in names}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW_ANNOTATION = "port_bench.window"


def hand_kernel(name: str):
    """The id (B1..B8) of a device kernel's name, or None: the last
    identifier before its template or argument list."""
    head = re.split(r"[(<]", name.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0]
    parts = re.split(r"::|\s+", head.strip())
    return _BY_NAME.get(parts[-1]) if parts else None


class LaunchRecorder:
    """Wraps the program's kernel wrappers (module attributes, looked up
    at each call). In mode "count" it counts each hand kernel's launches
    and keeps nothing, so that a profiled pass allocates nothing more than
    the program does; in mode "keep" it keeps each launch's shapes and the
    tensors its bound needs (B1's live count, B3/B4's rows and ranges,
    B5's bounds, B7's coordinates), by reference; None records nothing."""

    def __init__(self):
        self.mode = None
        self.counts: dict = {}
        self.launches: list = []
        self._undo: list = []

    def _wrap(self, module, attr, kid, describe):
        orig = getattr(module, attr)

        def wrapped(*args, **kwargs):
            if self.mode == "count":
                self.counts[kid] = self.counts.get(kid, 0) + 1
            elif self.mode == "keep":
                self.launches.append(dict(describe(*args, **kwargs), id=kid))
            return orig(*args, **kwargs)

        setattr(module, attr, wrapped)
        self._undo.append((module, attr, orig))

    def install(self):
        from adgs_tpu_torch.ops import grid_sample as gs
        from adgs_tpu_torch.raster import binning as bl
        from adgs_tpu_torch.raster import render as rl
        from adgs_tpu_torch.train import losses

        def b2(starts, tiles, *rest):
            return dict(n=int(tiles.shape[0]))

        def b1(table, n_live, num_rendered, capacity, *rest):
            return dict(n_live=n_live.detach().clone(), slots=int(capacity))

        def b3(packed, ch, gauss_id, tile_start, tile_count, grid_x,
               layout="gather"):
            return dict(packed=packed, ch=int(ch),
                        gauss_id=gauss_id, tile_start=tile_start,
                        tile_count=tile_count, grid_x=int(grid_x),
                        layout=layout)

        def b4(packed, ch, gauss_id, slot_sorted, tile_start, tile_count,
               grid_x, fwd_out, g_out, layout="gather"):
            return dict(packed=packed, ch=int(ch),
                        gauss_id=gauss_id, tile_start=tile_start,
                        tile_count=tile_count, grid_x=int(grid_x),
                        fwd_numel=int(fwd_out.numel()), layout=layout)

        def b5(rows, bounds):
            return dict(D=int(rows.shape[1]), bounds=bounds)

        def b7(grid, coords):
            return dict(grid_shape=tuple(grid.shape),
                        coords=coords)

        def b8(g, coords, grid_shape):
            C, Hg, Wg = grid_shape
            return dict(C=int(C), npix=int(coords.numel() // 2),
                        grid_numel=int(C * Hg * Wg))

        self._wrap(bl, "compact_live", "B2", b2)
        self._wrap(bl, "expand", "B1", b1)
        self._wrap(rl, "composite_fwd", "B3", b3)
        self._wrap(rl, "composite_bwd", "B4", b4)
        self._wrap(rl, "segment_sum", "B5", b5)
        self._wrap(losses, "segment_sum", "B5", b5)
        self._wrap(gs, "grid_sample", "B7", b7)
        self._wrap(gs, "grid_sample_bwd", "B8", b8)
        return self

    def uninstall(self):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()


def warm_up() -> None:
    """One short profiler session in set-up: the first session on a
    process loads and starts the profiler's device tracing (seconds),
    which would otherwise fall inside the traced steps."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities):
        x = torch.ones(1024, device="cuda" if cuda else "cpu")
        (x * 2).sum().item()


@contextlib.contextmanager
def profiled():
    """torch.profiler over the enclosed block (CPU and CUDA activity),
    inside one annotation that marks the sub-window on the trace's clock.
    Yields a dict that holds, on exit, the reduced trace (see reduce)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    out: dict = {}
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW_ANNOTATION):
            yield out
            if cuda:
                torch.cuda.synchronize()
        out["host_window_s"] = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.update(reduce(events))


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events: list, top: int = 10) -> dict:
    """A Chrome trace's events -> window_s (the annotated sub-window),
    busy_s (the union of device kernels, copies and sets inside it),
    device_ops (the `top` device ops by total seconds), kernel_s (seconds
    of each hand kernel), idle_gaps (the `top` longest gaps between busy
    intervals, named by the innermost host op running at the gap's
    start). Times in the trace are microseconds on one clock."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_ANNOTATION]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if t <= w0 or s >= w1:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((max(s, w0), min(t, w1), e.get("name", "?")))
        elif cat in HOST_CATS and e.get("name") != WINDOW_ANNOTATION:
            host.append((s, t, e.get("name", "?")))
    busy = _merge([[s, t] for s, t, _ in dev])
    busy_us = sum(t - s for s, t in busy)
    per_op: dict = {}
    kernel_s: dict = {}
    for s, t, name in dev:
        per_op[name] = per_op.get(name, 0.0) + (t - s) * 1e-6
        kid = hand_kernel(name)
        if kid:
            kernel_s[kid] = kernel_s.get(kid, 0.0) + (t - s) * 1e-6
    gaps = []
    edge = w0
    for s, t in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    host.sort(key=lambda h: h[0])
    for g0, g1 in gaps[:top]:
        inside = [h for h in host if h[0] <= g0 < h[1]]
        label = (min(inside, key=lambda h: h[1] - h[0])[2] if inside
                 else "host idle")
        named.append([label[:80], (g1 - g0) * 1e-6])
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                device_ops=[[k[:80], v] for k, v in ops],
                idle_gaps=named, kernel_s=kernel_s,
                device_events=len(dev))
