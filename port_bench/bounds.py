"""Bounds of recorded launches: each hand kernel's least time at the shapes
and data it was launched with (roofline.py's arithmetic). B3 and B4 count
the (instance, pixel) pairs that the frozen plain compositor evaluates
on the same rows; B7 the distinct sky cells its taps reach, by the frozen
sampler's tap rule."""

from __future__ import annotations

import torch

from . import roofline
from .reference.plain.ops.grid_sample import _taps
from .reference.plain.raster import render as plain_render


def pair_counts(rec: dict, cache: dict):
    """(hit, gated, culled) of a B3 or B4 launch; launches over the same
    rows (a step's B3 and B4) share one count."""
    key = (rec["packed"].data_ptr(), rec["gauss_id"].data_ptr())
    if key not in cache:
        rows = (rec["gauss_id"], rec["tile_start"], rec["tile_count"],
                rec["grid_x"])
        with torch.no_grad():
            masks = plain_render.quarter_masks_torch(
                rec["packed"], *rows, layout=rec["layout"])
            _, _, pairs = plain_render.composite_fwd_torch(
                rec["packed"], rec["ch"], *rows, count_pairs=True,
                layout=rec["layout"], masks=masks)
        cache[key] = (int(pairs.hit), int(pairs.gated), int(pairs.culled))
    return cache[key]


def launch_bounds(launches: list) -> dict:
    """{kernel id: (summed bound seconds, launches)}, and under "pairs" the
    B3 pair counts of each frame: [(hit, gated, culled, ch), ...]."""
    out: dict = {}
    cache: dict = {}
    frames = []
    for rec in launches:
        kid = rec["id"]
        if kid == "B2":
            nb, fl = roofline.compact_live(rec["n"])
        elif kid == "B1":
            nb, fl = roofline.expand(int(rec["n_live"].reshape(-1)[0]),
                                     rec["slots"])
        elif kid == "B3":
            hit, gated, culled = pair_counts(rec, cache)
            R = int(rec["gauss_id"].shape[0])
            T = int(rec["tile_start"].shape[0])
            nb, fl = roofline.composite_fwd(rec["packed"].numel(), R, T,
                                            rec["ch"], hit, gated, culled)
            frames.append((hit, gated, culled, rec["ch"]))
        elif kid == "B4":
            hit, gated, _ = pair_counts(rec, cache)
            R = int(rec["gauss_id"].shape[0])
            nb, fl = roofline.composite_bwd(rec["packed"].numel(), R,
                                            rec["fwd_numel"], rec["ch"], hit,
                                            gated)
        elif kid == "B5":
            b = rec["bounds"]
            n = int(b.shape[0]) - 1
            used = int(b[-1]) - int(b[0])
            nb, fl = roofline.segment_sum(used, rec["D"], n)
        elif kid == "B7":
            shape, coords = rec["grid_shape"], rec["coords"]
            nb, fl = roofline.grid_sample(coords.numel() // 2, shape[0],
                                          sky_cells(shape, coords))
        elif kid == "B8":
            nb, fl = roofline.grid_sample_bwd(rec["npix"], rec["C"],
                                              rec["grid_numel"])
        else:
            continue
        total, n = out.get(kid, (0.0, 0))
        out[kid] = (total + roofline.bound_s(nb, fl), n + 1)
    out["pairs"] = frames
    return out


def sky_cells(grid_shape, coords) -> int:
    """Distinct cells of the sky grid that a frame's taps reach."""
    return int(torch.unique(torch.cat(
        [(yi * grid_shape[2] + xi).reshape(-1)
         for xi, yi, _ in _taps(grid_shape, coords)])).numel())


def roofline_share(counts: dict, kept: dict, kernel_s: dict):
    """The hand kernels' share of their roofline: each kernel's launches
    in the profiled pass times its mean bound per launch in the kept pass,
    summed, over the summed device seconds of its CUDA kernels in the
    profiled pass; None where no kernel has all three."""
    ids = [k for k in counts if k in kept and kernel_s.get(k)]
    if not ids:
        return None
    bound = sum(counts[k] * kept[k][0] / kept[k][1] for k in ids)
    return 100.0 * bound / sum(kernel_s[k] for k in ids)
