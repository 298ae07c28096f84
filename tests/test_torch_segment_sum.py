"""Kernel B5's contract (adgs_tpu_torch.raster.render.segment_sum and its
two callers) against the JAX package on the same numpy inputs, and the
ctypes bindings of every kernel wrapper against the C sources.

The port's wrappers run their plain twins here (CPU tensors); the CUDA
kernels are held to the same twins on the card by chip_smoke.py. The rows
are dyadic (multiples of 2^-8, |x| <= 8), so every partial sum of a few
thousand of them is exact in float32 and the comparisons at 1e-6 test the
segments' bounds, the clipping at the capacity and the empty segments,
not the order of the additions, which differs between the JAX kernel's
one-hot matmuls, the twin's float64 running sum and the card."""

import ctypes
import re
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adgs_tpu.raster.pallas import render as jpal
from adgs_tpu.train import losses as jlosses
from adgs_tpu_torch import _kernels
from adgs_tpu_torch.raster import render as trender
from adgs_tpu_torch.train import losses as tlosses

TOL = dict(rtol=1e-6, atol=1e-6)
PORT = Path(__file__).resolve().parent.parent / "adgs_tpu_torch"


def _dyadic(rng, shape) -> np.ndarray:
    return np.clip(np.round(rng.normal(size=shape) * 256) / 256,
                   -8, 8).astype(np.float32)


def _loop_sums(rows: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """out[i] = rows[bounds[i]:bounds[i+1]].sum(0) in float64, one
    segment at a time."""
    out = np.zeros((len(bounds) - 1, rows.shape[1]), np.float64)
    for i in range(len(bounds) - 1):
        out[i] = rows[bounds[i]:bounds[i + 1]].astype(np.float64).sum(0)
    return out


def test_segment_reduce_contiguous_matches_jax(rng):
    """Per-Gaussian sums of presort rows against JAX's
    segment_reduce_contiguous (Pallas, interpret mode): one Gaussian of
    3,000 rows, ~40% with none, and num_rendered past the capacity, so
    the last Gaussians are clipped or dropped."""
    n, gc = 700, 16
    tiles = rng.integers(1, 5, size=n)
    tiles[rng.random(n) < 0.4] = 0
    tiles[5] = 3000
    start = (np.cumsum(tiles) - tiles).astype(np.int32)
    nr = int(tiles.sum())
    R = nr - 150
    rows = _dyadic(rng, (R, gc))
    # JAX: component-major [gc, R] columns with one pad chunk of SEG_C
    cols = np.zeros((gc, R + jpal.SEG_C), np.float32)
    cols[:, :R] = rows.T
    want = np.asarray(jpal.segment_reduce_contiguous(
        jnp.asarray(cols), jnp.asarray(start), jnp.int32(nr), n))
    got = trender.segment_sum(torch.as_tensor(rows), trender.contiguous_bounds(
        torch.as_tensor(start), torch.tensor(nr, dtype=torch.int32),
        R)).numpy()
    assert got.shape == want.shape == (n, gc)
    assert (start + tiles > R).any() and (start >= R).any()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want[5]).max() > 0


def _check_group_gather(rng, n_val, A, padded_from):
    """GroupGather's backward against jax.vjp of _group_gather, D = 12,
    K = 8, the groups from padded_from on all on value 0."""
    D, K = 12, 8
    idx = rng.integers(0, n_val, size=(A, K)).astype(np.int32)
    idx[padded_from:] = 0
    values = rng.normal(size=(n_val, D)).astype(np.float32)
    d_g = _dyadic(rng, (A, K, D))
    _, vjp = jax.vjp(jlosses._group_gather, jnp.asarray(values),
                     jnp.asarray(idx))
    want = np.asarray(vjp(jnp.asarray(d_g))[0])
    v = torch.as_tensor(values).requires_grad_(True)
    out = tlosses.GroupGather.apply(v, torch.as_tensor(idx))
    np.testing.assert_array_equal(out.detach().numpy(), values[idx])
    (got,) = torch.autograd.grad(out, v, torch.as_tensor(d_g))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(want[0]).max() > 0


def test_group_gather_backward_matches_jax(rng):
    """The KNN group gather's backward (sort + segment_sum) against
    jax.vjp of adgs_tpu.train.losses._group_gather, with a quarter of the
    anchor groups padded to value 0, as the card's KNN groups are past the
    valid anchors (value 0 then holds ~200 rows)."""
    _check_group_gather(rng, 300, 96, 3 * 96 // 4)


def test_group_gather_backward_pile_matches_jax(rng):
    """The same with every group past the first quarter on value 0, as in
    the train cells (value 0 then holds over 5,000 rows of 6,672)."""
    _check_group_gather(rng, 2000, 834, 834 // 4)


def _case(rng, kind: str, D: int):
    """(rows [R, D], bounds [n+1]) of the chip's synthetic B5 cases, cut
    down: one segment of 5,000 rows among 2,000 of 0-3 rows; every
    segment empty; bounds[0] > 0 with bounds[n] < R; and the compositing
    backward's pattern in the train cells: alive segments of 0-3 rows, a
    run of 5,000 empty ones in the middle, more alive ones, then an empty
    tail at bounds[n] < R."""
    if kind == "long":
        lens = rng.integers(0, 4, size=2000)
        lens[700] = 5000
        bounds = np.concatenate([[0], np.cumsum(lens)])
        R = int(bounds[-1])
    elif kind == "empty":
        R = 64
        bounds = np.full(1001, 37)
    elif kind == "pile":
        lens = np.concatenate([rng.integers(0, 4, size=700),
                               np.zeros(5000, np.int64),
                               rng.integers(0, 4, size=300),
                               np.zeros(800, np.int64)])
        bounds = np.concatenate([[0], np.cumsum(lens)])
        R = int(bounds[-1]) + 50
    else:
        lens = rng.integers(0, 6, size=500)
        bounds = 23 + np.concatenate([[0], np.cumsum(lens)])
        R = int(bounds[-1]) + 41
    return _dyadic(rng, (R, D)), bounds.astype(np.int32)


@pytest.mark.parametrize("kind", ["long", "empty", "offset", "pile"])
@pytest.mark.parametrize("D", [1, 3, 16, 33, 98])
def test_segment_sum_cases(rng, kind, D):
    """segment_sum on CPU tensors (its plain twin) against a float64 loop
    over the segments; empty segments are exact zeros."""
    rows, bounds = _case(rng, kind, D)
    got = trender.segment_sum(torch.as_tensor(rows),
                              torch.as_tensor(bounds)).numpy()
    want = _loop_sums(rows, bounds)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    empty = bounds[1:] == bounds[:-1]
    assert empty.any() and np.all(got[empty] == 0)


def test_entry_binds_once(monkeypatch):
    """_kernels.entry resolves a symbol and sets its signature on the first
    call only (here a libc function stands in for a kernel library)."""
    calls = []
    libc = ctypes.CDLL(None)

    def fake_library(name):
        calls.append(name)
        return libc

    monkeypatch.setattr(_kernels, "library", fake_library)
    monkeypatch.setattr(_kernels, "_entries", {})
    fn = _kernels.entry("segment_sum", "abs", "i")
    assert _kernels.entry("segment_sum", "abs", "i") is fn
    assert calls == ["segment_sum"]
    assert fn.restype is ctypes.c_int and fn.argtypes == [ctypes.c_int]
    assert fn(-3) == 3


def _c_signatures() -> dict:
    """{symbol: signature} of every extern "C" entry point in csrc/, in
    _kernels.entry's letters."""
    sigs = {}
    for src in sorted((PORT / "csrc").glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" int (adgs_\w+)\(([^)]*)\)', src.read_text()):
            letters = ""
            for p in params.split(","):
                p = " ".join(p.split())
                letters += ("p" if "*" in p else "q" if "long long" in p
                            else "i")
            sigs[name] = letters
    return sigs


def test_entry_signatures_match_sources():
    """Every _kernels.entry call of the port names a C entry point of
    csrc/ with its exact argument list (ctypes would pass a pointer given
    an int code as 32 bits), and every entry point is bound somewhere."""
    c_sigs = _c_signatures()
    bound = {}
    for py in sorted(PORT.rglob("*.py")):
        for sym, sig in re.findall(
                r'_kernels\.entry\([^,]+,\s*"(adgs_\w+)",\s*"([piq]+)"\)',
                py.read_text()):
            assert c_sigs.get(sym) == sig, (py.name, sym, sig, c_sigs.get(sym))
            bound[sym] = sig
    assert bound == c_sigs
