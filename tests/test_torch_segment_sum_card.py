"""Kernel B5 (csrc/segment_sum.cu) against its plain twin on the card, at
the train cells' own patterns (chip_smoke.b5_train_pattern): the
compositing backward's 2,007,040 slots, whose 700,832 dead scene slots
are a run of empty segments in the middle and whose 306,208 dead object
slots are a tail at bounds[n], at 0.66 M and 1.48 M rows of D 16; the
KNN gather's 606,208 rows with 306,208 in segment 0, at D 89 and 137.
Each within 1e-6 of max|twin| (the twin sums in float64), exact zeros in
every empty segment, one counted launch a call, and a second launch
bitwise the first (the order of the additions is fixed). The `card`
fixture skips them elsewhere; run with
`python -m pytest --noconftest tests/test_torch_segment_sum_card.py`.
This file imports no JAX."""

import numpy as np
import pytest
import torch

from adgs_tpu_torch import _kernels
from adgs_tpu_torch.raster import render as rl
from chip_smoke import b5_train_pattern

CASES = {"composite_0.66M": ("composite", 660_000, 16),
         "composite_1.48M": ("composite", 1_480_000, 16),
         "knn_89": ("knn", 0, 89), "knn_137": ("knn", 0, 137)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B5 runs only there")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", list(CASES))
def test_b5_matches_twin_at_train_patterns_on_card(card, case):
    kind, used, D = CASES[case]
    rng = np.random.default_rng(20261018)
    R, b = b5_train_pattern(rng, kind, used)
    rows = torch.as_tensor(rng.standard_normal((R, D), np.float32),
                           device=card)
    bounds = torch.as_tensor(b, device=card)
    _kernels.reset_launches()
    got = rl.segment_sum(rows, bounds)
    again = rl.segment_sum(rows, bounds)
    assert _kernels.launches["segment_sum"] == 2
    want = rl.segment_sum_torch(rows, bounds)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    empty = (bounds[1:] == bounds[:-1]).nonzero()[:, 0]
    assert empty.numel() > 0 and torch.count_nonzero(got[empty]) == 0
    assert torch.equal(got, again)
