"""The port's LPIPS (ops/lpips.py) against the JAX package's on synthetic
weights built as tests/test_lpips.py builds them (rtol 1e-4; both run
their convolutions in full float32), its weight ingestion, and the
missing-weights contract: lpips_fn returns None."""

import numpy as np
import pytest
import torch

from adgs_tpu.ops import lpips as jlp
from adgs_tpu_torch.ops import lpips as tlp
from tests import test_lpips as jtest
from tests.test_lpips import _rand_params


def _tensors(params):
    return {k: torch.as_tensor(v) for k, v in params.items()}


@pytest.mark.parametrize("net_type", ["vgg", "alex"])
def test_lpips_matches_jax(net_type):
    rng = np.random.default_rng(7)
    params = _rand_params(rng, net_type)
    size = 64 if net_type == "vgg" else 96  # alex stride-4 conv needs room
    x = rng.uniform(size=(3, size, size)).astype(np.float32)
    y = rng.uniform(size=(3, size, size)).astype(np.float32)
    want = float(jlp.lpips_from_params(params, net_type, x, y))
    got = float(tlp.lpips_from_params(_tensors(params), net_type,
                                      torch.as_tensor(x), torch.as_tensor(y)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got > 0


def test_lpips_fn_from_npz_and_torch_files(tmp_path):
    rng = np.random.default_rng(5)
    params = _rand_params(rng, "alex")
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **params)
    fn = tlp.lpips_fn("alex", weights_path=path, device="cpu")
    x = rng.uniform(size=(3, 96, 96)).astype(np.float32)
    y = rng.uniform(size=(3, 96, 96)).astype(np.float32)
    want = float(jlp.lpips_fn("alex", weights_path=path)(x, y))
    got = float(fn(torch.as_tensor(x), torch.as_tensor(y)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the reference's own torch checkpoints parse to the same arrays
    trunk_p, heads_p, _, _ = (jtest.TestTorchWeightIngestion()
                              ._synthetic_alex_files(tmp_path, rng))
    got_w = tlp.load_weights_torch(trunk_p, heads_p, "alex")
    want_w = jlp.load_weights_torch(trunk_p, heads_p, "alex")
    assert got_w.keys() == want_w.keys()
    for k in want_w:
        np.testing.assert_array_equal(got_w[k], np.asarray(want_w[k]))


def test_lpips_fn_none_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    monkeypatch.delenv("ADGS_LPIPS_WEIGHTS", raising=False)
    monkeypatch.delenv("ADGS_LPIPS_TORCH_TRUNK", raising=False)
    for net in ("vgg", "alex"):
        assert tlp.lpips_fn(net, weights_path=str(tmp_path / "absent.npz"),
                            device="cpu") is None
