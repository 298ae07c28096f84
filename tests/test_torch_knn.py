"""The port's KNN ops (adgs_tpu_torch/ops/knn.py) against the JAX
package's, bitwise, on seeded numpy inputs (cases of
tests/test_models_ops.py::TestKNN and ::TestNearIdxDevice): the exact
host searches (scipy and the brute-force fallback, the kk < k padding),
the Morton codes, the device search (random clouds, and clouds whose
anchors sit on repeated points at both ends of the Morton order, where
the candidate window clips and distances tie) and the KNN refresh on
JAX's own anchor draw (jax.random.uniform(key, (N,))), including the
too-few-alive case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adgs_tpu.ops import knn as jknn
from adgs_tpu_torch.ops import knn as tknn


@pytest.mark.parametrize("scipy_on", [True, False])
@pytest.mark.parametrize("n", [1, 2, 200])
def test_mean_knn_sq_dist_bitwise(monkeypatch, scipy_on, n):
    monkeypatch.setattr(jknn, "_HAVE_SCIPY", scipy_on)
    monkeypatch.setattr(tknn, "_HAVE_SCIPY", scipy_on)
    pts = np.random.default_rng(n).normal(size=(n, 3))
    got = tknn.mean_knn_sq_dist(pts, k=3)
    want = jknn.mean_knn_sq_dist(pts, k=3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scipy_on", [True, False])
@pytest.mark.parametrize("n,k", [(100, 4), (3, 8), (1, 2)])
def test_knn_indices_bitwise(monkeypatch, scipy_on, n, k):
    """n < k pads each row with its nearest (kk < k)."""
    monkeypatch.setattr(jknn, "_HAVE_SCIPY", scipy_on)
    monkeypatch.setattr(tknn, "_HAVE_SCIPY", scipy_on)
    pts = np.random.default_rng(n).normal(size=(n, 3))
    anchors = pts[:10]
    got = tknn.knn_indices(anchors, pts, k=k)
    want = jknn.knn_indices(anchors, pts, k=k)
    assert got.dtype == want.dtype == np.int32 and got.shape == (
        len(anchors), k)
    np.testing.assert_array_equal(got, want)
    # first neighbour of an anchor that is a point: itself
    np.testing.assert_array_equal(got[:, 0], np.arange(len(anchors)))


def test_morton_codes_bitwise():
    q = np.random.default_rng(0).integers(0, 1024, size=(4096, 3))
    q[:3] = [[0, 0, 0], [1023, 1023, 1023], [1023, 0, 512]]
    got = tknn._morton_interleave(torch.as_tensor(q, dtype=torch.int64))
    want = jknn._morton_interleave(jnp.asarray(q, jnp.uint32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(
        np.int64))


def _tied_cloud(rng, n=300):
    """Points in [0, 1]^3 with blocks of repeated points at both Morton
    ends (the min and max corners) and anchors on them: the clipped
    window repeats candidates and distances tie."""
    pts = rng.uniform(size=(n, 3)).astype(np.float32)
    pts[:20] = 0.0
    pts[20:40] = 1.0
    pts[40:60] = np.round(pts[40:60] * 2) / 2          # a lattice
    anchors = np.concatenate([pts[:5], pts[20:25], pts[40:50],
                              pts[200:210]])
    return pts, anchors


@pytest.mark.parametrize("case", ["uniform", "ties", "dim4"])
@pytest.mark.parametrize("k,window", [(4, 8), (8, 64)])
def test_knn_indices_device_bitwise(case, k, window):
    rng = np.random.default_rng(1)
    if case == "ties":
        pts, anchors = _tied_cloud(rng)
    else:
        d = 4 if case == "dim4" else 3
        pts = rng.uniform(size=(512, d)).astype(np.float32) * 10
        anchors = pts[:32]
    got = tknn.knn_indices_device(torch.as_tensor(anchors),
                                  torch.as_tensor(pts), k, window=window)
    want = jknn.knn_indices_device(jnp.asarray(anchors), jnp.asarray(pts), k,
                                   window=window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_indices_device_recall():
    """As the JAX test: with a large window, recall of the exact KNN is
    high."""
    pts = np.random.default_rng(0).uniform(size=(512, 3)).astype(np.float32)
    idx = tknn.knn_indices_device(torch.as_tensor(pts[:32]),
                                  torch.as_tensor(pts), 4, window=128)
    exact = tknn.knn_indices(pts[:32], pts, k=4)
    rec = np.mean([len(set(a.tolist()) & set(b.tolist())) / 4.0
                   for a, b in zip(idx.numpy(), exact)])
    assert rec > 0.9


def _near_both(pts, alive, key_seed, k, a_cap, window=64):
    key = jax.random.PRNGKey(key_seed)
    j_idx, j_valid = jknn.near_idx_device(jnp.asarray(pts),
                                          jnp.asarray(alive), key, k, a_cap,
                                          window=window)
    # JAX draws its anchors' priorities from the key at ops/knn.py:141
    r = np.array(jax.random.uniform(key, (pts.shape[0],)))
    t_idx, t_valid = tknn.near_idx_device(
        torch.as_tensor(pts), torch.as_tensor(alive), torch.as_tensor(r), k,
        a_cap, window=window)
    assert t_idx.dtype == torch.int32 and t_valid.dtype == torch.bool
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    return t_idx.numpy(), t_valid.numpy()


@pytest.mark.parametrize("case", ["time4", "xyz3", "ties", "all_alive"])
def test_near_idx_device_bitwise(case):
    rng = np.random.default_rng(2)
    N, K = 512, 8
    if case == "ties":
        pts, _ = _tied_cloud(rng, N)
    else:
        d = 4 if case == "time4" else 3
        pts = rng.uniform(size=(N, d)).astype(np.float32) * 10
    alive = np.ones(N, bool)
    if case != "all_alive":
        alive[:] = False
        alive[rng.permutation(N)[:300]] = True
    idx, valid = _near_both(pts, alive, 5, K, N // K,
                            window=128 if case == "time4" else 64)
    n_alive = int(alive.sum())
    assert valid.sum() == min(N // K, n_alive // K)
    assert alive[idx[valid]].all()
    assert not idx[~valid].any()


def test_near_idx_device_too_few_alive():
    pts = np.random.default_rng(3).uniform(size=(64, 3)).astype(np.float32)
    alive = np.zeros(64, bool)
    alive[:3] = True
    _, valid = _near_both(pts, alive, 1, 8, 8)
    assert not valid.any()
