"""K-nearest-neighbour ops (counterpart of adgs_tpu/ops/knn.py).

- `mean_knn_sq_dist` and `knn_indices` are exact host searches (numpy +
  scipy cKDTree, a brute-force fallback without scipy), copied from the
  JAX package: the initial log-scales and the exact KNN refresh of the
  trainer (ADGS_KNN_HOST=1).
- `knn_indices_device` and `near_idx_device` run on the parameters'
  device: Morton-sort the points, locate each anchor in the sorted order,
  and take the exact top k within a +-window slice of it. `near_idx_device`
  is the trainer's default KNN refresh; it takes the uniform draw that
  picks its anchors as an input, so the caller owns the random state.

Orders and ties follow the JAX functions exactly: stable sorts where JAX's
argsort is stable, left-side searchsorted, and the top k by a stable sort
of the distances (jax.lax.top_k puts the lower index first on ties;
torch.topk promises no order). Morton codes are 30 bits, computed in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..profiling import copied_in

try:
    from scipy.spatial import cKDTree
    _HAVE_SCIPY = True
except ImportError:  # pragma: no cover
    _HAVE_SCIPY = False


def mean_knn_sq_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean SQUARED distance to the k nearest neighbours (excluding self),
    exact; the initial scales."""
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    if n <= 1:
        return np.full((n,), 1e-6, dtype=np.float32)
    kk = min(k, n - 1)
    if _HAVE_SCIPY:
        tree = cKDTree(points)
        d, _ = tree.query(points, k=kk + 1, workers=-1)
        d2 = d[:, 1:] ** 2
    else:  # brute force fallback
        diff = points[:, None, :] - points[None, :, :]
        dist2 = np.sum(diff * diff, axis=-1)
        np.fill_diagonal(dist2, np.inf)
        d2 = np.sort(dist2, axis=1)[:, :kk]
    return d2.mean(axis=1).astype(np.float32)


def knn_indices(anchors: np.ndarray, points: np.ndarray, k: int) -> np.ndarray:
    """[A, k] int32 indices of the k nearest points to each anchor (exact,
    host-side); fewer than k points pad each row with its nearest."""
    anchors = np.asarray(anchors, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)
    kk = min(k, points.shape[0])
    if _HAVE_SCIPY:
        tree = cKDTree(points)
        _, idx = tree.query(anchors, k=kk, workers=-1)
        idx = np.atleast_2d(idx)
        if idx.ndim == 1:
            idx = idx[:, None]
    else:
        diff = anchors[:, None, :] - points[None, :, :]
        dist2 = np.sum(diff * diff, axis=-1)
        idx = np.argsort(dist2, axis=1)[:, :kk]
    if kk < k:  # pad by repeating the nearest
        idx = np.concatenate([idx] + [idx[:, :1]] * (k - kk), axis=1)
    return idx.astype(np.int32)


def _morton_interleave(q: torch.Tensor) -> torch.Tensor:
    """[N, 3] int64 10-bit coordinates -> [N] 30-bit Morton codes."""
    def spread(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x
    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _quantize(x: torch.Tensor, lo: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """10-bit grid coordinates: clip to [0, 1023], then truncate (JAX's
    astype(uint32) of non-negative floats)."""
    return torch.clamp((x - lo) * scale, 0, 1023).to(torch.int64)


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance over the last dim, summed left to right as XLA's
    reduction of that dim does, so that ties fall as in JAX."""
    d = a - b
    d = d * d
    out = d[..., 0]
    for j in range(1, d.shape[-1]):
        out = out + d[..., j]
    return out


def knn_indices_device(anchors: torch.Tensor, points: torch.Tensor, k: int,
                       window: int = 64) -> torch.Tensor:
    """Approximate KNN on the points' device: Morton-sort the points,
    locate each anchor in the sorted order, take the exact top k within a
    +-window slice. anchors [A, D], points [N, D] (D >= 3; the first three
    dims make the code). [A, k] int64 indices into `points`."""
    n = points.shape[0]
    lo = torch.amin(points, dim=0)
    hi = torch.amax(points, dim=0)
    scale = 1023.0 / torch.clamp(hi - lo, min=1e-9)
    codes = _morton_interleave(_quantize(points, lo, scale))
    order = torch.argsort(codes, stable=True)
    sorted_pts = points[order]
    sorted_codes = codes[order]

    a_codes = _morton_interleave(_quantize(anchors, lo, scale))
    pos = torch.searchsorted(sorted_codes, a_codes, right=False)

    offs = torch.arange(-window, window + 1, device=points.device)
    cand = torch.clamp(pos[:, None] + offs[None, :], 0, n - 1)   # [A, 2w+1]
    d2 = _sq_dist(sorted_pts[cand], anchors[:, None, :])
    top = torch.sort(d2, dim=1, stable=True).indices[:, :k]      # nearest k
    return order[torch.gather(cand, 1, top)]


def near_idx_device(pts: torch.Tensor, alive: torch.Tensor, r: torch.Tensor,
                    k: int, a_cap: int, window: int = 64):
    """KNN groups of the trajectory regularizers (set_obj_near_idx): the
    alive slots with the a_cap smallest draws r [N] (uniform on [0, 1)) as
    anchors, each with its approximate k nearest among the alive rows of
    pts [N, D >= 3] (dead rows arbitrary; alive [N] bool).

    Returns (idx [a_cap, k] int32 padded-slot indices, valid [a_cap]
    bool): the first max(n_alive // k, 1) groups are valid when at least k
    rows are alive; invalid groups hold index 0."""
    alive_col = alive[:, None]
    inf = torch.tensor(float("inf"), dtype=pts.dtype, device=pts.device)
    copied_in(inf)
    lo = torch.amin(torch.where(alive_col, pts, inf), dim=0)
    hi = torch.amax(torch.where(alive_col, pts, -inf), dim=0)
    span = torch.clamp(hi - lo, min=1e-9)
    # dead slots move to a far corner: they Morton-sort after every alive
    # point and lose every top-k by distance
    pts_m = torch.where(alive_col, pts, hi + span)
    n_alive = torch.sum(alive.to(torch.int32))

    pri = torch.where(alive, r, inf)
    anchor_slot = torch.argsort(pri, stable=True)[:a_cap]  # random alive
    idx = knn_indices_device(pts_m[anchor_slot], pts_m, k, window=window)
    n_anchor = torch.clamp(n_alive // k, min=1)
    valid = ((torch.arange(a_cap, device=pts.device) < n_anchor)
             & (n_alive >= k))
    # invalid anchors keep index 0 rows (gated by `valid`)
    idx = torch.where(valid[:, None], idx, torch.zeros_like(idx))
    return idx.to(torch.int32), valid
