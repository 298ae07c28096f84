"""Known-pose multi-view triangulation (native COLMAP replacement;
counterpart of adgs_tpu/geometry/triangulate.py, whose array work runs
here on a torch device).

The reference shells out to the COLMAP binary to produce its static SfM
cloud (scripts/colmap.py:105-186: feature_extractor + exhaustive_matcher +
point_triangulator with fixed known poses, masked by object+sky masks; the
result feeds `colmap-*.ply`, asserted to exist by data/readers.py). This
module is a self-contained replacement with the same contract:

  features   -> OpenCV SIFT restricted to the static mask (host, lazy cv2)
  matching   -> ratio-test descriptor matching over frame pairs (device)
  tracks     -> union-find over matched keypoint observations (host)
  geometry   -> batched multi-view DLT with the poses held FIXED (the
                dataset gives exact per-frame extrinsics, so there is no
                bundle adjustment — matching --Mapper.ba_refine_* 0)
                (device)
  filtering  -> reprojection error / triangulation angle / cheirality,
                mirroring the reference's triangulator flags
                (--Mapper.filter_max_reproj_error 4,
                 --Mapper.filter_min_tri_angle 0.5) (device)

`build_tracks` stays on the host and bitwise the reference's: its union
order, path compression and renumbering fix the track ids every later
step writes. The reference's `ufunc.at` reductions become `index_add_`
and `scatter_reduce_` on buffers initialised as its are (zeros, 0, 1,
True), the float64 `index_add_` summing in an order of its own on CUDA.
`torch.linalg.eigh`'s eigenvector signs are arbitrary; the homogeneous
point does not depend on them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device

F64 = torch.float64
# candidates per query re-ranked by direct differences: the expansion
# |a|^2 + |b|^2 - 2 a.b loses digits on SIFT descriptors (entries up to
# 255, norms about 512)
RERANK = 8


class Observations(NamedTuple):
    """Flat keypoint observations across all frames (xy and frame may be
    device tensors; offset and color stay numpy on the host)."""
    xy: np.ndarray        # [O, 2] pixel coordinates
    frame: np.ndarray     # [O] frame index per observation
    offset: np.ndarray    # [F+1] obs id range per frame (kp k of frame f
    #                       has obs id offset[f] + k)
    color: np.ndarray     # [O, 3] sampled image color (uint8)


class Tracks(NamedTuple):
    track_of: np.ndarray  # [O] track id per observation (-1: unmatched)
    n_tracks: int


def detect_features(image: np.ndarray, mask: Optional[np.ndarray] = None,
                    max_features: int = 8192):
    """SIFT keypoints + descriptors inside the static-region mask.

    image: [H, W, 3] uint8 (or [H, W] gray); mask: [H, W] bool, True where
    features are allowed (reference: object mask == 0 AND sky mask == 0,
    scripts/colmap.py:208-214)."""
    import cv2
    gray = (cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
            if image.ndim == 3 else image)
    m8 = None if mask is None else (mask.astype(np.uint8) * 255)
    sift = cv2.SIFT_create(nfeatures=max_features)
    kps, desc = sift.detectAndCompute(gray, m8)
    if not kps:
        return np.zeros((0, 2), np.float32), np.zeros((0, 128), np.float32)
    xy = np.asarray([kp.pt for kp in kps], dtype=np.float32)
    return xy, desc.astype(np.float32)


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      ratio: float = 0.8) -> torch.Tensor:
    """Lowe-ratio matches [M, 2] int64 (indices into a / b), mutual-best,
    on the descriptors' device: cv2.BFMatcher(NORM_L2).knnMatch(k=2)'s
    result. The two nearest neighbours of each query (float32 distances,
    ties to the lower index) pass if d0 < ratio * d1, or unconditionally
    when b has one row; then each b index keeps its first query."""
    dev = desc_a.device
    na, nb = len(desc_a), len(desc_b)
    if na == 0 or nb == 0:
        return torch.zeros((0, 2), dtype=torch.long, device=dev)
    a = desc_a.to(torch.float32)
    b = desc_b.to(dev, torch.float32)
    k = min(RERANK, nb)
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * (a @ b.T))
    cand = torch.topk(d2, k, dim=1, largest=False).indices
    del d2
    cand = torch.sort(cand, dim=1).values
    diff = a[:, None, :] - b[cand]
    dist = torch.sqrt((diff * diff).sum(-1))               # [na, k]
    dist, order = torch.sort(dist, dim=1, stable=True)
    best = torch.gather(cand, 1, order[:, :1])[:, 0]
    if k == 1:
        keep = torch.ones(na, dtype=torch.bool, device=dev)
    else:
        keep = dist[:, 0].to(F64) < ratio * dist[:, 1].to(F64)
    qa = torch.nonzero(keep)[:, 0]
    qb = best[keep]
    if len(qa) == 0:
        return torch.zeros((0, 2), dtype=torch.long, device=dev)
    # one-to-one on the b side: the first query (in query order) of each b
    pos = torch.arange(len(qa), device=dev)
    first = torch.full((nb,), len(qa), dtype=torch.long, device=dev)
    first.scatter_reduce_(0, qb, pos, "amin", include_self=True)
    sel = first[qb] == pos
    return torch.stack([qa[sel], qb[sel]], dim=1)


def build_tracks(offset: np.ndarray,
                 pair_matches: Sequence[tuple[int, int, np.ndarray]]
                 ) -> Tracks:
    """Union-find merge of pairwise matches into multi-view tracks.

    pair_matches: iterable of (frame_a, frame_b, [M, 2] kp-index matches).
    Observations that never match stay track -1; merged components are
    renumbered 0..n_tracks-1. Components with two observations in the SAME
    frame are inconsistent (a colmap two-view-track analog of a bad merge)
    and are dropped wholesale."""
    n_obs = int(offset[-1])
    parent = np.arange(n_obs, dtype=np.int64)

    def find(i: int) -> int:
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:       # path compression
            parent[i], i = root, parent[i]
        return root

    matched = np.zeros(n_obs, dtype=bool)
    for fa, fb, m in pair_matches:
        if len(m) == 0:
            continue
        ia = offset[fa] + m[:, 0]
        ib = offset[fb] + m[:, 1]
        matched[ia] = True
        matched[ib] = True
        for a, b in zip(ia, ib):
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[rb] = ra

    roots = np.fromiter((find(i) for i in range(n_obs)), np.int64, n_obs)
    roots = np.where(matched, roots, -1)

    # drop components observing the same frame twice
    frame_of = np.searchsorted(offset, np.arange(n_obs), side="right") - 1
    ok = roots >= 0
    key = roots[ok] * (frame_of.max() + 2) + frame_of[ok]
    _, counts = np.unique(key, return_counts=True)
    if np.any(counts > 1):
        uniq, inv = np.unique(key, return_inverse=True)
        bad_keys = uniq[counts > 1]
        bad_roots = np.unique(bad_keys // (frame_of.max() + 2))
        roots[np.isin(roots, bad_roots)] = -1
        ok = roots >= 0

    uniq_roots, track = np.unique(roots[ok], return_inverse=True)
    track_of = np.full(n_obs, -1, dtype=np.int64)
    track_of[ok] = track
    return Tracks(track_of=track_of, n_tracks=len(uniq_roots))


def triangulate_tracks(obs: Observations, tracks: Tracks,
                       proj: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched DLT over all tracks at once, on proj's device.

    proj: [F, 3, 4] fixed projection matrices K @ [R | T]. Each observation
    contributes rows (x * P2 - P0, y * P2 - P1); the per-track 4x4 normal
    matrices are accumulated with scatter-adds and solved together by one
    batched eigendecomposition (smallest eigenvector = homogeneous point).
    Returns (xyz [M, 3] float64, valid [M] — tracks with >= 2 observations
    and a well-conditioned homogeneous solution)."""
    dev = proj.device
    track_of = torch.as_tensor(tracks.track_of, device=dev)
    sel = track_of >= 0
    t_id = track_of[sel]
    P = proj.to(F64)[torch.as_tensor(obs.frame, device=dev)[sel]]
    xy = torch.as_tensor(obs.xy, device=dev)[sel].to(F64)
    r0 = xy[:, 0:1] * P[:, 2, :] - P[:, 0, :]      # [S, 4]
    r1 = xy[:, 1:2] * P[:, 2, :] - P[:, 1, :]
    # accumulate A^T A per track
    M = tracks.n_tracks
    ata = torch.zeros((M, 4, 4), dtype=F64, device=dev)
    ata.index_add_(0, t_id, r0[:, :, None] * r0[:, None, :])
    ata.index_add_(0, t_id, r1[:, :, None] * r1[:, None, :])
    n_obs_per = torch.bincount(t_id, minlength=M)

    # normalize rows for conditioning, then batched symmetric eigensolve
    d = torch.diagonal(ata, dim1=1, dim2=2)
    scale = torch.clamp(torch.sqrt(d[:, 0] + d[:, 1] + d[:, 2] + d[:, 3]),
                        min=1e-12)
    _, v = torch.linalg.eigh(ata / scale[:, None, None])
    h = v[:, :, 0]                                 # smallest eigenvector
    valid = (torch.abs(h[:, 3]) > 1e-10) & (n_obs_per >= 2)
    xyz = h[:, :3] / torch.where(valid, h[:, 3], 1.0)[:, None]
    return xyz, valid


def filter_tracks(xyz: torch.Tensor, valid: torch.Tensor, obs: Observations,
                  tracks: Tracks, proj: torch.Tensor,
                  R: torch.Tensor, T: torch.Tensor,
                  max_reproj_err: float = 4.0,
                  min_tri_angle_deg: float = 0.5) -> torch.Tensor:
    """COLMAP-flag-equivalent filters (scripts/colmap.py:170-180):
    max reprojection error over the track's observations, cheirality
    (positive depth in every view), and minimum triangulation angle
    (max angular spread of the viewing rays, measured against the first
    ray of each track). Returns a keep mask over tracks, on xyz's
    device."""
    dev = xyz.device
    track_of = torch.as_tensor(tracks.track_of, device=dev)
    sel = track_of >= 0
    t_id = track_of[sel]
    frames = torch.as_tensor(obs.frame, device=dev)[sel]
    xy = torch.as_tensor(obs.xy, device=dev)[sel].to(F64)
    M = tracks.n_tracks
    R = torch.as_tensor(R, dtype=F64, device=dev)
    T = torch.as_tensor(T, dtype=F64, device=dev)

    X = xyz.to(F64)[t_id]                          # [S, 3]
    Ph = proj.to(dev, F64)[frames]                 # [S, 3, 4]
    Xh = torch.cat([X, torch.ones((len(X), 1), dtype=F64, device=dev)],
                   dim=1)
    uvw = (Ph @ Xh[:, :, None])[:, :, 0]
    depth_ok = uvw[:, 2] > 1e-9
    uv = uvw[:, :2] / torch.where(depth_ok, uvw[:, 2], 1.0)[:, None]
    err = torch.linalg.norm(uv - xy, dim=1)

    max_err = torch.zeros(M, dtype=F64, device=dev)
    max_err.scatter_reduce_(0, t_id, torch.where(depth_ok, err, torch.inf),
                            "amax", include_self=True)

    # camera-to-point unit rays in world coordinates
    centers = -(R.transpose(1, 2) @ T[:, :, None])[:, :, 0]     # [F, 3]
    rays = X - centers[frames]
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=1, keepdim=True),
                              min=1e-12)
    # angular spread proxy: max angle to the track's FIRST observed ray
    first_ray = torch.zeros((M, 3), dtype=F64, device=dev)
    seen = torch.zeros(M, dtype=torch.bool, device=dev)
    to, order = torch.sort(t_id, stable=True)
    ro = rays[order]
    firsts = torch.ones(len(to), dtype=torch.bool, device=dev)
    firsts[1:] = to[1:] != to[:-1]
    first_ray[to[firsts]] = ro[firsts]
    seen[to[firsts]] = True
    cosang = (rays * first_ray[t_id]).sum(1)
    min_cos = torch.ones(M, dtype=F64, device=dev)
    min_cos.scatter_reduce_(0, t_id, cosang, "amin", include_self=True)
    tri_angle = torch.rad2deg(torch.arccos(torch.clamp(min_cos, -1.0, 1.0)))

    cheir_ok = torch.ones(M, dtype=torch.uint8, device=dev)
    cheir_ok.scatter_reduce_(0, t_id, depth_ok.to(torch.uint8), "amin",
                             include_self=True)
    return (valid.to(dev) & seen & cheir_ok.bool()
            & (max_err <= max_reproj_err)
            & (tri_angle >= min_tri_angle_deg))


def sequential_pairs(frames: Sequence[int], cam_of: Sequence[int],
                     window: int = 0) -> list[tuple[int, int]]:
    """Frame pairs to match. window=0 -> exhaustive (the reference's
    exhaustive_matcher); window>0 -> same-camera temporal neighbours within
    `window` plus all cross-camera pairs at equal time step (cheaper on
    long sequences, same track topology for forward-moving rigs)."""
    n = len(frames)
    if window <= 0:
        return [(i, j) for i in range(n) for j in range(i + 1, n)]
    pairs = []
    step_of = {}
    for i in range(n):
        step_of.setdefault(cam_of[i], []).append(i)
    for cam_frames in step_of.values():
        for a in range(len(cam_frames)):
            for b in range(a + 1, min(a + 1 + window, len(cam_frames))):
                pairs.append((cam_frames[a], cam_frames[b]))
    # cross-camera, same temporal step
    by_step: dict = {}
    for i in range(n):
        by_step.setdefault(frames[i], []).append(i)
    for group in by_step.values():
        for a in range(len(group)):
            for b in range(a + 1, len(group)):
                pairs.append((group[a], group[b]))
    return sorted(set(pairs))


def triangulate_known_poses(images: Sequence[np.ndarray],
                            masks: Sequence[Optional[np.ndarray]],
                            K: np.ndarray, R: np.ndarray, T: np.ndarray,
                            frame_steps: Optional[Sequence[int]] = None,
                            cam_of: Optional[Sequence[int]] = None,
                            window: int = 0,
                            max_features: int = 8192,
                            ratio: float = 0.8,
                            max_reproj_err: float = 4.0,
                            min_tri_angle_deg: float = 0.5,
                            verbose: bool = False, device=None):
    """Full pipeline: SIFT (host) -> match (device) -> tracks (host) ->
    DLT -> filters (device); `device` is the card unless given.

    K: [F, 3, 3] or [3, 3]; R/T: [F, 3, 3] / [F, 3] world-to-camera.
    Returns numpy (xyz [M, 3], rgb [M, 3] uint8) of surviving tracks."""
    dev = resolve_device(device)
    F = len(images)
    K = np.asarray(K, np.float64)
    K = np.broadcast_to(K, (F, 3, 3)) if K.ndim != 3 else K
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64)
    proj = K @ np.concatenate([R, T[:, :, None]], axis=2)     # [F, 3, 4]

    feats, descs, colors = [], [], []
    for img, m in zip(images, masks):
        xy, d = detect_features(img, m, max_features=max_features)
        feats.append(xy)
        descs.append(torch.as_tensor(d, device=dev))
        if img.ndim == 3:
            ix = np.clip(xy.astype(int), 0, [img.shape[1] - 1,
                                             img.shape[0] - 1])
            colors.append(img[ix[:, 1], ix[:, 0]])
        else:
            colors.append(np.full((len(xy), 3), 128, np.uint8))
    offset = np.concatenate([[0], np.cumsum([len(f) for f in feats])])
    obs = Observations(
        xy=torch.as_tensor(np.concatenate(feats) if feats
                           else np.zeros((0, 2), np.float32), device=dev),
        frame=torch.as_tensor(np.repeat(np.arange(F), [len(f) for f in feats]),
                              device=dev),
        offset=offset.astype(np.int64),
        color=np.concatenate(colors) if colors else np.zeros((0, 3), np.uint8))

    steps = list(frame_steps) if frame_steps is not None else list(range(F))
    cams = list(cam_of) if cam_of is not None else [0] * F
    pairs = sequential_pairs(steps, cams, window=window)
    pair_matches = []
    for a, b in pairs:
        m = match_descriptors(descs[a], descs[b], ratio=ratio).cpu().numpy()
        if len(m):
            pair_matches.append((a, b, m))
    if verbose:
        n_m = sum(len(m) for _, _, m in pair_matches)
        print(f"[triangulate] {F} frames, {offset[-1]} keypoints, "
              f"{len(pairs)} pairs, {n_m} matches")

    tracks = build_tracks(obs.offset, pair_matches)
    if tracks.n_tracks == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
    proj_t = torch.as_tensor(proj, device=dev)
    xyz, valid = triangulate_tracks(obs, tracks, proj_t)
    keep = filter_tracks(xyz, valid, obs, tracks, proj_t, R, T,
                         max_reproj_err=max_reproj_err,
                         min_tri_angle_deg=min_tri_angle_deg)
    xyz, keep = xyz.cpu().numpy(), keep.cpu().numpy()
    if verbose:
        print(f"[triangulate] {tracks.n_tracks} tracks -> "
              f"{int(keep.sum())} kept")

    # track color: first observation's pixel color
    sel = tracks.track_of >= 0
    t_id = tracks.track_of[sel]
    order = np.argsort(t_id, kind="stable")
    firsts = np.concatenate([[True], t_id[order][1:] != t_id[order][:-1]])
    rgb = np.zeros((tracks.n_tracks, 3), np.uint8)
    rgb[t_id[order][firsts]] = obs.color[sel][order][firsts]
    return xyz[keep], rgb[keep]
