"""Model-agnostic pseudo-label packagers: point tracks -> flow packages,
plus mask / depth importers with the reference file layout (counterpart of
adgs_tpu/geometry/pseudo_labels.py; the grids are built on a torch
device, the files written are the same).

The reference ships three neural generators whose OUTPUT PACKAGING (not the
nets) defines the training data contract:

  - flow: CoTracker3 sliding-window tracks are scattered back into
    image-shaped flow/vis grids and saved per SOURCE image as
    ``flow/{idx:06d}.npz`` holding ``flow = [entry, ...]`` with
    ``entry = [time, K(3,3), R(3,3), T(3,), flow(2,H,W), vis(H,W)]``
    — forward (source -> idx + window*num_cams) and/or backward
    (source -> idx - window*num_cams). Static pixels keep their own
    coordinates with vis 0; tracked (dynamic-mask) pixels carry the
    ABSOLUTE target-frame (x, y) and the tracker's visibility
    (reference /root/reference/scripts/flow.py:392-484 waymo,
    :525-624 kitti, :663-752 nuscenes — all three share this shape).
  - semantic: per-frame int32 instance-id maps ``semantic/mask_{stem}.npy``
    (Grounded-SAM-2, scripts/semantic.py; ids consistent across frames,
    0 = background). Sky masks: ``sky/mask_{stem}.npy`` nonzero = sky.
  - depth: per-frame [H, W, 1] float maps normalized to [0, 1]
    ``depth/{stem}.npy`` (Depth-Anything-V2, scripts/run-dpt.py:53-60 —
    min-max normalized AFFINE-INVARIANT depth; the σ-loss fits scale+shift
    per frame, so any monocular net's output works).

`queries_from_mask` and `tracks_to_flow` run on their inputs' device; the
rest is host numpy. Where two queries round to the same pixel the LATER
one wins, as numpy's fancy assignment keeps it, through an explicit
per-pixel argmax of the query index (a CUDA `index_put_` leaves the
winner undefined). Plug in ANY tracker / segmenter / depth net
by writing its raw output in the neutral track format below (or calling
these functions in-process) and the packagers produce training-ready
scenes. The raw track interchange format, per source image:

    tracks/{idx:06d}.npz
        query:   [Np, 2] float32 (x, y) source-pixel coords
        fwd:     [Np, 2] float32 tracked coords in the forward target
        fwd_vis: [Np]    float32/bool visibility   (optional pair)
        bwd:     [Np, 2] / bwd_vis: [Np]           (optional pair)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..data.lidar import last_writer

# ---------------------------------------------------------------------------
# core geometry (the model-agnostic heart of scripts/flow.py:379-484)
# ---------------------------------------------------------------------------

def queries_from_mask(mask: torch.Tensor, threshold: float = 0.5
                      ) -> torch.Tensor:
    """[H, W] dynamic-object mask -> [Np, 2] float32 (x, y) query pixel
    coords, row-major as np.nonzero.

    The reference queries the tracker at every mask>0.5 pixel
    (flow.py:436-438 ``nonzero(masks[idx] > 0.5)`` on the float mask)."""
    ys, xs = torch.nonzero(mask.to(torch.float32) > threshold,
                           as_tuple=True)
    return torch.stack([xs, ys], dim=-1).to(torch.float32)


def tracks_to_flow(height: int, width: int, query_xy: torch.Tensor,
                   tracked_xy: torch.Tensor, tracked_vis: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter tracked endpoints into image grids (flow.py:443-452), on
    the queries' device.

    Returns (flow [2, H, W] f32, vis [H, W] f32): identity coordinates
    with vis 0 everywhere except the query pixels, which carry the
    ABSOLUTE tracked (x, y) and the tracker's visibility."""
    dev = query_xy.device
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                         device=dev),
                            torch.arange(width, dtype=torch.float32,
                                         device=dev), indexing="ij")
    flow = torch.stack([gx, gy], dim=0).reshape(2, -1)   # [2, H * W]
    vis = torch.zeros(height * width, dtype=torch.float32, device=dev)
    if query_xy.numel():
        qx = torch.round(query_xy[:, 0]).long()
        qy = torch.round(query_xy[:, 1]).long()
        keep = (qx >= 0) & (qx < width) & (qy >= 0) & (qy < height)
        win = last_writer(qy[keep] * width + qx[keep], height * width)
        hit = win >= 0
        src = win[hit]
        tracked = tracked_xy.to(dev)[keep].to(torch.float32)
        flow[0, hit] = tracked[src, 0]
        flow[1, hit] = tracked[src, 1]
        vis[hit] = tracked_vis.to(dev)[keep].to(torch.float32)[src]
    return flow.view(2, height, width), vis.view(height, width)


def flow_entry(time: float, K: np.ndarray, R: np.ndarray, T: np.ndarray,
               flow: np.ndarray, vis: np.ndarray) -> list:
    """One package entry in the reference list layout
    ([time, K, R, T, flow(2HW), vis(HW)], flow.py:459)."""
    K = np.asarray(K, np.float32)
    assert K.shape == (3, 3), f"K must be a 3x3 intrinsic matrix, got {K.shape}"
    return [np.float32(time), K, np.asarray(R, np.float32)[:3, :3],
            np.asarray(T, np.float32)[:3], flow.astype(np.float32),
            vis.astype(np.float32)]


# ---------------------------------------------------------------------------
# scene-level packaging
# ---------------------------------------------------------------------------

def _scene_cameras(path: str):
    """(K [F,3,3], R, T, times, is_val, num_cams, (H, W), dataset) from the
    scene's metadata npz — the same three contracts data/readers.py parses."""
    from ..data.readers import detect_dataset
    dataset = detect_dataset(path)
    if dataset == "kitti":
        meta = np.load(os.path.join(path, "poses.npz"), allow_pickle=True)
        R, T, times = meta["R"], meta["T"], meta["time_stamp"]
        H, W = int(meta["height"]), int(meta["width"])
        focal = float(meta["focal"])
        K1 = np.array([[focal, 0.0, W / 2.0],
                       [0.0, focal, H / 2.0],
                       [0.0, 0.0, 1.0]], np.float32)
        K = np.repeat(K1[None], len(times), axis=0)
        is_val = None  # depends on split_mode; resolved by the caller
        num_cams = 2
    else:
        meta_file = "cameras.npz" if dataset == "waymo" else "meta.npz"
        meta = np.load(os.path.join(path, meta_file), allow_pickle=True)
        R, T, times = meta["R"], meta["T"], meta["time_stamps"]
        Kraw = meta["K"]
        if Kraw.ndim == 2:     # waymo [F, 4] (fx, fy, cx, cy)
            K = np.zeros((len(times), 3, 3), np.float32)
            K[:, 0, 0], K[:, 1, 1] = Kraw[:, 0], Kraw[:, 1]
            K[:, 0, 2], K[:, 1, 2] = Kraw[:, 2], Kraw[:, 3]
            K[:, 2, 2] = 1.0
            H = int(round(float(Kraw[0, 3]) * 2))
            W = int(round(float(Kraw[0, 2]) * 2))
        else:                  # nuscenes [F, 3, 3]
            K = Kraw.astype(np.float32)
            H = int(round(float(K[0, 1, 2]) * 2))
            W = int(round(float(K[0, 0, 2]) * 2))
        is_val = np.asarray(meta["is_val_list"], bool)
        num_cams = 1 if dataset == "waymo" else 3
    return (np.asarray(K, np.float32), np.asarray(R, np.float32),
            np.asarray(T, np.float32), np.asarray(times), is_val,
            num_cams, (H, W), dataset)


def _kitti_is_val(n_frames: int, num_cams: int, split_mode: str):
    from ..data.readers import get_val_frames
    per = n_frames // num_cams
    if split_mode == "nvs-25":
        i_test = set(get_val_frames(per, train_every=4))
    elif split_mode == "nvs-50":
        i_test = set(get_val_frames(per, test_every=2))
    elif split_mode == "nvs-75":
        i_test = set(get_val_frames(per, test_every=4))
    else:
        raise ValueError("no such split: " + split_mode)
    return np.array([i // num_cams in i_test for i in range(n_frames)])


def package_scene_flow(path: str, tracks_dir: Optional[str] = None,
                       tracks: Optional[dict] = None,
                       slide_window: int = 4,
                       split_mode: str = "nvs-75",
                       num_cams: Optional[int] = None,
                       device=None) -> list[str]:
    """Package raw point tracks into training flow packages for a scene
    (the grids built on `device`: the card unless given).

    tracks: {global_frame_idx: {"query": [Np,2], "fwd": [Np,2],
    "fwd_vis": [Np], "bwd": ..., "bwd_vis": ...}} (any of fwd/bwd pairs
    may be absent) — or tracks_dir holding ``{idx:06d}.npz`` in that
    format. Frame indices are GLOBAL (pre-split) like the reference's.

    Window semantics (flow.py:433-483): the tracker was queried from
    TRAIN frame position p (index within the train-filtered ordering) to
    train position p +- slide_window of the SAME camera; targets beyond
    the ends are skipped. Writes ``flow/[{split}/]{idx:06d}.npz`` and
    returns the written paths."""
    dev = resolve_device(device)
    K, R, T, times, is_val, default_cams, (H, W), dataset = \
        _scene_cameras(path)
    num_cams = num_cams or default_cams
    if dataset == "kitti":
        is_val = _kitti_is_val(len(times), num_cams, split_mode)
        flow_dir = os.path.join(path, "flow", split_mode)
    else:
        flow_dir = os.path.join(path, "flow")
    os.makedirs(flow_dir, exist_ok=True)

    # train-filtered ordering: the reference packages against the
    # train-subset index sequence (flow.py:411-413 filters is_val first)
    train_idx = np.nonzero(~is_val)[0]
    pos_of = {int(g): p for p, g in enumerate(train_idx)}
    n_train = len(train_idx)
    step = slide_window * num_cams

    def load_tracks(gidx: int):
        if tracks is not None and gidx in tracks:
            return tracks[gidx]
        if tracks_dir is not None:
            p = os.path.join(tracks_dir, f"{gidx:06d}.npz")
            if os.path.exists(p):
                return dict(np.load(p))
        return None

    def grids(q, xy, vis):
        fl, vi = tracks_to_flow(H, W, q, torch.as_tensor(np.asarray(xy)),
                                torch.as_tensor(np.asarray(vis)))
        return fl.cpu().numpy(), vi.cpu().numpy()

    written = []
    for p, gidx in enumerate(train_idx):
        tr = load_tracks(int(gidx))
        if tr is None or tr.get("query") is None or not len(tr["query"]):
            continue
        q = torch.as_tensor(np.asarray(tr["query"], np.float32), device=dev)
        entries = []
        if p // num_cams < n_train // num_cams - slide_window \
                and "fwd" in tr:
            tgt = int(train_idx[p + step])
            fl, vi = grids(q, tr["fwd"], tr["fwd_vis"])
            entries.append(flow_entry(times[tgt], K[tgt], R[tgt], T[tgt],
                                      fl, vi))
        if p // num_cams >= slide_window and "bwd" in tr:
            tgt = int(train_idx[p - step])
            fl, vi = grids(q, tr["bwd"], tr["bwd_vis"])
            entries.append(flow_entry(times[tgt], K[tgt], R[tgt], T[tgt],
                                      fl, vi))
        if not entries:
            continue
        out = os.path.join(flow_dir, f"{int(gidx):06d}.npz")
        np.savez(out, flow=np.asarray(entries, dtype=object))
        written.append(out)
    return written


# ---------------------------------------------------------------------------
# mask / depth importers (any segmenter / depth net -> reference layout)
# ---------------------------------------------------------------------------

def import_semantic_masks(path: str, masks: dict[str, np.ndarray],
                          kind: str = "semantic") -> list[str]:
    """Write {stem: [H, W] instance-id (or binary) mask} as
    ``{kind}/mask_{stem}.npy`` (scripts/semantic.py layout; int ids,
    0 = background; ids should be temporally consistent — the packager
    validates dtype and non-negativity, consistency is the tracker's
    job). kind="sky" writes the sky-mask layout instead."""
    out_dir = os.path.join(path, kind)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for stem, m in sorted(masks.items()):
        m = np.asarray(m)
        if m.dtype == bool:
            m = m.astype(np.int32)
        assert np.issubdtype(m.dtype, np.integer) or np.issubdtype(
            m.dtype, np.floating), f"mask {stem}: bad dtype {m.dtype}"
        assert m.ndim == 2, f"mask {stem}: expected [H, W], got {m.shape}"
        assert (np.asarray(m) >= 0).all(), f"mask {stem}: negative ids"
        p = os.path.join(out_dir, f"mask_{stem}.npy")
        np.save(p, m.astype(np.int32) if kind == "semantic"
                else (m != 0).astype(np.uint8))
        written.append(p)
    return written


def import_depth_maps(path: str, depths: dict[str, np.ndarray],
                      normalize: bool = True) -> list[str]:
    """Write {stem: [H, W] depth/disparity} as ``depth/{stem}.npy`` in the
    reference convention (run-dpt.py:58-60): [H, W, 1] float32, min-max
    normalized to [0, 1]. The σ-loss is affine-invariant (scale+shift fit
    per frame, ops/depth.py), so any monocular net's raw output works."""
    out_dir = os.path.join(path, "depth")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for stem, d in sorted(depths.items()):
        d = np.asarray(d, np.float32)
        if d.ndim == 3:
            d = d.squeeze(-1)
        assert d.ndim == 2, f"depth {stem}: expected [H, W], got {d.shape}"
        if normalize:
            lo, hi = float(d.min()), float(d.max())
            d = (d - lo) / max(hi - lo, 1e-12)
        np.save(os.path.join(out_dir, f"{stem}.npy"), d[..., None])
        written.append(os.path.join(out_dir, f"{stem}.npy"))
    return written
