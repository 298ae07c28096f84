"""Long-range optical-flow pseudo-label driver, CoTracker3 (the port's
counterpart of scripts/generate_flow.py, the reference's scripts/flow.py).

    python -m adgs_tpu_torch.scripts.generate_flow <scene> [--device cpu]
        [--downsample 1] [--step 4] [--split_mode nvs-75]

Writes the contract that the readers (data/frames.py) consume and
`validate_scene` checks:

    <path>/flow[/<split>]/NNNNNN.npz   key 'flow': list of packages
        [time, K (3,3), R (3,3), T (3,), flow (2,H,W), vis (H,W)]

NNNNNN is the global image index. Each TRAIN image gets up to two
packages: a forward one tracking its object pixels `step` train frames
ahead and a backward one `step` frames back; `flow[y, x]` holds the
tracked pixel position of source pixel (x, y) at the package's target
time (positions, not deltas: untracked pixels keep their own coords) and
`vis` the tracker's visibility. KITTI writes under `flow/<split_mode>/`,
Waymo and nuScenes under `flow/`.

The point tracker is an external checkpoint (the reference runs it in a
separate environment too); this driver carries the pipeline (split
selection, mask-pixel query construction, batched tracking, dense
scatter, per-frame packaging) and loads CoTracker3 through torch.hub's
local cache. Without it, it exits with the contract, so that labels made
elsewhere can be dropped in. The tracking runs on the card unless
--device says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .._device import resolve_device
from ..data.readers import get_val_frames

CONTRACT = (
    "flow contract: <path>/flow[/<split>]/NNNNNN.npz with key 'flow' = "
    "list of [time, K(3,3), R(3,3), T(3), flow(2,H,W), vis(H,W)] packages "
    "per TRAIN image (reference scripts/flow.py:484,622,749); flow holds "
    "tracked absolute pixel positions at the target frame's time. Any "
    "long-range tracker may produce these; training consumes them via the "
    "projected flow loss (train/losses.py, ops/flow.py)."
)


def load_cotracker(device):
    try:
        import torch
        model = torch.hub.load("facebookresearch/co-tracker",
                               "cotracker3_offline")
    except Exception as e:  # ImportError, an absent hub cache, ...
        sys.exit(
            f"[generate_flow] CoTracker3 unavailable ({e}).\n"
            "Install via torch.hub (facebookresearch/co-tracker, "
            "cotracker3_offline) with network access or a local hub cache, "
            f"or generate the labels with any other tracker.\n{CONTRACT}")
    return model.to(device).eval()


def batchify(model, video, queries, batch_size=2 ** 15):
    """Track `queries` [(0, x, y)] through `video` [T,3,H,W] in chunks.

    Returns final-frame positions [N,2] and visibility [N] (the reference
    batches identically, scripts/flow.py:379-390)."""
    import torch
    tracks, vis = [], []
    with torch.no_grad():
        for q in torch.split(queries, batch_size, dim=0):
            t, v = model(video[None], queries=q[None])[:2]
            tracks.append(t[0, -1])
            vis.append(v[0, -1])
    return torch.cat(tracks, dim=0), torch.cat(vis, dim=0).reshape(-1)


def load_scene(path: str, split_mode: str):
    """-> (img_list, train_indices, K[per-img 3x3], R, T, times, num_cams,
    flow_dir). Recognizes the three layouts by their sentinel files, as
    data/readers.py does."""
    img_list = sorted(os.listdir(os.path.join(path, "image")))
    if os.path.exists(os.path.join(path, "cameras.npz")):      # Waymo
        m = np.load(os.path.join(path, "cameras.npz"), allow_pickle=True)
        K4, R, T, times = m["K"], m["R"], m["T"], m["time_stamps"]
        keep = [i for i in range(len(img_list)) if not m["is_val_list"][i]]
        K = np.array([[[k[0], 0, k[2]], [0, k[1], k[3]], [0, 0, 1]]
                      for k in K4], np.float32)
        return img_list, keep, K, R, T, times, 1, os.path.join(path, "flow")
    if os.path.exists(os.path.join(path, "poses.npz")):        # KITTI
        m = np.load(os.path.join(path, "poses.npz"), allow_pickle=True)
        R, T, times = m["R"], m["T"], m["time_stamp"]
        H, W, focal = int(m["height"]), int(m["width"]), float(m["focal"])
        K1 = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                      np.float32)
        num_cams = 2
        nf = times.shape[0] // num_cams
        if split_mode == "nvs-25":
            i_test = set(get_val_frames(nf, train_every=4))
        elif split_mode == "nvs-50":
            i_test = set(get_val_frames(nf, test_every=2))
        elif split_mode == "nvs-75":
            i_test = set(get_val_frames(nf, test_every=4))
        else:
            raise ValueError("No such split method: " + split_mode)
        keep = [i for i in range(len(img_list)) if i // num_cams
                not in i_test]
        K = np.repeat(K1[None], len(img_list), axis=0)
        return (img_list, keep, K, R, T, times, num_cams,
                os.path.join(path, "flow", split_mode))
    if os.path.exists(os.path.join(path, "meta.npz")):         # nuScenes
        # full 3x3 intrinsics, as convert_nuscenes writes them and the
        # reader takes them (the JAX driver reads them as [fx, fy, cx, cy]
        # and fails on that layout)
        m = np.load(os.path.join(path, "meta.npz"), allow_pickle=True)
        K3, R, T, times = m["K"], m["R"], m["T"], m["time_stamps"]
        keep = [i for i in range(len(img_list)) if not m["is_val_list"][i]]
        K = np.asarray(K3, np.float32)
        return img_list, keep, K, R, T, times, 3, os.path.join(path, "flow")
    sys.exit("Could not recognize scene type (no cameras.npz / poses.npz / "
             "meta.npz): " + path)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path")
    p.add_argument("--device", default=None,
                   help="the card unless given (e.g. cpu)")
    p.add_argument("--downsample", default=1, type=int)
    p.add_argument("--step", default=4, type=int,
                   help="slide window (train frames) per track")
    p.add_argument("--split_mode", default="nvs-75")
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    dev = resolve_device(args.device)
    img_list, keep, K, R, T, times, num_cams, flow_dir = load_scene(
        args.path, args.split_mode)
    model = load_cotracker(dev)
    os.makedirs(flow_dir, exist_ok=True)

    # load train images + object masks
    images, masks = [], []
    for i in keep:
        stem = img_list[i].split(".")[0]
        img = np.asarray(Image.open(
            os.path.join(args.path, "image", img_list[i])))
        mask = np.load(os.path.join(args.path, "semantic",
                                    f"mask_{stem}.npy")) > 0
        images.append(img)
        masks.append(mask.astype(np.float32))
    K, R, T, times = K[keep], R[keep], T[keep], times[keep]
    video = torch.tensor(np.stack(images), dtype=torch.float32,
                         device=dev).permute(0, 3, 1, 2)
    masks_t = torch.tensor(np.stack(masks), device=dev)
    if args.downsample > 1:
        import torch.nn.functional as F
        h, w = video.shape[2] // args.downsample, \
            video.shape[3] // args.downsample
        video = F.interpolate(video, size=(h, w), mode="bilinear")
        masks_t = F.interpolate(masks_t[:, None], size=(h, w),
                                mode="bilinear")[:, 0]
        K = K.copy()
        K[:, :2] *= 1.0 / args.downsample
    H, W = video.shape[2], video.shape[3]
    grid = torch.stack(torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=dev),
        torch.arange(H, dtype=torch.float32, device=dev),
        indexing="xy"), dim=-1)                                 # [H, W, 2]

    win = np.arange(args.step + 1, dtype=np.int64) * num_cams
    n = video.shape[0]
    for idx in range(n):
        coords = torch.nonzero(masks_t[idx] > 0.5, as_tuple=True)
        pts = grid[coords]
        if pts.numel() == 0:
            print(f"[WARNING] Image {keep[idx]} has no object detected.")
            continue
        queries = torch.cat([torch.zeros((pts.shape[0], 1), device=dev),
                             pts], dim=-1)
        pkgs = []
        for sign in (+1, -1):
            tgt = idx + sign * args.step * num_cams
            if not (0 <= tgt < n):
                continue
            clip = video[idx + sign * win] if sign > 0 else \
                video[idx - win]
            tracked, vis_pts = batchify(model, clip, queries)
            flow = grid.clone()
            vis = torch.zeros((H, W), device=dev)
            flow[coords] = tracked
            vis[coords] = vis_pts.float()
            pkgs.append([times[tgt], K[tgt].astype(np.float32), R[tgt],
                         T[tgt],
                         flow.permute(2, 0, 1).cpu().numpy(),
                         vis.cpu().numpy()])
        np.savez(os.path.join(flow_dir, f"{keep[idx]:06d}.npz"),
                 flow=np.asarray(pkgs, dtype=object))
        print(f"[{idx + 1}/{n}] {len(pkgs)} packages")


if __name__ == "__main__":
    main()
