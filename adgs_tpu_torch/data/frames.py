"""Frame loading: FrameInfo -> (Camera, FrameBatch) tensors on a device
(counterpart of adgs_tpu/data/frames.py).

Parity with loadCam (utils/camera_utils.py:22-88): resolution divisors
1/2/4/8 or -1 (auto-rescale >1.6K wide), PIL bilinear image resize, bilinear
depth/sky resize (sky re-thresholded at 0.5), nearest-neighbor semantic
resize via linspace index sampling, and the flow package list passed through
at native resolution. `device=None` means the card.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image

from .._device import resolve_device
from ..profiling import copied_in
from ..core.camera import Camera
from ..ops.flow import FlowPackage
from ..train.losses import FrameBatch
from .readers import FrameInfo


def _resolve_resolution(orig_w: int, orig_h: int, resolution: int,
                        resolution_scale: float = 1.0):
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def _bilinear_resize(a: np.ndarray, w: int, h: int) -> np.ndarray:
    img = Image.fromarray(a.astype(np.float32), mode="F")
    return np.asarray(img.resize((w, h), Image.BILINEAR))


def load_frame(info: FrameInfo, resolution: int = 1,
               resolution_scale: float = 1.0, device=None):
    """Returns (Camera, FrameBatch-without-flow, flow package list)."""
    dev = resolve_device(device)
    img = Image.open(info.image_path)
    w, h = _resolve_resolution(img.size[0], img.size[1], resolution,
                               resolution_scale)
    rgb = np.asarray(img.resize((w, h)), dtype=np.float32) / 255.0
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, -1)
    rgb = np.clip(rgb[..., :3].transpose(2, 0, 1), 0.0, 1.0)

    depth = np.zeros((h, w), np.float32)
    if info.depth is not None:
        depth = _bilinear_resize(info.depth, w, h)
    sky = np.zeros((h, w), np.float32)
    if info.sky is not None:
        sky = (_bilinear_resize(info.sky.astype(np.float32), w, h)
               > 0.5).astype(np.float32)
    semantic = np.zeros((h, w), np.float32)
    if info.semantic is not None:
        s = info.semantic
        iy = np.linspace(0, s.shape[0] - 1, h).astype(np.int32)
        ix = np.linspace(0, s.shape[1] - 1, w).astype(np.int32)
        semantic = s[iy[:, None], ix].astype(np.float32)

    cam = Camera.create(R=info.R, T=info.T, fovx=info.fovx, fovy=info.fovy,
                        width=w, height=h, time=info.time, device=dev)

    def t(a):
        x = torch.as_tensor(np.array(a, np.float32, order="C"), device=dev)
        copied_in(x)
        return x

    batch = FrameBatch(image=t(rgb), depth=t(depth), sky=t(sky),
                       semantic=t(semantic))
    return cam, batch, info.flow


def flow_package(raw: list, device=None) -> FlowPackage:
    """Convert one reference flow entry [time, K, R, T, flow(2HW), vis(HW)]
    to float32 tensors."""
    dev = resolve_device(device)
    t, K, R, T, flow, vis = raw

    def f32(a):
        x = torch.as_tensor(np.asarray(a, np.float32), device=dev)
        copied_in(x)
        return x

    return FlowPackage(time=f32(np.float32(t)), K=f32(K), R=f32(R),
                       T=f32(np.asarray(T).reshape(-1)), flow=f32(flow),
                       vis=f32(vis))
