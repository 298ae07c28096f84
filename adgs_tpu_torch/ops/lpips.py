"""LPIPS perceptual metric, eval only (counterpart of adgs_tpu/ops/lpips.py).

Scaling-layer normalization, VGG16 or AlexNet feature trunk, unit-normalized
channel activations, 1x1 linear heads, spatial mean, sum over stages. The
convolutions are plain F.conv2d in full float32 (the TF32 guard of
_device.py is on): the JAX package computes them outside any Pallas
kernel.

No weights are fetched. They come from an .npz export (the repo's
`weights/lpips_{net}.npz`, or ADGS_LPIPS_WEIGHTS) or from the reference's
own torch checkpoints in a local torch hub cache; `lpips_fn` returns None
when there are none, and results.json then omits LPIPS.
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device

# ImageNet scaling layer (lpipsPyTorch/modules/networks.py ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 conv architecture: (out_channels, n_convs) per stage
_VGG_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
# AlexNet features: (out_ch, kernel, stride, pad)
_ALEX_LAYERS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
                (256, 3, 1, 1), (256, 3, 1, 1)]
_N_CONVS = {"vgg": 13, "alex": 5}


def _vgg_features(params: dict, x: torch.Tensor) -> list:
    feats = []
    i = 0
    for stage, (_, n_convs) in enumerate(_VGG_STAGES):
        for _ in range(n_convs):
            x = torch.relu(F.conv2d(x, params[f"conv{i}_w"],
                                    params[f"conv{i}_b"], padding=1))
            i += 1
        feats.append(x)
        if stage < len(_VGG_STAGES) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def _alex_features(params: dict, x: torch.Tensor) -> list:
    feats = []
    for i, (_, k, s, p) in enumerate(_ALEX_LAYERS):
        x = torch.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                                stride=s, padding=p))
        feats.append(x)
        if i in (0, 1):
            x = F.max_pool2d(x, 3, 2)
    return feats


def _normalize_activation(x: torch.Tensor, eps: float = 1e-10):
    n = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
    return x / (n + eps)


def lpips_from_params(params: dict, net_type: str, x: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """x, y: [3,H,W] or [B,3,H,W] in [0,1]; params: {name: tensor} on the
    images' device. Returns a 0-d tensor."""
    if x.dim() == 3:
        x = x[None]
        y = y[None]
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    # [0,1] -> [-1,1] -> scaling layer
    xs = ((2 * x - 1) - shift) / scale
    ys = ((2 * y - 1) - shift) / scale
    trunk = _vgg_features if net_type == "vgg" else _alex_features
    fx = trunk(params, xs)
    fy = trunk(params, ys)
    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        d = (_normalize_activation(a) - _normalize_activation(b)) ** 2
        lin = params[f"lin{i}_w"]  # [1, C, 1, 1]
        total = total + torch.mean(torch.sum(d * lin, dim=1), dim=(-2, -1))
    return torch.mean(total)


def load_weights(path: str) -> dict[str, np.ndarray]:
    z = np.load(path)
    return {k: np.asarray(z[k], np.float32) for k in z.files}


def load_weights_torch(trunk_path: str, heads_path: str,
                       net_type: str) -> dict[str, np.ndarray]:
    """The reference's own weight files: a torchvision trunk state dict
    (keys `features.{i}.weight/.bias` or bare `{i}.weight/.bias`) and the
    richzhang linear heads (keys `lin{i}.model.1.weight` or
    `{i}.1.weight`). torch.load only; no torchvision."""
    def _f32(t):
        return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)

    trunk = torch.load(trunk_path, map_location="cpu", weights_only=True)
    convs = {}
    for k, v in trunk.items():
        digits = [p for p in k.split(".") if p.isdigit()]
        if not digits or v.ndim == 0:
            continue
        idx = int(digits[0])
        if k.endswith(".weight") and v.ndim == 4:
            convs.setdefault(idx, {})["w"] = _f32(v)
        elif k.endswith(".bias") and v.ndim == 1:
            convs.setdefault(idx, {})["b"] = _f32(v)
    conv_idx = sorted(i for i, d in convs.items() if "w" in d and "b" in d)
    n = _N_CONVS[net_type]
    # a full-model checkpoint also carries classifier linears (2-D), which
    # the 4-D filter drops; the first n conv layers are the trunk
    conv_idx = conv_idx[:n]
    if len(conv_idx) != n:
        raise ValueError(
            f"{trunk_path}: found {len(conv_idx)} conv layers, "
            f"expected {n} for net_type={net_type!r}")
    params = {}
    for j, i in enumerate(conv_idx):
        params[f"conv{j}_w"] = convs[i]["w"]
        params[f"conv{j}_b"] = convs[i]["b"]

    heads = torch.load(heads_path, map_location="cpu", weights_only=True)
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"{i}.1.weight"):
            if key in heads:
                params[f"lin{i}_w"] = _f32(heads[key])
                break
        else:
            raise ValueError(f"{heads_path}: missing linear head {i} "
                             f"(keys: {sorted(heads)[:4]}...)")
    return params


def _find_torch_weights(net_type: str) -> Optional[tuple]:
    """(trunk, heads) torch checkpoints: the environment's paths first,
    then the local torch hub cache the reference fills when it runs."""
    trunk = os.environ.get("ADGS_LPIPS_TORCH_TRUNK")
    heads = os.environ.get("ADGS_LPIPS_TORCH_HEADS")
    if trunk and heads and os.path.exists(trunk) and os.path.exists(heads):
        return trunk, heads
    hub = os.environ.get("TORCH_HOME", os.path.expanduser("~/.cache/torch"))
    ckpt_dir = os.path.join(hub, "hub", "checkpoints")
    pattern = "vgg16-*.pth" if net_type == "vgg" else "alexnet-*.pth"
    trunks = sorted(glob.glob(os.path.join(ckpt_dir, pattern)))
    heads_p = os.path.join(ckpt_dir, f"{net_type}.pth")
    if trunks and os.path.exists(heads_p):
        return trunks[0], heads_p
    return None


def lpips_fn(net_type: str = "vgg", weights_path: Optional[str] = None,
             device=None) -> Optional[Callable]:
    """lpips(x, y) -> 0-d tensor with the weights on `device` (the card
    unless given), or None when no weights are found: the given or
    ADGS_LPIPS_WEIGHTS npz (default weights/lpips_{net}.npz), then the
    reference's torch checkpoints in the local hub cache."""
    path = weights_path or os.environ.get(
        "ADGS_LPIPS_WEIGHTS", f"weights/lpips_{net_type}.npz")
    if os.path.exists(path):
        arrays = load_weights(path)
    else:
        found = _find_torch_weights(net_type)
        if found is None:
            return None
        try:
            arrays = load_weights_torch(found[0], found[1], net_type)
        except Exception as e:  # malformed file: a loud skip
            print(f"[adgs_tpu_torch] LPIPS({net_type}) torch weights at "
                  f"{found[0]} unusable: {e}", file=sys.stderr)
            return None
    dev = resolve_device(device)
    params = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}

    @torch.no_grad()
    def fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return lpips_from_params(params, net_type, x, y)

    return fn
