"""Image metrics: SSIM (train loss) and PSNR/MSE (eval) (counterpart of
adgs_tpu/ops/image.py).

11x11 Gaussian window, sigma 1.5, per-channel, zero "SAME" padding,
evaluated as two separable 1-D passes of shifted weighted sums (the JAX
package's default `_sep_pass` form), with the five filtered quantities
batched into one pass. Plain PyTorch: the JAX package computes it outside
any Pallas kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _sep_pass(img: torch.Tensor, axis: int, window_size: int) -> torch.Tensor:
    """One 1-D Gaussian pass along `axis` (2 or 3 of [B, C, H, W]) by zero
    padding and static slices."""
    g = _gaussian_1d(window_size)
    half = window_size // 2
    pad = (0, 0, half, half) if axis == 2 else (half, half, 0, 0)
    padded = F.pad(img, pad)
    n = img.shape[axis]
    acc = None
    for k in range(window_size):
        term = float(g[k]) * padded.narrow(axis, k, n)
        acc = term if acc is None else acc + term
    return acc


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map (same shape as the inputs)."""
    if img1.dim() == 3:
        img1 = img1[None]
        img2 = img2[None]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2],
                        dim=1)
    f = _sep_pass(_sep_pass(stacked, 2, window_size), 3, window_size)
    C = img1.shape[1]
    mu1, mu2 = f[:, :C], f[:, C:2 * C]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = f[:, 2 * C:3 * C] - mu1_sq
    sigma2_sq = f[:, 3 * C:4 * C] - mu2_sq
    sigma12 = f[:, 4 * C:5 * C] - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1_mu2 + C1) * (2 * sigma12 + C2))
            / ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over [C,H,W] or [B,C,H,W] images in [0,1]."""
    return torch.mean(ssim_map(img1, img2, window_size))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-image mean over flattened pixels."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(a, b)))
