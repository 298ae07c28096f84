"""Monocular depth pseudo-label driver, Depth-Anything-V2 (the port's
counterpart of scripts/generate_depth.py, the reference's
scripts/run-dpt.py).

    python -m adgs_tpu_torch.scripts.generate_depth --img-path <dir|file|list>
        [--outdir D] [--encoder vitl] [--checkpoints DIR] [--device cpu]

Writes, for each image, the contract that the readers consume and
`validate_scene` checks:

    <outdir>/<image-stem>.npy      float (H, W, 1) inverse depth,
                                   min-max normalized to [0, 1]

The network is an external checkpoint (the reference runs it in a separate
environment too); this driver carries the surrounding pipeline (image
enumeration, normalization, output naming) and imports
`depth_anything_v2` for inference. Without the package or the checkpoint
it exits with the contract, so that labels made elsewhere can be dropped
in. The model runs on the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from .._device import resolve_device

CONTRACT = (
    "depth contract: one float .npy per image at <outdir>/<stem>.npy with "
    "shape (H, W, 1), inverse depth min-max normalized to [0, 1] "
    "(reference scripts/run-dpt.py:58-60). Any monocular depth model may "
    "produce these; training consumes them via the scale/shift-aligned "
    "depth loss (train/losses.py)."
)

MODEL_CONFIGS = {
    "vits": dict(encoder="vits", features=64,
                 out_channels=[48, 96, 192, 384]),
    "vitb": dict(encoder="vitb", features=128,
                 out_channels=[96, 192, 384, 768]),
    "vitl": dict(encoder="vitl", features=256,
                 out_channels=[256, 512, 1024, 1024]),
    "vitg": dict(encoder="vitg", features=384,
                 out_channels=[1536, 1536, 1536, 1536]),
}


def load_model(encoder: str, checkpoint_dir: str, device):
    """Import and construct Depth-Anything-V2 on `device`, or exit with the
    contract."""
    try:
        import torch
        from depth_anything_v2.dpt import DepthAnythingV2
    except ImportError as e:
        sys.exit(
            f"[generate_depth] external dependency missing ({e}).\n"
            "Install Depth-Anything-V2 (github.com/DepthAnything/"
            "Depth-Anything-V2) and place the checkpoint at "
            f"{checkpoint_dir}/depth_anything_v2_{encoder}.pth, or generate "
            f"the labels with any other tool.\n{CONTRACT}")
    ckpt = os.path.join(checkpoint_dir, f"depth_anything_v2_{encoder}.pth")
    if not os.path.exists(ckpt):
        sys.exit(f"[generate_depth] checkpoint not found: {ckpt}\n{CONTRACT}")
    model = DepthAnythingV2(**MODEL_CONFIGS[encoder])
    model.load_state_dict(torch.load(ckpt, map_location="cpu"))
    return model.to(device).eval()


def list_images(img_path: str):
    if os.path.isfile(img_path):
        if img_path.endswith("txt"):
            with open(img_path) as f:
                return f.read().splitlines()
        return [img_path]
    return sorted(glob.glob(os.path.join(img_path, "**/*"), recursive=True))


def main(argv=None):
    p = argparse.ArgumentParser(description="Depth Anything V2 driver")
    p.add_argument("--img-path", type=str, required=True)
    p.add_argument("--input-size", type=int, default=518)
    p.add_argument("--outdir", type=str, default="./vis_depth")
    p.add_argument("--encoder", type=str, default="vitl",
                   choices=list(MODEL_CONFIGS))
    p.add_argument("--checkpoints", type=str, default="checkpoints")
    p.add_argument("--device", default=None,
                   help="the card unless given (e.g. cpu)")
    args = p.parse_args(argv)

    model = load_model(args.encoder, args.checkpoints,
                       resolve_device(args.device))
    try:
        import cv2
        imread = cv2.imread
    except ImportError:
        from PIL import Image
        imread = lambda f: np.asarray(Image.open(f))[..., ::-1]  # noqa: E731

    files = [f for f in list_images(args.img_path)
             if os.path.splitext(f)[1].lower() in
             (".png", ".jpg", ".jpeg", ".bmp")]
    os.makedirs(args.outdir, exist_ok=True)
    for k, filename in enumerate(files):
        print(f"Progress {k + 1}/{len(files)}: {filename}")
        raw = imread(filename)
        depth = model.infer_image(raw, args.input_size)
        depth = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-12)
        stem = os.path.basename(filename).split(".")[0]
        np.save(os.path.join(args.outdir, stem + ".npy"),
                depth[..., None].astype(np.float32))


if __name__ == "__main__":
    main()
