"""Object / sky mask pseudo-label driver, Grounded-SAM-2 (the port's
counterpart of scripts/generate_semantic.py, the reference's
scripts/semantic.py).

    python -m adgs_tpu_torch.scripts.generate_semantic <scene> [--device cpu]
        [--sam CKPT] [--sam_cfg YAML] [--text PROMPT] [--name semantic]
        [--step 1]

Writes the contract that the readers consume and `validate_scene` checks:

    <path>/<name>/mask_<image-stem>.npy    uint16 (H, W) instance ids
                                           (0 = background)

Run once with the default object prompt to produce `semantic/`, and once
with `--text "sky." --name sky` for the binary sky masks, as the
reference's workflow does.

The segmentation stack (Grounding-DINO and SAM-2's video propagation) is
an external checkpoint (the reference's too); this driver carries the
pipeline (frame enumeration, text-prompted detection every `--step`
frames, mask propagation between detections, id-stable packaging) and
imports `sam2` and HF `transformers` for inference. Without them it exits
with the contract, so that masks made elsewhere can be dropped in. The
models run on the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .._device import resolve_device

CONTRACT = (
    "semantic contract: one uint16 .npy per image at "
    "<path>/<name>/mask_<stem>.npy with shape (H, W); nonzero pixels carry "
    "a per-object instance id stable across frames (reference "
    "scripts/semantic.py:209-216). The object prompt set is "
    "'car.bus.truck.van.human.' (add 'bike.' for nuScenes); sky masks are "
    "the same format produced with --text 'sky.' --name sky. Any "
    "segmentation tool may produce these; training consumes them as the "
    "BCE object/sky supervision masks (train/losses.py)."
)

IMG_EXTS = (".jpg", ".jpeg", ".png")


def load_models(sam_ckpt: str, sam_cfg: str, device):
    try:
        import torch  # noqa: F401
        from sam2.build_sam import build_sam2, build_sam2_video_predictor
        from sam2.sam2_image_predictor import SAM2ImagePredictor
        from transformers import (AutoModelForZeroShotObjectDetection,
                                  AutoProcessor)
    except ImportError as e:
        sys.exit(
            f"[generate_semantic] external dependency missing ({e}).\n"
            "Install Grounded-SAM-2 (github.com/IDEA-Research/"
            "Grounded-SAM-2) with its sam2 package and checkpoints, or "
            f"generate the masks with any other tool.\n{CONTRACT}")
    if not os.path.exists(sam_ckpt):
        sys.exit(f"[generate_semantic] SAM ckpt not found: {sam_ckpt}\n"
                 f"{CONTRACT}")
    video_predictor = build_sam2_video_predictor(sam_cfg, sam_ckpt,
                                                 device=device)
    image_predictor = SAM2ImagePredictor(build_sam2(sam_cfg, sam_ckpt,
                                                    device=device))
    model_id = "IDEA-Research/grounding-dino-base"
    processor = AutoProcessor.from_pretrained(model_id)
    grounding = AutoModelForZeroShotObjectDetection.from_pretrained(
        model_id).to(device)
    return video_predictor, image_predictor, processor, grounding


def detect_boxes(processor, grounding, image, text, device):
    """Grounding-DINO text-prompted boxes for one PIL image."""
    import torch
    inputs = processor(images=image, text=text,
                       return_tensors="pt").to(device)
    with torch.no_grad():
        outputs = grounding(**inputs)
    results = processor.post_process_grounded_object_detection(
        outputs, inputs.input_ids, box_threshold=0.25, text_threshold=0.25,
        target_sizes=[image.size[::-1]])
    return results[0]["boxes"].cpu().numpy(), results[0]["labels"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path")
    p.add_argument("--sam", default="./checkpoints/sam2.1_hiera_large.pt")
    p.add_argument("--sam_cfg", default="configs/sam2.1/sam2.1_hiera_l.yaml")
    p.add_argument("--device", default=None,
                   help="the card unless given (e.g. cpu)")
    p.add_argument("--text", default="car.bus.truck.van.human.")
    p.add_argument("--name", default="semantic")
    p.add_argument("--step", default=1, type=int,
                   help="re-detect every N frames; propagate in between")
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    dev = resolve_device(args.device)
    video_dir = os.path.join(args.path, "image")
    assert os.path.exists(video_dir), "Cannot find images: " + video_dir
    frames = sorted(f for f in os.listdir(video_dir)
                    if os.path.splitext(f)[1].lower() in IMG_EXTS)
    text = args.text if args.text.endswith(".") else args.text + "."
    out_dir = os.path.join(args.path, args.name)
    os.makedirs(out_dir, exist_ok=True)

    video_predictor, image_predictor, processor, grounding = load_models(
        args.sam, args.sam_cfg, dev)
    state = video_predictor.init_state(video_path=video_dir)

    next_id = 1
    for start in range(0, len(frames), args.step):
        img = Image.open(os.path.join(video_dir, frames[start]))
        boxes, labels = detect_boxes(processor, grounding, img, text, dev)
        if len(boxes) == 0:
            # nothing detected: emit empty masks for this chunk
            w, h = img.size
            for fi in range(start, min(start + args.step, len(frames))):
                stem = frames[fi].split(".")[0]
                np.save(os.path.join(out_dir, f"mask_{stem}.npy"),
                        np.zeros((h, w), np.uint16))
            continue
        image_predictor.set_image(np.asarray(img.convert("RGB")))
        masks, _, _ = image_predictor.predict(box=boxes,
                                              multimask_output=False)
        if masks.ndim == 4:
            masks = masks[:, 0]
        video_predictor.reset_state(state)
        ids = []
        for m in masks:
            video_predictor.add_new_mask(state, start, next_id,
                                         torch.from_numpy(m > 0))
            ids.append(next_id)
            next_id += 1
        for fidx, obj_ids, logits in video_predictor.propagate_in_video(
                state, max_frame_num_to_track=args.step,
                start_frame_idx=start):
            if fidx >= len(frames):
                break
            out = np.zeros(logits.shape[-2:], np.uint16)
            for i, oid in enumerate(obj_ids):
                out[(logits[i, 0] > 0.0).cpu().numpy()] = oid
            stem = frames[fidx].split(".")[0]
            np.save(os.path.join(out_dir, f"mask_{stem}.npy"), out)
        print(f"[{start + 1}/{len(frames)}] {len(ids)} objects")


if __name__ == "__main__":
    main()
