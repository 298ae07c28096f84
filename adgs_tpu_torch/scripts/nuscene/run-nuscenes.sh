#!/bin/bash
# nuScenes scenes 0230/0242/0255/0295/0518/0749, frames 10-69, on the
# PyTorch port (scripts/nuscene/run-nuscenes.sh with the port's CLIs).
set -e
DATA=${1:-./data/nuscenes}
OUT=${2:-./output/nuscenes}
for scene in 0230 0242 0255 0295 0518 0749; do
  python -m adgs_tpu_torch.cli.train -s "$DATA/scene-$scene" -m "$OUT/$scene" \
    -c configs/nuscenes.py
  python -m adgs_tpu_torch.cli.render -m "$OUT/$scene" --skip_train
done
