#!/bin/bash
# Canonical KITTI-MOT sweep on the PyTorch port: scenes 0001/0002/0006 at
# the nvs-25/50/75 splits (scripts/kitti/run-kitti.sh with the port's CLIs).
set -e
DATA=${1:-./data/kitti}
OUT=${2:-./output/kitti}
for scene in 0001 0002 0006; do
  for split in 25 50 75; do
    python -m adgs_tpu_torch.cli.train \
      -s "$DATA/$scene" -m "$OUT/$scene-nvs$split" \
      -c configs/kitti-$split.py
    python -m adgs_tpu_torch.cli.render -m "$OUT/$scene-nvs$split" --skip_train
  done
done
