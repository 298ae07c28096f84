#!/bin/bash
# Waymo StreetGS validation scenes on the PyTorch port
# (scripts/waymo/run-waymo.sh with the port's CLIs).
set -e
DATA=${1:-./data/waymo}
OUT=${2:-./output/waymo}
for scene in "$DATA"/*/; do
  name=$(basename "$scene")
  python -m adgs_tpu_torch.cli.train -s "$scene" -m "$OUT/$name" -c configs/waymo.py
  python -m adgs_tpu_torch.cli.render -m "$OUT/$name" --skip_train
done
