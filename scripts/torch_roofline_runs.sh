#!/usr/bin/env bash
# The port's roofline tools at their defaults on one card, in one run:
# roofline, bytes_attribution, train_roofline, gn_fusion_ceiling,
# head_fusion_ceiling and cls_loss_ab (2 x 900 steps), on an 80-class 640²
# shapes set made here. Each tool's report, log and wall seconds go under
# OUT (default runs/torch_perf); the card's name and power limit head
# summary.txt.
#
#   bash scripts/torch_roofline_runs.sh [OUT]
set -euo pipefail
OUT=${1:-runs/torch_perf}
DATA=data/shapes80_640
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/summary.txt"
python3 -m hvs_tpu_torch.build
if [ ! -d "$DATA" ]; then
  python3 -m hvs_tpu_torch.make_shapes_dataset --root "$DATA" --num-classes 80 --size 640 \
    --train 512 --val 1 > "$OUT/make_shapes_dataset.log"
fi
run() {
  local name=$1
  shift
  local t0=$SECONDS
  python3 -m "hvs_tpu_torch.$name" "$@" --output "$OUT/$name.json" > "$OUT/$name.log" 2>&1
  echo "$name $((SECONDS - t0)) s" | tee -a "$OUT/summary.txt"
}
run roofline
run bytes_attribution
run train_roofline --data-root "$DATA"
run gn_fusion_ceiling
run head_fusion_ceiling
run cls_loss_ab --data-root "$DATA"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader >> "$OUT/summary.txt"
