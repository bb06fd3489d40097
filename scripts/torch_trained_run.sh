#!/usr/bin/env bash
# The port's first trained checkpoint on one card, and what is measured on it:
# the shapes dataset at 640² (4,000 + 500 images), train_device for STEPS
# captured steps (8 classes), evaluate at 640² on the 500 val images, the
# trained-weight checks (scripts/torch_trained_checks.py) and int8
# calibration and scoring at 416² and 640² (python -m hvs_tpu_torch.quantize).
# Everything small lands in OUT; the dataset and the checkpoint stay in
# data/ and runs/ (both gitignored).
#
#   bash scripts/torch_trained_run.sh [OUT] [STEPS]
#
# With QUANTIZE=0 in the environment the int8 step is left out.
#
# PROTOCOL=r3_rag_off runs instead the protocol that RAG_EVAL_r03.json
# records for the JAX package's rag_off variant: 6,000 steps at 416² only,
# batch 16, lr 1e-3, warm-up 300, EMA 0.999, 8 classes, validation every
# 1,000 steps, then evaluate at 416² on the 500 val images from the best
# checkpoint and run the trained-weight checks on it at 416² (STEPS is
# ignored; no int8), and on that checkpoint the measurement entry points:
# accuracy_sweep at 320/416/512/640, summarize_run, bench
# (HVS_BENCH_CHECKPOINT), benchmark at 640² on batches 1-16, and
# serve_bench closed, then rated at half the closed frames/s, then overload
# at three times it (shed_oldest), with the val JPEGs and the class count
# read from the checkpoint. PROTOCOL=r3_rag_gated is the same without them,
# with --use-rag (the
# variant rag_learnable_gate of RAG_EVAL_r03.json), evaluated and checked
# with the retrieval path, and writes the trained gate to OUT/rag_gate.json.
# With PARENT set to a directory holding another tree of this repository (an
# earlier commit unpacked with git archive), the checkpoint is also
# evaluated and checked by that tree's code (OUT/parent_*): the two trees'
# serve paths on the same weights. The run directory is runs/<PROTOCOL>.
#
#   PROTOCOL=r3_rag_off PARENT=_compare/parent bash scripts/torch_trained_run.sh [OUT]
#   PROTOCOL=r3_rag_gated bash scripts/torch_trained_run.sh [OUT]
#
# PROTOCOL=r4_multitask runs instead the multi-task protocol that
# MULTITASK_r04.json records for the JAX package (scripts/r4_chip_runs.sh's
# step 7): train_multitask with the segmentation and depth heads, 20,000
# steps at 416², batch 8, on 1,600 + 200 dense shapes images generated in
# data/shapes_mt416, then scripts/torch_run_summary.py --multitask beside the
# reference (STEPS is ignored; train_multitask keeps no checkpoint).
#
#   PROTOCOL=r4_multitask bash scripts/torch_trained_run.sh [OUT]
set -uo pipefail
OUT=${1:-runs/trained_report}
STEPS=${2:-10000}
DATA=data/shapes640
PROTOCOL=${PROTOCOL:-default}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
stamp() { echo "$(date +%s) $*" | tee -a "$OUT/times.txt"; }

# The measurement and accuracy entry points on the trained checkpoint (the
# counterparts of the JAX package's accuracy_sweep.py, summarize_run.py,
# bench.py, benchmark.py and serve_bench.py), each into OUT.
measure_on_checkpoint() {
  local run=$1 ckpt=$2 mode
  python -m hvs_tpu_torch.accuracy_sweep --checkpoint "$ckpt" --data-root "$DATA" \
    --output "$OUT/accuracy_sweep.json" > "$OUT/accuracy_sweep.log" 2>&1 \
    || { stamp sweep_failed; tail -30 "$OUT/accuracy_sweep.log"; return 1; }
  stamp swept
  python -m hvs_tpu_torch.summarize_run --steps "$run/steps.jsonl" --chunks "$run/chunks.jsonl" \
    --report "$run/stability_report.json" --output "$OUT/stability.json" > /dev/null \
    || { stamp summarize_failed; return 1; }
  HVS_BENCH_CHECKPOINT="$ckpt" python -m hvs_tpu_torch.bench > "$OUT/bench.json" \
    2> "$OUT/bench.log" || { stamp bench_failed; tail -30 "$OUT/bench.log"; return 1; }
  cat "$OUT/bench.json"
  stamp benched
  python -m hvs_tpu_torch.benchmark --checkpoint "$ckpt" --image-size 640 \
    --batches 1 2 4 8 16 --output "$OUT/benchmark" > "$OUT/benchmark.log" 2>&1 \
    || { stamp benchmark_failed; tail -30 "$OUT/benchmark.log"; return 1; }
  tail -n 1 "$OUT/benchmark.log"
  stamp benchmarked
  for mode in closed rated overload; do
    local extra=()
    [ "$mode" = rated ] && extra=(--rate "$(python -c "import json; print(json.load(open('$OUT/serve_closed.json'))['sustained_fps_host_inclusive'] / 2)")")
    [ "$mode" = overload ] && extra=(--rate "$(python -c "import json; print(json.load(open('$OUT/serve_closed.json'))['sustained_fps_host_inclusive'] * 3)")" --policy shed_oldest)
    python -m hvs_tpu_torch.serve_bench --checkpoint "$ckpt" --jpeg-dir "$DATA/val" \
      --mode "$mode" "${extra[@]}" --output "$OUT/serve_$mode.json" > "$OUT/serve_$mode.log" 2>&1 \
      || { stamp "serve_${mode}_failed"; tail -30 "$OUT/serve_$mode.log"; return 1; }
    stamp "served_$mode"
  done
}

stamp start
if [ "$PROTOCOL" = r4_multitask ]; then
  RUN=runs/r4_multitask
  python -m hvs_tpu_torch.train_multitask --size 416 --steps 20000 --num-train 1600 \
    --num-val 200 --batch-size 8 --data-root data/shapes_mt416 --output "$RUN/report.json" \
    > "$OUT/train.log" 2>&1 || { stamp train_failed; tail -50 "$OUT/train.log"; exit 1; }
  stamp trained
  cp "$RUN/report.json" "$OUT/report.json"
  python scripts/torch_run_summary.py --multitask "$RUN/report.json" > "$OUT/summary.json" \
    || { stamp summary_failed; exit 1; }
  cat "$OUT/summary.json"
  exit 0
fi
if [ ! -f "$DATA/annotations/instances_val.json" ]; then
  python -m hvs_tpu_torch.make_shapes_dataset --root "$DATA" --size 640 \
    > "$OUT/make_dataset.log" 2>&1 || { stamp dataset_failed; exit 1; }
fi
stamp dataset
if [ "$PROTOCOL" = r3_rag_off ] || [ "$PROTOCOL" = r3_rag_gated ]; then
  RAG=""
  [ "$PROTOCOL" = r3_rag_gated ] && RAG=--use-rag
  RUN=runs/$PROTOCOL
  python -m hvs_tpu_torch.train_device --data-root "$DATA" --num-classes 8 \
    --train-sizes 416 --total-steps 6000 --warmup-steps 300 --learning-rate 1e-3 \
    --ema-decay 0.999 --batch-416 16 --chunk-steps 100 --val-every-chunks 10 $RAG \
    --run-dir "$RUN" > "$OUT/train.log" 2>&1 || { stamp train_failed; tail -50 "$OUT/train.log"; exit 1; }
  stamp trained
  cp "$RUN"/steps.jsonl "$RUN"/chunks.jsonl "$RUN"/stability_report.json "$OUT"/ 2>/dev/null
  python scripts/torch_run_summary.py "$RUN" --window 1000 > "$OUT/summary.json" \
    || { stamp summary_failed; exit 1; }
  cat "$OUT/summary.json"
  CKPT="$RUN/checkpoints/best"
  if [ "$PROTOCOL" = r3_rag_gated ]; then
    python - "$CKPT.pt" > "$OUT/rag_gate.json" <<'PY'
import json, sys, torch
ckpt = torch.load(sys.argv[1], map_location="cpu")
gate = {"params": float(ckpt["params"]["rag_gate"]), "step": ckpt["step"]}
if ckpt.get("ema_params") is not None:
    gate["ema_params"] = float(ckpt["ema_params"]["rag_gate"])
print(json.dumps(gate))
PY
    cat "$OUT/rag_gate.json"
  fi
  python -m hvs_tpu_torch.evaluate --data-root "$DATA" --split val --image-size 416 \
    --num-classes 8 --checkpoint "$CKPT" $RAG --output "$OUT/eval416.json" \
    > "$OUT/eval.log" 2>&1 || { stamp eval_failed; tail -50 "$OUT/eval.log"; exit 1; }
  stamp evaluated
  tail -n 3 "$OUT/eval.log"
  if [ "$PROTOCOL" = r3_rag_off ]; then
    measure_on_checkpoint "$RUN" "$CKPT" || exit 1
  fi
  python scripts/torch_trained_checks.py --checkpoint "$CKPT" --data-root "$DATA" \
    --num-classes 8 --image-size 416 $RAG --output "$OUT/checks.json" \
    --dump "$OUT/sites.pt" > "$OUT/checks.log" 2>&1
  echo "checks exit $?" | tee -a "$OUT/times.txt"
  stamp checked
  if [ -n "${PARENT:-}" ]; then
    ABS_CKPT=$(realpath "$CKPT"); ABS_DATA=$(realpath "$DATA"); ABS_OUT=$(realpath "$OUT")
    (cd "$PARENT" && python -m hvs_tpu_torch.evaluate --data-root "$ABS_DATA" --split val \
      --image-size 416 --num-classes 8 --checkpoint "$ABS_CKPT" \
      --output "$ABS_OUT/parent_eval416.json" > "$ABS_OUT/parent_eval.log" 2>&1)
    echo "parent evaluate exit $?" | tee -a "$OUT/times.txt"
    (cd "$PARENT" && python scripts/torch_trained_checks.py --checkpoint "$ABS_CKPT" \
      --data-root "$ABS_DATA" --num-classes 8 --image-size 416 \
      --output "$ABS_OUT/parent_checks.json" > "$ABS_OUT/parent_checks.log" 2>&1)
    echo "parent checks exit $?" | tee -a "$OUT/times.txt"
    stamp parent_checked
  fi
  exit 0
fi
RUN=runs/trained
python -m hvs_tpu_torch.train_device --data-root "$DATA" --num-classes 8 \
  --total-steps "$STEPS" --run-dir "$RUN" > "$OUT/train.log" 2>&1 \
  || { stamp train_failed; tail -50 "$OUT/train.log"; exit 1; }
stamp trained
cp "$RUN"/steps.jsonl "$RUN"/chunks.jsonl "$RUN"/stability_report.json "$OUT"/ 2>/dev/null
python scripts/torch_run_summary.py "$RUN" > "$OUT/summary.json"
cat "$OUT/summary.json"
CKPT="$RUN/checkpoints/final"
python -m hvs_tpu_torch.evaluate --data-root "$DATA" --split val --image-size 640 \
  --num-classes 8 --checkpoint "$CKPT" --output "$OUT/eval640.json" > "$OUT/eval.log" 2>&1 \
  || { stamp eval_failed; tail -50 "$OUT/eval.log"; exit 1; }
stamp evaluated
python scripts/torch_trained_checks.py --checkpoint "$CKPT" --data-root "$DATA" \
  --num-classes 8 --output "$OUT/checks.json" --dump "$OUT/sites.pt" > "$OUT/checks.log" 2>&1
echo "checks exit $?" | tee -a "$OUT/times.txt"
stamp checked
if [ "${QUANTIZE:-1}" != 0 ]; then
  python -m hvs_tpu_torch.quantize --checkpoint "$CKPT" --data-root "$DATA" \
    --eval-fpn --eval-mhc --eval-vit --scales-out "$RUN/quant_scales.pt" \
    --output "$OUT/quant.json" > "$OUT/quant.log" 2>&1
  echo "quantize exit $?" | tee -a "$OUT/times.txt"
  stamp quantized
  tail -n 3 "$OUT/quant.log"
fi
tail -n 3 "$OUT/eval.log"
head -c 3000 "$OUT/checks.json"; echo
