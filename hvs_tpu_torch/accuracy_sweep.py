"""Resolution-sweep accuracy evaluation of one checkpoint.

Counterpart of ``scripts/accuracy_sweep.py``, with its flags and report keys
plus ``--device``: the checkpoint evaluated at each of ``--resolutions``
(320, 416, 512 and 640 by default) on a COCO-format split, with AP by object
size and by class, and, from the same engine at each resolution, batch-16
frames/s (``engine._serve_fn(16)``'s captured graph replayed 20 times, one
synchronize after the loop). Each resolution goes through
``evaluate.run``, the port's dataset -> ``InferenceEngine.infer`` (BGR
frames) -> ``DetectionEvaluator`` loop, at score threshold 0.05, with the
EMA weights unless ``--no-ema`` and the retrieval path with ``--use-rag``.
``trained_steps`` is the last row of the run's ``chunks.jsonl``
(``<run dir>/checkpoints/<name>``). The default ``--output`` is
``accuracy_sweep.json``. On stderr, one JSON line gives the graphs'
replays, the graphs captured and the kernel counters over the sweep
(``kernel_launches``).
Runs on the card unless ``--device cpu`` is given::

    python -m hvs_tpu_torch.accuracy_sweep --checkpoint runs/r3/checkpoints/best \\
        --data-root data/shapes640
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

FPS_BATCH = 16
FPS_ITERS = 20


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Resolution-sweep accuracy (PyTorch/CUDA port)")
    p.add_argument("--checkpoint", required=True,
                   help="a checkpoint of the port's trainer (<path> or <path>.pt)")
    p.add_argument("--data-root", default="data/shapes640")
    p.add_argument("--split", default="val")
    p.add_argument("--resolutions", default="320,416,512,640")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--use-rag", action="store_true",
                   help="build the model with the RAG path (for RAG-trained checkpoints)")
    p.add_argument("--trained-steps", type=int, default=None)
    p.add_argument("--output", default="accuracy_sweep.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def evaluate_at(resolution: int, args: argparse.Namespace, launches: Dict[str, int]
                ) -> Dict[str, Any]:
    """One resolution: the accuracy, AP by size and class, and b16 frames/s.
    Adds the engine's replays and its graphs captured to ``launches``."""
    from . import evaluate
    from .benchmark import replay, stage

    run = evaluate.run(argparse.Namespace(
        data_root=args.data_root, split=args.split, checkpoint=args.checkpoint,
        max_images=args.max_images, image_size=resolution, score_threshold=0.05,
        no_ema=args.no_ema, use_rag=args.use_rag, tiny=False, num_classes=None,
        device=args.device))
    result = {k: round(v, 4) for k, v in run.report["accuracy"].items()}
    result["per_class_AP@0.5"] = {c: round(v, 4)
                                  for c, v in run.report["per_class_AP@0.5"].items()}
    result["eval_seconds"] = round(run.seconds, 1)

    engine = run.engine
    entry = engine._serve_fn(FPS_BATCH)
    stage(engine, entry, np.random.default_rng(0).integers(
        0, 255, (FPS_BATCH, resolution, resolution, 3), np.uint8))
    replay(engine, entry, 1)
    engine._synchronize()
    t0 = time.perf_counter()
    replay(engine, entry, FPS_ITERS)
    engine._synchronize()
    dt = (time.perf_counter() - t0) / FPS_ITERS
    result["fps_per_chip_batch16"] = round(FPS_BATCH / dt, 1)
    result["batch16_ms"] = round(dt * 1e3, 3)
    launches["replays"] += sum(engine.replays.values())
    launches["graphs"] += len(engine.replays)
    launches["kernel_sites"] = engine.kernel_sites
    print(f"  {resolution}: mAP@0.5={result.get('mAP@0.5')} "
          f"small={result.get('AP@0.5_small')} ({result['eval_seconds']}s)", flush=True)
    return result


def trained_steps_of(checkpoint: str) -> Optional[int]:
    """The step of the last row of ``<run dir>/chunks.jsonl`` for a
    checkpoint at ``<run dir>/checkpoints/<name>``."""
    chunks = os.path.join(os.path.dirname(os.path.dirname(checkpoint.rstrip("/"))),
                          "chunks.jsonl")
    if not os.path.exists(chunks):
        return None
    with open(chunks) as f:
        rows = f.readlines()
    return json.loads(rows[-1]).get("step") if rows else None


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    from .training.chunk import kernel_counts

    resolutions = [int(r) for r in args.resolutions.split(",")]
    launches: Dict[str, Any] = {"replays": 0, "graphs": 0, "kernel_sites": 0}
    sweep = {}
    for r in resolutions:
        print(f"evaluating @{r} ...", flush=True)
        sweep[str(r)] = evaluate_at(r, args, launches)

    headline = sweep.get("640") or sweep[str(resolutions[-1])]
    with open(os.path.join(args.data_root, "annotations",
                           f"instances_{args.split}.json")) as f:
        n_classes = len(json.load(f).get("categories", []))
    trained_steps = args.trained_steps
    if trained_steps is None:
        trained_steps = trained_steps_of(args.checkpoint)
    report = {
        "benchmark": f"hardened synthetic shapes detection (COCO-format, {n_classes} classes, "
                     f"640-native, 30% small objects 10-32px, 2-12 instances/img, overlap<=0.4 "
                     f"IoU; python -m hvs_tpu_torch.make_shapes_dataset --size 640 seed=0)",
        "checkpoint": args.checkpoint,
        "trained_steps": trained_steps,
        "headline": {
            "resolution": 640,
            "mAP@0.5": headline.get("mAP@0.5"),
            "mAP@[.5:.95]": headline.get("mAP@[.5:.95]"),
            "AP@0.5_small": headline.get("AP@0.5_small"),
            "AP@0.5_medium": headline.get("AP@0.5_medium"),
            "AP@0.5_large": headline.get("AP@0.5_large"),
        },
        "resolution_sweep": sweep,
        "criteria": {
            "mAP@0.5 >= 0.90": (headline.get("mAP@0.5") or 0) >= 0.90,
            "AP_small measured (> 0)": (headline.get("AP@0.5_small") or -1) > 0,
            "640 >= 416 (rises with resolution like the reference table)": (
                (sweep.get("640", {}).get("mAP@0.5") or 0)
                >= (sweep.get("416", {}).get("mAP@0.5") or 1)),
        },
        "reference": "reference COCO mAP@0.5=0.78 (README.md:183); "
                     "resolution table PROJECT.md:964-969",
    }
    with open(args.output, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({**launches, "kernel_launches": kernel_counts()}), file=sys.stderr,
          flush=True)
    print(json.dumps(report["criteria"], indent=2))
    return report


if __name__ == "__main__":
    main()
