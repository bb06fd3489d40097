"""Where the time of the port's training step goes, on one CUDA card.

    python3 scripts/torch_train_profile.py [--batch 8] [--image 416] [--iters 3] [--trace out.json]

Builds the full-width flagship ``HybridVisionSystem`` (telemetry on, the JAX
dropout rates, bf16, 8 classes), trains it with ``ManifoldConstrainedTrainer``
on the synthetic batches of ``hvs_tpu_torch.train`` and runs
``torch.profiler`` over ``--iters`` train steps and then ``--iters``
validation batches, after a warm-up. Prints, for each, the JSON lines of
``torch_serve_profile.py`` (wall and device ms, idle share, device ms by
kernel category, top kernels) beside the card's name and power limit. Exits
non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_serve_profile import summarize  # noqa: E402  (same directory)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image", type=int, default=416)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write a chrome trace of the steps here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        raise SystemExit(1)

    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.train import make_synthetic_loader
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig, eval_step
    from hvs_tpu_torch.training.trainer import batch_to

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    classes, warmup = 8, 3
    trainer = ManifoldConstrainedTrainer(HybridVisionSystem(num_classes=classes, monitor=True),
                                         TrainerConfig(num_classes=classes, backbone_lr_factor=0.1))
    trainer.init_state()
    batches = list(make_synthetic_loader(args.batch, args.image, warmup + args.iters, classes,
                                         64)())
    for b in batches[:warmup]:
        trainer.train_step(b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    head = {"batch": args.batch, "image": args.image}

    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in batches[warmup:]:
            metrics = trainer.train_step(b)
            float(metrics["loss"])  # the host pull train_epoch makes every step
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)
    summarize(prof, args.iters, wall_ms, card, {**head, "path": "train_step"}, "step")

    val = [batch_to(b, trainer.device) for b in batches[warmup:]]
    eval_step(trainer.model, trainer.config, val[0])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in val:
            float(eval_step(trainer.model, trainer.config, b)["val_loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
    summarize(prof, args.iters, wall_ms, card, {**head, "path": "validation"}, "batch")


if __name__ == "__main__":
    main()
