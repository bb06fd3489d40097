"""Training entry point of the port: the flagship ``HybridVisionSystem`` on
synthetic data, through ``ManifoldConstrainedTrainer.train``.

Counterpart of ``scripts/train.py --synthetic [--tiny]`` with the JAX
package's ``TrainingConfig`` defaults (batch 8, 416², 64 boxes, AdamW 1e-3
with 1000 warmup steps, manifold alpha 0.01, projection every 100 steps,
backbone LR factor 0.1, 100 epochs with early stopping). Runs on the CUDA
card unless ``--device cpu`` is given:

    python -m hvs_tpu_torch.train --synthetic --tiny --steps 2 --device cpu
    python -m hvs_tpu_torch.train --synthetic --steps 50 --epochs 1

Checkpoints go to ``--checkpoint-dir`` and the stability report to
``--log-dir``. The COCO data module is not ported yet, so ``--synthetic`` is
required.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

# Widths of the tiny smoke model (scripts/train.py --tiny).
TINY = dict(stage_channels=(16, 24, 32, 40), stage_blocks=(1, 1, 1, 1), vit_dim=16,
            vit_depth=1, vit_heads=2, fpn_channels=16, head_channels=16, sk_iters=5)


def make_synthetic_loader(batch: int, image_size: int, steps: int, num_classes: int,
                          max_boxes: int, seed: int = 0
                          ) -> Callable[[], Iterator[Dict[str, np.ndarray]]]:
    """Random images and padded boxes from a numpy seed (scripts/train.py)."""

    def loader():
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            yield {
                "images": rng.standard_normal((batch, image_size, image_size, 3)).astype(np.float32),
                "boxes": np.clip(rng.uniform(0.1, 0.9, (batch, max_boxes, 4)), 0.05, 0.95
                                 ).astype(np.float32),
                "labels": rng.integers(0, num_classes, (batch, max_boxes)).astype(np.int32),
                "box_mask": (rng.uniform(size=(batch, max_boxes)) > 0.5).astype(np.float32),
            }

    return loader


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train HybridVisionSystem (PyTorch/CUDA port)")
    p.add_argument("--synthetic", action="store_true", help="train on synthetic random data")
    p.add_argument("--steps", type=int, default=50, help="steps per epoch with --synthetic")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--image-size", type=int, default=416)
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--tiny", action="store_true", help="tiny model (smoke runs)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--resume", default=None)
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit("only --synthetic data is ported so far (the COCO data module is not)")

    from .device import pin_matmul_precision
    from .models import HybridVisionSystem
    from .training import ManifoldConstrainedTrainer, TrainerConfig

    pin_matmul_precision()

    widths = dict(TINY) if args.tiny else {}
    image_size, max_boxes = args.image_size, 64  # TrainingConfig's dataset.max_boxes
    if args.tiny:
        image_size, max_boxes = min(image_size, 64), min(max_boxes, 8)
    model = HybridVisionSystem(num_classes=args.num_classes, monitor=True, device=args.device,
                               seed=args.seed, **widths)
    config = TrainerConfig(
        num_classes=args.num_classes, learning_rate=args.learning_rate, max_boxes=max_boxes,
        backbone_lr_factor=0.1, checkpoint_dir=args.checkpoint_dir)
    trainer = ManifoldConstrainedTrainer(model, config, device=args.device, seed=args.seed)
    trainer.init_state()
    train_loader = make_synthetic_loader(args.batch_size, image_size, args.steps,
                                         args.num_classes, max_boxes)
    val_loader = make_synthetic_loader(args.batch_size, image_size, max(args.steps // 5, 1),
                                       args.num_classes, max_boxes, seed=1)
    t0 = time.perf_counter()
    result = trainer.train(train_loader, val_loader, epochs=args.epochs, resume_from=args.resume)
    os.makedirs(args.log_dir, exist_ok=True)
    report = os.path.join(args.log_dir, "stability_report.json")
    trainer.monitor.save_report(report)
    summary = {"device": str(trainer.device), "steps": trainer.state.step,
               "seconds": time.perf_counter() - t0,
               "params": sum(p.numel() for p in model.parameters()),
               "train_loss": result["history"]["train_loss"],
               "best_val_loss": result["best_val_loss"], "stability_report": report}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
