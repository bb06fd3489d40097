"""Training entry point of the port: the flagship ``HybridVisionSystem``
through ``ManifoldConstrainedTrainer.train``, on a COCO-format dataset read
by ``COCODataModule`` (``--data-root``) or on synthetic batches
(``--synthetic``).

Counterpart of ``scripts/train.py``. The settings come from a
``TrainingConfig`` (``--config`` YAML or JSON; defaults: batch 8, 416², 64
boxes, AdamW 1e-3 with 1000 warm-up steps, manifold alpha 0.01, projection
every 100 steps, backbone LR factor 0.1, 100 epochs with early stopping),
overridden by the flags. On a dataset the class count follows its
categories (8 for the shapes benchmark) unless ``--num-classes`` is given;
its batches are uint8 and normalized on the device. The device is
``--device``, never the file's (the reference's files name a TPU): the CUDA
card unless ``--device cpu`` is given:

    python -m hvs_tpu_torch.train --config configs/shapes_training.yaml --data-root data/shapes
    python -m hvs_tpu_torch.train --synthetic --tiny --steps 2 --device cpu
    python -m hvs_tpu_torch.train --synthetic --steps 50 --epochs 1

Checkpoints go to the config's ``checkpoint_dir`` (``--checkpoint-dir``)
and the stability report to its ``log_dir`` (``--log-dir``).
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
    p.add_argument("--config", default=None, help="training YAML or JSON (TrainingConfig)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--data-root", default=None, help="COCO-format dataset root")
    p.add_argument("--resume", default=None)
    p.add_argument("--synthetic", action="store_true", help="train on synthetic random data")
    p.add_argument("--steps", type=int, default=50, help="steps per epoch with --synthetic")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--tiny", action="store_true", help="tiny model (smoke runs)")
    p.add_argument("--num-classes", type=int, default=None,
                   help="class count (default: the dataset's, 80 with --synthetic)")
    p.add_argument("--cache-images", action="store_true",
                   help="keep decoded images in host memory (small datasets)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def training_config(args: argparse.Namespace):
    """The run's ``TrainingConfig``: the file's settings (or the defaults)
    with the flags applied, on ``--device``."""
    from .config.base import _read, from_dict
    from .config.training import TrainingConfig

    data = _read(args.config) if args.config else {}
    data["device"] = args.device or "auto"
    tcfg = from_dict(TrainingConfig, data)
    for flag, (obj, field) in {"epochs": (tcfg, "epochs"), "batch_size": (tcfg, "batch_size"),
                               "learning_rate": (tcfg.optimizer, "learning_rate"),
                               "data_root": (tcfg.dataset, "root"),
                               "image_size": (tcfg.dataset, "image_size"),
                               "checkpoint_dir": (tcfg, "checkpoint_dir"),
                               "log_dir": (tcfg, "log_dir")}.items():
        if getattr(args, flag) is not None:
            setattr(obj, field, getattr(args, flag))
    if args.tiny:
        tcfg.dataset.image_size = min(tcfg.dataset.image_size, 64)
        tcfg.dataset.max_boxes = min(tcfg.dataset.max_boxes, 8)
    return tcfg


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    from .device import pin_matmul_precision
    from .models import HybridVisionSystem
    from .training import ManifoldConstrainedTrainer

    tcfg = training_config(args)
    pin_matmul_precision()
    ds = tcfg.dataset
    if args.synthetic:
        num_classes = args.num_classes if args.num_classes is not None else 80
        train_loader = make_synthetic_loader(tcfg.batch_size, ds.image_size, args.steps,
                                             num_classes, ds.max_boxes)
        val_loader = make_synthetic_loader(tcfg.batch_size, ds.image_size,
                                           max(args.steps // 5, 1), num_classes, ds.max_boxes,
                                           seed=1)
    else:
        from .data import COCODataModule

        dm = COCODataModule(root=ds.root, image_size=ds.image_size, batch_size=tcfg.batch_size,
                            max_boxes=ds.max_boxes, num_workers=ds.num_workers,
                            train_split=ds.train_split, val_split=ds.val_split,
                            max_samples=ds.max_samples, augmentation_config=tcfg.augmentation,
                            cache_images=args.cache_images)
        dm.setup()
        train_loader, val_loader = dm.train_dataloader, dm.val_dataloader
        # The class count follows the dataset (8 for the shapes benchmark).
        num_classes = (args.num_classes if args.num_classes is not None
                       else len(dm.train_dataset.class_names))
        print(f"dataset: {len(dm.train_dataset)} train / {len(dm.val_dataset)} val images, "
              f"{num_classes} classes", flush=True)

    model = HybridVisionSystem(num_classes=num_classes, monitor=True, device=tcfg.device,
                               seed=args.seed, **(dict(TINY) if args.tiny else {}))
    trainer = ManifoldConstrainedTrainer(model, tcfg.trainer_config(num_classes=num_classes),
                                         device=tcfg.device, seed=args.seed)
    trainer.init_state()
    os.makedirs(tcfg.log_dir, exist_ok=True)
    if tcfg.metrics_log and os.path.dirname(tcfg.metrics_log):
        os.makedirs(os.path.dirname(tcfg.metrics_log), exist_ok=True)
    t0 = time.perf_counter()
    result = trainer.train(train_loader, val_loader, epochs=tcfg.epochs,
                           resume_from=args.resume)
    trainer.close()
    report = os.path.join(tcfg.log_dir, "stability_report.json")
    trainer.monitor.save_report(report)
    summary = {"device": str(trainer.device), "steps": trainer.state.step,
               "seconds": time.perf_counter() - t0,
               "params": sum(p.numel() for p in model.parameters()),
               "num_classes": num_classes,
               "train_loss": result["history"]["train_loss"],
               "best_val_loss": result["best_val_loss"], "stability_report": report}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
