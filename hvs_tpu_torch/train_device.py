"""Long training run on the card: the dataset in device memory, batches drawn
and augmented on the device, one captured train step per resolution.

Counterpart of ``scripts/train_device.py``, with its flags and defaults
(sizes 416 and 640 cycled per chunk, batches 16 and 8, 80 classes, 16 boxes
per image, EMA 0.999, 1000 warm-up steps, chunks of 100 steps), through
``ManifoldConstrainedTrainer.train_chunked``. The data is the ``train`` and
``val`` splits of a COCO-format dataset of square frames under
``--data-root`` (``load_coco_arrays``; the shapes benchmark of
``python -m hvs_tpu_torch.make_shapes_dataset``), whose class count
``--num-classes`` must match, or with ``--synthetic N`` N seeded uint8
images with random boxes, made with numpy, and N // 4 (at least 4)
validation images. Runs on the CUDA card unless ``--device cpu`` is given;
``--tiny`` takes the tiny smoke model and scales the sizes down (416 → 64,
640 → 96) with batches of at most 2:

    python -m hvs_tpu_torch.train_device --data-root data/shapes640 --num-classes 8
    python -m hvs_tpu_torch.train_device --synthetic 512 --total-steps 2000
    python -m hvs_tpu_torch.train_device --synthetic 8 --tiny --device cpu \\
        --total-steps 4 --chunk-steps 2

Writes ``steps.jsonl``, ``chunks.jsonl``, ``stability_report.json`` and
``checkpoints/`` under ``--run-dir`` and prints the JAX script's final JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:
    from .training import ManifoldConstrainedTrainer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="On-device long training run (PyTorch/CUDA port)")
    p.add_argument("--data-root", default="data/shapes640",
                   help="COCO-format dataset of square frames (train and val splits)")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="train on N seeded synthetic images instead of --data-root")
    p.add_argument("--total-steps", type=int, default=50_000)
    p.add_argument("--chunk-steps", type=int, default=100)
    p.add_argument("--train-sizes", default="416,640",
                   help="comma-separated resolutions cycled per chunk")
    p.add_argument("--batch-416", type=int, default=16)
    p.add_argument("--batch-640", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--ema-decay", type=float, default=0.999)
    p.add_argument("--max-boxes", type=int, default=16)
    p.add_argument("--run-dir", default="runs/device_run")
    p.add_argument("--checkpoint-every-steps", type=int, default=5000)
    p.add_argument("--val-every-chunks", type=int, default=20)
    p.add_argument("--eig-every-chunks", type=int, default=10)
    p.add_argument("--resume", default=None, help="checkpoint name/path to resume")
    p.add_argument("--cls-loss", default="bce", choices=["bce", "softmax"])
    p.add_argument("--cls-pos-weight", type=float, default=1.0)
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--use-rag", action="store_true",
                   help="RAG blend (not ported yet: ROADMAP queue 1 item 9)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true", help="tiny model and sizes (smoke runs)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def synthetic_arrays(n: int, size: int, max_boxes: int, num_classes: int, seed: int):
    """``n`` seeded uint8 images [n, size, size, 3] of smooth colour noise
    with 1..max_boxes boxes each (normalized cxcywh, labels, mask)."""
    r = np.random.default_rng(seed)
    coarse = r.integers(0, 256, (n, size // 16 + 1, size // 16 + 1, 3), dtype=np.uint8)
    images = np.repeat(np.repeat(coarse, 16, axis=1), 16, axis=2)[:, :size, :size]
    images = np.ascontiguousarray(images)
    wh = r.uniform(0.04, 0.5, (n, max_boxes, 2))
    centre = r.uniform(wh / 2, 1 - wh / 2)
    boxes = np.concatenate([centre, wh], axis=-1).astype(np.float32)
    labels = r.integers(0, num_classes, (n, max_boxes)).astype(np.int32)
    count = r.integers(1, max_boxes + 1, n)
    mask = (np.arange(max_boxes)[None, :] < count[:, None]).astype(np.float32)
    return images, boxes, labels, mask


def tiny_size(size: int) -> int:
    """A training size scaled for the tiny model: 0.15x, a multiple of 32."""
    return max(32, round(size * 0.15 / 32) * 32)


def run(args: argparse.Namespace) -> Tuple["ManifoldConstrainedTrainer", Dict[str, object]]:
    """The whole run of ``main``; returns the trainer (its captured steps
    are ``trainer.chunks``, its validation graph ``trainer.val_chunk``) and
    the summary that ``main`` prints."""
    if args.use_rag:
        raise NotImplementedError("--use-rag: the RAG blend is not ported yet "
                                  "(ROADMAP queue 1 item 9)")
    from .data import load_coco_arrays, put_device_data
    from .device import pin_matmul_precision, resolve_device
    from .models import HybridVisionSystem
    from .train import TINY
    from .training import ManifoldConstrainedTrainer, TrainerConfig

    device = resolve_device(args.device)
    pin_matmul_precision()
    os.makedirs(args.run_dir, exist_ok=True)
    sizes = tuple(int(s) for s in args.train_sizes.split(","))
    batch_sizes = {416: args.batch_416, 640: args.batch_640}
    if args.tiny:
        batch_sizes = {tiny_size(s): min(batch_sizes.get(s, 2), 2) for s in sizes}
        sizes = tuple(tiny_size(s) for s in sizes)
    image_size = max(sizes) if args.tiny else 640

    t0 = time.time()
    if args.synthetic is None:
        train = load_coco_arrays(args.data_root, "train", max_boxes=args.max_boxes)
        val = load_coco_arrays(args.data_root, "val", max_boxes=args.max_boxes)
        if int(train[2].max()) >= args.num_classes:
            raise ValueError(f"{args.data_root} has labels up to {int(train[2].max())}; "
                             f"--num-classes {args.num_classes} must cover them")
    else:
        n_val = max(args.synthetic // 4, 4)
        train = synthetic_arrays(args.synthetic, image_size, args.max_boxes, args.num_classes,
                                 args.seed)
        val = synthetic_arrays(n_val, image_size, args.max_boxes, args.num_classes,
                               args.seed + 1)
    data = put_device_data(*train, device=device)
    val_data = put_device_data(*val, device=device)
    print(f"dataset resident on {device} ({train[0].nbytes / 1e9:.2f} GB, "
          f"{len(train[0])} train / {len(val[0])} val images at {train[0].shape[1]}^2) "
          f"in {time.time() - t0:.1f}s", flush=True)

    model = HybridVisionSystem(num_classes=args.num_classes, monitor=True, device=device,
                               seed=args.seed, **(TINY if args.tiny else {}))
    cfg = TrainerConfig(
        num_classes=args.num_classes, learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps, total_steps=args.total_steps,
        ema_decay=args.ema_decay, max_boxes=args.max_boxes, cls_mode=args.cls_loss,
        cls_pos_weight=args.cls_pos_weight,
        checkpoint_dir=os.path.join(args.run_dir, "checkpoints"),
        checkpoint_every_steps=args.checkpoint_every_steps,
        metrics_log=os.path.join(args.run_dir, "steps.jsonl"))
    trainer = ManifoldConstrainedTrainer(model, cfg, device=device, seed=args.seed)
    trainer.init_state()
    print(f"model: {sum(p.numel() for p in model.parameters()):,} params", flush=True)
    if args.resume:
        trainer.load_checkpoint(args.resume)
        print(f"resumed from {args.resume} at step {trainer.state.step}", flush=True)

    t_run = time.time()
    with open(os.path.join(args.run_dir, "chunks.jsonl"), "a", buffering=1) as fh:
        def progress(row):
            row["wall_s"] = time.time() - t_run
            fh.write(json.dumps(row) + "\n")
            if row["chunk"] % 10 == 0:
                print(f"step {row['step']} @{row['out_size']} loss={row['loss']:.3f} "
                      f"ds={row.get('ds_error_max')} sps={row['steps_per_sec']:.2f} "
                      f"val={row.get('val_loss')}", flush=True)

        result = trainer.train_chunked(
            data, total_steps=args.total_steps - trainer.state.step, out_sizes=sizes,
            batch_sizes=batch_sizes, chunk_steps=args.chunk_steps, val_data=val_data,
            val_out_size=max(sizes), val_batch_size=4, val_every_chunks=args.val_every_chunks,
            eig_every_chunks=args.eig_every_chunks, progress_fn=progress)
    trainer.save_checkpoint("final")
    trainer.close()
    trainer.monitor.save_report(os.path.join(args.run_dir, "stability_report.json"))
    summary = {"steps": trainer.state.step, "steps_per_sec": result["steps_per_sec"],
               "best_val_loss": result["best_val_loss"],
               "wall_hours": (time.time() - t_run) / 3600}
    print(json.dumps(summary), flush=True)
    return trainer, summary


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    return run(parse_args(argv))[1]


if __name__ == "__main__":
    main()
