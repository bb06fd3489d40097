"""Multi-task training run: the detection, segmentation and depth heads
trained jointly on dense data held in device memory.

Counterpart of ``scripts/train_multitask.py``, with its flags and defaults
(320², batch 8, 8 classes, lr 1e-3 with 200 warm-up steps and a cosine to
``--steps``, chunks of 100 steps, 16 boxes per image, seed 0, ``--tiny``
for the tiny model): the flagship with ``use_segmentation`` and
``use_depth``, built for task "multi_task", trained by ``MultiTaskChunk``
(one CUDA graph per chunk step, one metrics pull per chunk) with the
optimizer of the script's ``make_optimizer(schedule)``, and evaluated
before and after by ``MultiTaskEval``. The data is the dense shapes dataset
under ``--data-root`` (masks and depth maps beside the images; generated
there with ``--num-train`` / ``--num-val`` images at ``--size`` and
``--seed`` when it is absent, as the script does), read by
``load_coco_arrays(dense=True)``; or with ``--synthetic N`` N seeded images
and ``--num-val`` more, with dense labels in the shapes generator's
format. Runs on the CUDA card unless ``--device cpu`` is given:

    python -m hvs_tpu_torch.train_multitask --data-root data/shapes_mt --steps 2000
    python -m hvs_tpu_torch.train_multitask --synthetic 800 --steps 2000
    python -m hvs_tpu_torch.train_multitask --synthetic 8 --tiny --device cpu \\
        --steps 4 --chunk-steps 2

Writes the script's JSON report (``before``, ``after``, ``steps_per_sec``,
``params``, ...) to ``--output`` and prints its ``after``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import TYPE_CHECKING, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:
    from .config import ModelConfig
    from .training import ManifoldConstrainedTrainer, MultiTaskChunk, MultiTaskEval

NUM_CLASSES = 8  # the shapes benchmark's classes


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Multi-task training run (PyTorch/CUDA port)")
    p.add_argument("--data-root", default="data/shapes_mt",
                   help="dense shapes dataset (generated there when absent)")
    p.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="train on N seeded synthetic dense images instead of --data-root")
    p.add_argument("--num-train", type=int, default=800,
                   help="train images when the dataset is generated")
    p.add_argument("--num-val", type=int, default=100)
    p.add_argument("--size", type=int, default=320)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--chunk-steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--max-boxes", type=int, default=16)
    p.add_argument("--output", default="runs/multitask_report.json")
    p.add_argument("--tiny", action="store_true", help="the tiny model (smoke runs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def synthetic_dense_arrays(n: int, size: int, max_boxes: int, num_classes: int, seed: int):
    """``n`` seeded images with 1..max_boxes boxes each (``train_device``'s
    ``synthetic_arrays``) and their dense labels, in the format of the shapes
    generator (``generate_image(with_dense=True)``): ``seg`` [n, size, size]
    uint8 class id + 1 (0 the background) and ``depth`` [n, size, size]
    float32 metres (the background at 10 m). Each box is painted as a filled
    rectangle in its class's colour, in slot order (a later box covers an
    earlier one), at the distance 1 / (its longer side as a fraction of the
    image) metres, clipped to [0.5, 9.5]."""
    from .train_device import synthetic_arrays

    images, boxes, labels, mask = synthetic_arrays(n, size, max_boxes, num_classes, seed)
    palette = np.random.default_rng(seed + 1).integers(0, 256, (num_classes, 3), dtype=np.uint8)
    seg = np.zeros((n, size, size), np.uint8)
    depth = np.full((n, size, size), 10.0, np.float32)
    for i in range(n):
        for j in np.flatnonzero(mask[i]):
            cx, cy, w, h = boxes[i, j]
            x0, x1 = int(round((cx - w / 2) * size)), int(round((cx + w / 2) * size))
            y0, y1 = int(round((cy - h / 2) * size)), int(round((cy + h / 2) * size))
            images[i, y0:y1, x0:x1] = palette[labels[i, j]]
            seg[i, y0:y1, x0:x1] = labels[i, j] + 1
            depth[i, y0:y1, x0:x1] = np.clip(1.0 / max(w, h), 0.5, 9.5)
    return images, boxes, labels, mask, seg, depth


def model_config(tiny: bool, device) -> "ModelConfig":
    """The script's model config: 8 classes and both dense heads, the tiny
    widths with ``--tiny``."""
    from .config import ModelConfig

    cfg = ModelConfig(device=device.type)
    cfg.detection.num_classes = NUM_CLASSES
    cfg.use_segmentation = True
    cfg.use_depth = True
    if tiny:
        cfg.backbone.base_channels = 8
        cfg.backbone.stage_channels = (16, 24, 32, 40)
        cfg.backbone.stage_blocks = (1, 1, 1, 1)
        cfg.vit.dim, cfg.vit.depth, cfg.vit.num_heads = 16, 1, 2
        cfg.fusion.fpn_channels = 16
        cfg.fusion.out_channels = (16, 24, 32)
        cfg.detection.head_channels = 16
        cfg.mhc.sinkhorn_iterations = 3
    return cfg


class MultiTaskRun(NamedTuple):
    """What ``prepare`` sets up."""

    trainer: "ManifoldConstrainedTrainer"
    chunk: "MultiTaskChunk"
    evaluator: "MultiTaskEval"
    params: int  # the model's parameter count


def prepare(args: argparse.Namespace) -> MultiTaskRun:
    """The run's set-up: the dense train and validation data resident on the
    device (the dataset generated first when absent), the model built for
    task "multi_task", the trainer with the script's optimizer, the captured
    train step and the captured evaluation (one memory pool for both
    graphs)."""
    import torch

    from .data import load_coco_arrays, put_dense_data
    from .device import pin_matmul_precision, resolve_device
    from .training import ManifoldConstrainedTrainer, MultiTaskChunk, MultiTaskEval, \
        TrainerConfig

    device = resolve_device(args.device)
    pin_matmul_precision()
    if args.synthetic is None:
        if not os.path.exists(os.path.join(args.data_root, "annotations",
                                           "instances_train.json")):
            from .data.shapes import generate_dataset

            print("generating dense dataset...", flush=True)
            generate_dataset(args.data_root, num_train=args.num_train, num_val=args.num_val,
                             size=args.size, seed=args.seed, with_dense=True)
        t0 = time.time()
        train_arrays = load_coco_arrays(args.data_root, "train", args.max_boxes, dense=True)
        val_arrays = load_coco_arrays(args.data_root, "val", args.max_boxes, dense=True)
    else:
        t0 = time.time()
        train_arrays = synthetic_dense_arrays(args.synthetic, args.size, args.max_boxes,
                                              NUM_CLASSES, args.seed)
        val_arrays = synthetic_dense_arrays(args.num_val, args.size, args.max_boxes,
                                            NUM_CLASSES, args.seed + 1)
    train = put_dense_data(*train_arrays, device=device)
    val = put_dense_data(*val_arrays, device=device)
    print(f"dense data resident on {device}: {len(train_arrays[0])}+{len(val_arrays[0])} "
          f"images at {train_arrays[0].shape[1]}^2 in {time.time() - t0:.1f}s", flush=True)

    model = model_config(args.tiny, device).build_model(monitor=False, device=device,
                                                        seed=args.seed, task="multi_task")
    cfg = TrainerConfig(num_classes=NUM_CLASSES, learning_rate=args.learning_rate,
                        warmup_steps=200, total_steps=args.steps)
    trainer = ManifoldConstrainedTrainer(model, cfg, device=device, seed=args.seed)
    trainer.init_state()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"multi-task model: {n_params:,} params", flush=True)
    pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
    return MultiTaskRun(trainer, MultiTaskChunk(trainer, train, args.batch_size, args.chunk_steps,
                                                pool=pool),
                        MultiTaskEval(trainer, val, args.batch_size, pool=pool), n_params)


def run(args: argparse.Namespace) -> Tuple[MultiTaskRun, Dict[str, object]]:
    """The whole run of ``main``; returns what ``prepare`` set up and the
    report that ``main`` writes."""
    import torch

    prepared = prepare(args)
    trainer, chunk, evaluator, n_params = prepared
    before, _ = evaluator.run()
    print("before:", before, flush=True)
    t_run = time.time()
    for ci in range(args.steps // args.chunk_steps):
        host = chunk.run()
        trainer.state.step += args.chunk_steps
        if ci % 5 == 0:
            print(f"chunk {ci}: loss={float(np.mean(host['loss'])):.3f} "
                  f"seg={float(np.mean(host['segmentation_loss'])):.3f} "
                  f"depth={float(np.mean(host['depth_loss'])):.3f} "
                  f"sps={(ci + 1) * args.chunk_steps / (time.time() - t_run):.1f}", flush=True)
    after, iou_after = evaluator.run()
    print("after:", after, flush=True)

    report = {
        "steps": args.steps,
        "image_size": args.size,
        "train_images": int(chunk.data.images.shape[0]),
        "params": n_params,
        "steps_per_sec": args.steps / (time.time() - t_run),
        "device": (torch.cuda.get_device_name(trainer.device)
                   if trainer.device.type == "cuda" else "cpu"),
        "before": before,
        "after": {**after, "seg_iou_per_class": [float(x) for x in iou_after]},
        "note": ("joint detection+segmentation+depth via multi_task_loss on "
                 + ("seeded synthetic dense data (--synthetic)" if args.synthetic is not None
                    else f"the dense shapes dataset {args.data_root}")
                 + ", the PyTorch/CUDA port"),
    }
    if os.path.dirname(args.output):
        os.makedirs(os.path.dirname(args.output), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report["after"], indent=2), flush=True)
    return prepared, report


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    return run(parse_args(argv))[1]


if __name__ == "__main__":
    main()
