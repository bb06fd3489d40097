"""Roofline and stage times of the train step, on the card.

Counterpart of ``scripts/train_roofline.py``. The flagship training model
(``ModelConfig().build_model(monitor=True)``, 80 classes) and
``ManifoldConstrainedTrainer`` on up to 512 train images of ``--data-root``
in card memory; at each resolution (416² batch 16, 640² batch 8) four
nested programs, each captured as one CUDA graph on its own and timed by
replay (``utils/perf.py``), each counted once, eagerly
(``ModelProfiler.cost_analysis``):

  * ``augment``: one batch drawn and augmented on the card
    (``data/device_pipeline.py``: ``draw_augment`` then ``apply_augment``);
  * ``forward_loss``: the train-mode forward (dropout on, telemetry on), the
    detection loss plus ``manifold_reg_alpha`` times the manifold
    regulariser, on one augmented batch held fixed;
  * ``forward_backward``: that and autograd's gradients of every parameter;
  * ``full_step``: ``training/trainer.py::step_on_device`` (the gradients, the
    manifold-aware optimizer and the EMA), its state carried from replay to
    replay.

Stage costs are the differences. Kernel B runs in each program but
``augment``: 15 forward launches per step (the model's grouped projection
and the regulariser's), 10 backward in ``forward_backward`` and
``full_step``; its bytes and transcendentals are in the count. Then the
steps per second of ``train_chunked`` (one captured step per chunk of
``--chunk-warmup`` steps, replayed; the first chunk untimed, then
``--chunked-steps`` timed, from the end of the first chunk to the end of
the last; JAX's 50 and 200).

Keys as the JAX script's, renamed by the table in ``utils/perf.py``
(``mxu_utilization`` → ``mfu``, bound "MXU" → "compute (tensor cores)",
"HBM" → "HBM bandwidth"). Runs on the card unless ``--device cpu``; raises
without one::

    python -m hvs_tpu_torch.make_shapes_dataset --root data/shapes80_640 --num-classes 80 \\
        --size 640 --train 512 --val 0
    python -m hvs_tpu_torch.train_roofline --data-root data/shapes80_640
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from .utils import perf


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Train-step roofline (PyTorch/CUDA port)")
    p.add_argument("--data-root", default="data/shapes80_640")
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--resolutions", default="416,640")
    p.add_argument("--batch-416", type=int, default=16)
    p.add_argument("--batch-640", type=int, default=8)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--max-boxes", type=int, default=16)
    p.add_argument("--chunk-warmup", type=int, default=50,
                   help="steps of the untimed first chunk (the chunk size)")
    p.add_argument("--chunked-steps", type=int, default=200,
                   help="steps timed after it (a multiple of --chunk-warmup)")
    p.add_argument("--output", default=f"{perf.OUTPUT_DIR}/train_roofline.json")
    perf.add_args(p)
    return p.parse_args(argv)


def training_model(num_classes: int, device: torch.device, tiny: bool, seed: int = 0):
    """The flagship training model (``build_model(monitor=True)``), tiny
    widths with ``tiny``."""
    from .config import InferenceConfig, ModelConfig
    from .export_model import tiny_configs

    mcfg = ModelConfig(device=device.type)
    mcfg.detection.num_classes = num_classes
    if tiny:
        tiny_configs(mcfg, InferenceConfig(device=device.type), 64)
    return mcfg.build_model(monitor=True, device=device, seed=seed)


def programs(trainer, batch: Dict[str, torch.Tensor]):
    """The functions of ``forward_loss``, ``forward_backward`` and
    ``full_step`` on ``batch``."""
    from .training.losses import manifold_regularization_loss
    from .training.trainer import _targets, prepare_images, step_on_device, task_loss

    model, cfg = trainer.model, trainer.config
    params = dict(model.named_parameters())

    def forward_loss():
        model.train()
        images = prepare_images(batch["images"])
        targets = _targets(cfg, images, batch)
        loss, _ = task_loss(cfg, "detection", model(images), batch, targets)
        reg, _ = manifold_regularization_loss(params, sk_iters=cfg.sk_iters)
        return loss + cfg.manifold_reg_alpha * reg

    def forward_backward():
        loss = forward_loss()
        return loss, torch.autograd.grad(loss, list(params.values()), materialize_grads=True)

    def full_step():
        return step_on_device(model, trainer.tx, cfg, batch, trainer.lr_scale_t,
                              trainer.state.ema_params)[0]

    return {"forward_loss": forward_loss, "forward_backward": forward_backward,
            "full_step": full_step}


def run(args: argparse.Namespace) -> Tuple[Dict, Dict[str, int]]:
    from .data.device_pipeline import (AugmentConfig, apply_augment, draw_augment,
                                       load_coco_arrays, put_device_data)
    from .device import resolve_device
    from .training import ManifoldConstrainedTrainer, TrainerConfig

    device = resolve_device(args.device)
    pk = perf.peaks(args, device)
    if args.chunked_steps % args.chunk_warmup:
        raise ValueError("--chunked-steps must be a multiple of --chunk-warmup")
    launches = perf.Launches()
    data = put_device_data(*load_coco_arrays(args.data_root, "train", max_boxes=args.max_boxes,
                                             limit=512), device=device)
    model = training_model(args.num_classes, device, args.tiny)
    cfg = TrainerConfig(num_classes=args.num_classes, max_boxes=args.max_boxes)
    trainer = ManifoldConstrainedTrainer(model, cfg, device=device)
    trainer.init_state()
    sizes = tuple(int(s) for s in args.resolutions.split(","))
    batch_for = {416: args.batch_416, 640: args.batch_640}
    ridge = perf.ridge(pk)
    report = {
        "peaks": {**pk, "ridge_intensity_flops_per_byte": ridge},
        "model": f"flagship HybridVisionSystem num_classes={args.num_classes}"
                 + (" (tiny widths)" if args.tiny else ""),
        "resolutions": {},
    }
    aug = AugmentConfig()
    n = int(data.images.shape[0])

    def prog(flops: float, nbytes: float, wall: float) -> Dict:
        u = perf.utilization(flops, nbytes, wall, pk)
        return {"ms": wall * 1e3, "tflops_achieved": u["tflops"], "mfu": u["mfu"],
                "gbps_achieved": u["gbps"], "hbm_utilization": u["hbm_utilization"],
                "intensity_flops_per_byte": u["intensity"],
                "bound": perf.HBM_BOUND if u["intensity"] < ridge else perf.COMPUTE_BOUND}

    for s0 in sizes:
        b = batch_for.get(s0, 8)
        gen = torch.Generator(device=device).manual_seed(1)

        def augment():
            return apply_augment(data, draw_augment(gen, b, n, aug, device), s0, aug)

        counted = perf.cost(augment)
        p_aug = perf.Program(augment, device, generator=gen)
        wall_a = p_aug.seconds(args.iters * 2)
        launches.add(p_aug)
        batch = {k: v.clone() for k, v in augment().items()}
        del p_aug
        row = {"augment": {"ms": wall_a * 1e3, "gflops": counted["flops"] / 1e9,
                           "gbytes": counted["bytes accessed"] / 1e9}}
        walls = {}
        for name, fn in programs(trainer, batch).items():
            counted = perf.cost(fn)
            p = perf.Program(fn, device, generator=trainer.generator)
            walls[name] = p.seconds(args.iters)
            launches.add(p)
            row[name] = prog(counted["flops"], counted["bytes accessed"], walls[name])
            row[name]["transcendentals"] = counted["transcendentals"]
            row[name]["kernel_launches"] = p.launches
            del p
        wall_f, wall_g, wall_s = (walls[k] for k in ("forward_loss", "forward_backward",
                                                      "full_step"))
        row["stage_deltas_ms"] = {"forward": wall_f * 1e3, "backward": (wall_g - wall_f) * 1e3,
                                  "optimizer_ema": (wall_s - wall_g) * 1e3,
                                  "augment": wall_a * 1e3}
        row["batch"] = b
        row["steps_per_sec_single_step"] = 1.0 / wall_s
        report["resolutions"][str(s0)] = row
        print(s0, json.dumps(row), flush=True)

    # Chunk-level steps/s: the captured loop the real run uses; the first
    # chunk untimed, then the timed chunks, each ending in its one pull.
    report["chunked_steps_per_sec"] = {}
    for s0 in sizes:
        b = batch_for.get(s0, 8)
        ends = []
        trainer.train_chunked(data, total_steps=args.chunk_warmup + args.chunked_steps,
                              out_sizes=(s0,), batch_sizes={s0: b},
                              chunk_steps=args.chunk_warmup, aug=aug,
                              progress_fn=lambda _: ends.append(time.perf_counter()))
        launches.add(trainer.chunks[s0])
        report["chunked_steps_per_sec"][str(s0)] = args.chunked_steps / (ends[-1] - ends[0])
    return report, launches.total()


def main(argv: Optional[Sequence[str]] = None) -> Tuple[Dict, Dict[str, int]]:
    args = parse_args(argv)
    report, launches = run(args)
    perf.write(report, args.output)
    print(json.dumps({"kernel_launches": launches}), file=sys.stderr, flush=True)
    print(json.dumps({"output": args.output, **{
        k: v["full_step"]["bound"] for k, v in report["resolutions"].items()}}))
    return report, launches


if __name__ == "__main__":
    main()
