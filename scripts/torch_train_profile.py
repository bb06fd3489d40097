"""Where the time of the port's training step goes, on one CUDA card.

    python3 scripts/torch_train_profile.py [--batch 8] [--image 416] [--iters 3] [--trace out.json]
    python3 scripts/torch_train_profile.py --chunked [--batch 16] [--image 416] [--iters 10]
    python3 scripts/torch_train_profile.py --multitask [--batch 8] [--image 320] [--iters 10]
    python3 scripts/torch_train_profile.py --manifold-attention [--batch 16] [--image 640]

Builds the full-width flagship ``HybridVisionSystem`` (telemetry on, the JAX
dropout rates, bf16, 8 classes), trains it with ``ManifoldConstrainedTrainer``
on the synthetic batches of ``hvs_tpu_torch.train`` and runs
``torch.profiler`` over ``--iters`` train steps and then ``--iters``
validation batches, after a warm-up. With ``--chunked`` the steps are
instead replays of ``train_chunked``'s captured step (``TrainChunk``:
sampling and augmentation on the card from at least 64 synthetic 640²
images in card memory), then of its captured validation batch
(``ValChunk``). With ``--multitask`` they are replays of the multi-task
run's captured step and evaluation batch (``python -m
hvs_tpu_torch.train_multitask``'s set-up: the flagship with both dense
heads, 8 classes, synthetic dense images in card memory). With
``--manifold-attention`` they are eager train steps of
``HybridVisionEncoder(use_manifold_attention=True)`` at the flagship's ViT
widths on the scale_large map of an ``--image``² batch (``chip_smoke.py``'s
phase ``manifold_attention``: the manifold regulariser and
``ManifoldAwareOptimizer``), and no validation. Prints, for
each, the JSON lines of ``torch_serve_profile.py`` (wall and device ms,
idle share, device ms by kernel category, top kernels) beside the card's
name and power limit. Exits non-zero without a CUDA card.
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
    ap.add_argument("--chunked", action="store_true",
                    help="profile replays of train_chunked's captured step")
    ap.add_argument("--multitask", action="store_true",
                    help="profile replays of the multi-task run's captured step")
    ap.add_argument("--manifold-attention", action="store_true",
                    help="profile eager train steps of the manifold-attention encoder")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    if args.manifold_attention:
        profile_manifold_attention(args, card)
        return
    if args.multitask:
        from hvs_tpu_torch.train_multitask import parse_args, prepare

        n = max(64, args.batch * args.iters)
        run = prepare(parse_args(["--synthetic", str(n), "--num-val", str(n),
                                  "--size", str(args.image), "--batch-size", str(args.batch),
                                  "--chunk-steps", str(args.iters)]))
        profile_graphs(run.chunk, run.evaluator, args, card, "multitask")
        return

    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.train import make_synthetic_loader
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig, eval_step
    from hvs_tpu_torch.training.trainer import batch_to

    classes, warmup = 8, 3
    trainer = ManifoldConstrainedTrainer(HybridVisionSystem(num_classes=classes, monitor=True),
                                         TrainerConfig(num_classes=classes, backbone_lr_factor=0.1))
    trainer.init_state()
    if args.chunked:
        profile_chunked(trainer, args, card)
        return
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


def profile_manifold_attention(args, card: str) -> None:
    """Eager train steps of the manifold-attention encoder (31 mHC layers):
    forward, the manifold regulariser, the backward and the optimizer
    (projection every 5 steps), after 3 warm-up steps."""
    from hvs_tpu_torch.device import pin_matmul_precision
    from hvs_tpu_torch.models import HybridVisionEncoder
    from hvs_tpu_torch.models.layers import init_weights
    from hvs_tpu_torch.training import ManifoldAwareOptimizer, manifold_regularization_loss

    pin_matmul_precision()
    enc = HybridVisionEncoder(512, 256, 6, 8, use_manifold_attention=True)
    init_weights(enc, 0)
    enc = enc.cuda().train()
    grid = args.image // 32
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = (args.batch, grid, grid, 512)
    feat = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
    target = torch.randn(shape, device="cuda", generator=g)
    params = dict(enc.named_parameters())
    tx = ManifoldAwareOptimizer(params, 1e-4, project_every=5)

    def step():
        loss = (enc(feat).float() - target).square().mean()
        reg, _ = manifold_regularization_loss(params)
        grads = torch.autograd.grad(loss + 0.01 * reg, list(params.values()))
        tx.step(dict(zip(params, grads)))

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)
    summarize(prof, args.iters, wall_ms, card,
              {"batch": args.batch, "image": args.image, "path": "manifold_attention_step"},
              "step")


def profile_chunked(trainer, args, card: str) -> None:
    """Replays of the captured train step and validation batch."""
    from hvs_tpu_torch.data import put_device_data
    from hvs_tpu_torch.train_device import synthetic_arrays
    from hvs_tpu_torch.training.chunk import TrainChunk, ValChunk

    n = max(64, args.batch * args.iters)  # validation reads each image once
    data = put_device_data(*synthetic_arrays(n, 640, 16, trainer.config.num_classes, seed=0))
    pool = torch.cuda.graph_pool_handle()
    chunk = TrainChunk(trainer, data, args.image, args.batch, args.iters, pool=pool)
    val = ValChunk(trainer, data, args.batch, args.image, args.iters, pool=pool)
    profile_graphs(chunk, val, args, card, "train_chunked")


def profile_graphs(chunk, val, args, card: str, name: str) -> None:
    """``args.iters`` replays of ``chunk``'s captured step, then of ``val``'s
    captured batch, each under the profiler after one replay outside it."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    head = {"batch": args.batch, "image": args.image}
    for graph_run in (chunk.replay, val.graph.replay):  # first replays, outside the profile
        chunk.pos.zero_()
        graph_run()
    torch.cuda.synchronize()
    for path, unit, replay in ((f"{name}_step", "step", chunk.replay),
                               (f"{name}_validation", "batch", val.graph.replay)):
        chunk.pos.zero_()
        val.start.zero_()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                replay()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
        if args.trace and unit == "step":
            prof.export_chrome_trace(args.trace)
        summarize(prof, args.iters, wall_ms, card,
                  {**head, "path": path, "capture_s": chunk.capture_s if unit == "step"
                   else val.capture_s}, unit)


if __name__ == "__main__":
    main()
