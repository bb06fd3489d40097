"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. device: the card's name and power limit (nvidia-smi), and the build of
     every kernel from the sources in the checkout (one nvcc per source, all
     started together);
  2. kernels: each kernel against its plain PyTorch version on the card, with
     times (CUDA events) beside the least time the card could take:
     A (serve mHC block) at the token counts of the 640² serve path at every
     engine bucket (batch 1, 2, 4, 8 and 16) and a ragged count; B (Sinkhorn,
     forward and backward) at the
     five widths of the flagship's mHC matrices, a ragged width, an uneven
     cluster split (384) and a width of the streamed kernels (640), with each
     launch's cluster size, then the 25-matrix mix of one train step through
     the grouped call (one launch per width); C (unfolded mHC block) at the 18 sites
     of the validation forwards (416² batch 8, 640² batch 4 and 320² batch
     8) and a ragged count; A and C
     with each launch's row tile, threads and grid, and their time over the
     18 sites beside the time recorded before their redesign;
  3. serve: the full-width flagship ``ProductionHybridVision`` (seeded random
     weights, bf16) served by ``Detector`` at 640², batch 16 and batch 1; the
     launch counters are zeroed just before the load (B once per matrix)
     and again before the forwards, and read just after;
  4. parity: the same weights with a well-conditioned H_res, one 320² image,
     the port on the card (kernels) against the port on the CPU (plain
     versions);
  5. engine: ``InferenceEngine`` with the flagship at 640², one CUDA graph
     per bucket of (1, 2, 4, 8, 16) on the letterboxed path and per bucket
     for 720x1280 raw frames (letterbox inside the graph): load and capture
     seconds, service ms per bucket, peak memory, device ms per bucket-16
     replay, ``infer_batch`` frames/s; graph against eager at buckets 1 and
     16; the registered path and an unregistered mix of shapes; the
     micro-batcher under 4 client threads with one hot swap mid-run (a probe
     frame's result is the old or the new weights', never a mixture, and
     after the swap the new weights', as a second engine built on them
     gives it); the
     stability report (kernel B on the card); A's launches as replays x 18;
  6. deployment: the deployment layer over the flagship at 640² (seeded
     weights, bf16; an engine with buckets (1, 4) and 720x1280 raw frames):
     8 single detects through ``deployment/service.py`` with the
     micro-batcher running, a batch of 4, and the ``ping``, ``get_status``
     and ``update_config`` commands (the graphs rebuilt, a probe frame
     reading the new threshold); the same over a live localhost REST server
     and gRPC server; every response against the engine's own result for
     its frame; ``ModelExporter``: ``torch.export`` of the serve function,
     the saved ``.pt2`` loaded and called (kernel A's counter rises by 18
     per call), consistent with the serve function at rtol 1e-3 / atol 1e-4,
     its ms per call against the engine's b1 replay; the gated repository
     (a version of seed-1 weights that passes the gates, one that fails
     them; the swap, refused for the failing one, against a fresh engine on
     the seed-1 weights); the health checks (device memory from
     ``torch.cuda.mem_get_info``);
  7. train: the full-width ``HybridVisionSystem`` (telemetry on, the JAX
     dropout rates, bf16) trained by ``ManifoldConstrainedTrainer.train`` on
     the synthetic batches of ``hvs_tpu_torch.train`` (416², batch 8, 8
     classes, 64 boxes) for a few steps with a projection inside, then
     validated over 2 batches; counters zeroed just before, read just after;
  8. train_chunked: the on-device loop (``train_chunked``) with
     ``train_device``'s defaults: the flagship at 80 classes, 512 seeded
     640² images (16 boxes each) in card memory, one captured train step
     per resolution (416² batch 16, 640² batch 8) replayed for 2 chunks of
     10 steps each, validation at 640² (kernel C at its 18 sites) after the
     last chunk; checks a replay against the eager step from one state,
     the card's sampler against ``apply_augment`` on the CPU, the
     projection step, each step's lr against the host schedule, the
     replays under sync debug mode "error" with one pull per chunk, and the
     launches per step; ms and device ms per step, capture s, peak memory
     per resolution, and one chunk at the ``train`` phase's configuration;
  9. train_parity: one train step, dropout off, the full-width model at 320²,
     batch 2: the card (kernels) against the CPU (plain versions);
 10. multitask: ``python -m hvs_tpu_torch.train_multitask``'s run at its
     defaults (the flagship with the segmentation and depth heads, 8
     classes, 320², batch 8) on 800 synthetic dense images: its set-up
     (data on the card, the captured step and evaluation), 2 chunks of 10
     captured steps and one captured validation pass over 100 images; ms
     and device ms per step, capture s, peak memory, the parameter count
     against the JAX model's; the launches per captured step (B 15 forward,
     10 backward) and per validation batch (B 5, C 18); a replay against
     the eager step from one state; the dense labels reaching the loss at
     the heads' stride; one multi-task step CUDA against CPU in fp32;
 11. lightweight: ``LightweightHybridVision`` with the serving flags served
     by ``Detector`` at 640², batch 16 and batch 1 (frames/s, ms/frame, 6
     kernel-A launches per forward at d = 128, B once per matrix at load),
     CUDA against CPU at 320²; kernel A at its 6 sites of both batches, and
     kernel B forward and backward at the bottleneck widths 24, 48, 96 and
     192 and over its 13 matrices in one grouped call, against their plain
     versions;
 12. data: the data and evaluation layer through its entry points: a shapes
     dataset generated at 640² (8 classes) and a dense one at 320², each
     split's JSON held against its files and an image regenerated alone;
     both decoded (``load_coco_arrays``) and uploaded, the card's tensors
     equal to the host arrays; ``train_device``, ``train`` (through
     ``COCODataModule``: the host loader's batches/s beside the eager step)
     and ``train_multitask`` trained from those files (B 15 + 10 per step,
     C 18 per validation batch); ``evaluate`` of the val split with the
     ``train_device`` checkpoint (A at 18 per replay, each image's
     detections equal to ``engine.infer`` of its frame, the evaluator's
     numbers equal to a recomputation, the ``--synthetic`` self-check at 1.0).
The package pins its matmul precision flags itself (fp32 accumulation;
``hvs_tpu_torch.device.pin_matmul_precision``): this script never pins
them. It puts back torch's own flags before each phase that goes through an
entry point (3-12) and fails unless they are pinned after it; the plain
versions of A and C sum their products in fp32 whatever the flags.
The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every kernel of the port with its measurements.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

import hvs_tpu_torch
from hvs_tpu_torch import build
from hvs_tpu_torch.ops import mhc_block as mhc_mod
from hvs_tpu_torch.ops import sinkhorn as sink_mod
from hvs_tpu_torch.ops.sinkhorn import sinkhorn_log
from hvs_tpu_torch.training.chunk import kernel_counts

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
SFU_PER_CLOCK = 16 * 132  # exponentials per clock: 16 per SM, 132 SMs
IMAGE = 640
SERVE_BATCH = 16
ENGINE_BUCKETS = (1, 2, 4, 8, 16)  # the engine phase's batch buckets
TRAIN_IMAGE, TRAIN_BATCH, TRAIN_CLASSES, TRAIN_BOXES = 416, 8, 8, 64
# The train_chunked phase: train_device's defaults (sizes and batches, 80
# classes, 16 boxes, EMA 0.999, validation batches of 4 at the largest
# size), 512 images at 640², 2 chunks of 10 steps per size.
CHUNK_BATCHES = {416: 16, 640: 8}
CHUNK_CLASSES, CHUNK_BOXES, CHUNK_IMAGES, CHUNK_VAL_IMAGES = 80, 16, 512, 16
CHUNK_STEPS, CHUNKS_PER_SIZE, CHUNK_VAL_BATCH = 10, 2, 4
CHUNK_PROJECT_EVERY = 15  # projection steps 15 and 30, inside chunks 2 and 3
SK_ITERS = 20
# Widths of the flagship's 25 mHC residual matrices (H_res_raw): backbone
# mids 32 x2, 64 x3, 128 x4, 256 x2; ViT 6 x 256 and the 512 fusion; FPN,
# head towers and the feature head at 256.
SINKHORN_MIX = [32] * 2 + [64] * 3 + [128] * 4 + [256] * 15 + [512]
KERNEL_SITES = 18  # mHC sites of the flagship that the fused blocks serve
# The multitask phase: ``python -m hvs_tpu_torch.train_multitask``'s defaults
# (the flagship with both dense heads, 8 classes, 320², batch 8, 16 boxes,
# 100 validation images) on 800 synthetic dense images, 2 chunks of 10
# captured steps, then one captured validation pass (12 batches).
MULTITASK_ARGS = ["--synthetic", "800", "--steps", "20", "--chunk-steps", "10"]
MULTITASK_IMAGE, MULTITASK_BATCH = 320, 8
MULTITASK_CHUNKS = 2
MULTITASK_CHECK_COUNT = 99  # the replay check's step: a projection step (every 100)
# The JAX model's parameter count for that configuration (jax.eval_shape of
# its init for task "multi_task"; tests/test_torch_multitask.py holds the
# port's tree, name by name and shape by shape, against it).
MULTITASK_PARAMS = 19_964_711
# LightweightHybridVision: kernel A serves its 3 FPN levels and 3 head
# towers (d = 128); its other mHC matrices are the bottlenecks at 24, 48 x2,
# 96 x2 and 192, the 128 FPN and head ones and the 256 feature head.
LIGHT_SITES = 6
LIGHT_WIDTHS = (24, 48, 96, 192)
LIGHT_MIX = [24] + [48] * 2 + [96] * 2 + [128] * 6 + [192] + [256]
# The data phase: the shapes benchmark at 640² (8 classes, seed 0) and its
# dense form at 320², generated, decoded, uploaded, trained from (train_device
# at 640² batch 8 for 2 chunks of 10; train for one epoch at 416² batch 8;
# train_multitask at 320² batch 8 for 2 chunks of 10) and evaluated at 640².
# Cut: 96 + 32 images at 640² and 32 + 16 at 320² (the reference's benchmark
# has 4,000 + 500), 20 steps per trainer, for the script's time limit.
DATA_IMAGE, DATA_CLASSES, DATA_BOXES, DATA_TRAIN, DATA_VAL = 640, 8, 16, 96, 32
DATA_DENSE_IMAGE, DATA_DENSE_TRAIN, DATA_DENSE_VAL = 320, 32, 16
DATA_CHUNKS, DATA_CHUNK_STEPS = 2, 10
DATA_TRAIN_IMAGE, DATA_TRAIN_BATCH = 416, 8
# Kernels A and C over their 18 sites before the tensor-core redesign, as
# recorded in PERF.md's kernel table (ms, NVIDIA H100 80GB HBM3, 700 W); a
# constant, not measured in this run.
RECORDED_BEFORE_REDESIGN_MS = {"mhc_block": 2.468, "mhc_block_unfolded": 1.084}

# Kernel-vs-plain criteria: the two compute the same roundings; they differ
# where fp32 accumulation order flips a bf16 rounding (the final LayerNorm can
# amplify such a flip) and by the kernel's hardware tanh in the GELU. Sound
# builds read corr >= 0.99998 and mean |diff| <= 1e-3 at every main-path
# shape; a build without the GELU reads corr 0.9922-0.9989 and mean |diff|
# 0.036-0.100 there (PERF.md), so the limits sit between the two, tighter
# than tests/test_pallas.py's 0.999 / 0.05.
KERNEL_MIN_CORR = 0.9999
KERNEL_MAX_MEAN_ABS = 5e-3

# End-to-end CUDA-vs-CPU criteria: both run bf16 through ~60 layers; cuDNN
# and the CPU's convolutions sum in different orders, so bf16 roundings flip
# and propagate. Statistical agreement on the raw head outputs, as for the
# kernel. A class score is sigmoid(obj)*sigmoid(cls), whose slope is at most
# 0.25 per logit, so logits that differ by a few bf16 ulps of their magnitude
# (~4: ulp 2^-6) move it by up to ~0.01; 0.02 allows two such logits.
E2E_MIN_CORR = 0.999
E2E_MAX_MEAN_ABS = 0.05
E2E_SCORE_ATOL = 0.02

# Kernel B against its plain version (both fp32, the same recurrences; the
# kernel's online log-sum-exp differs from torch.logsumexp by fp32 rounding
# only): P within 1e-6, row sums within 1e-5 of 1 (exact to fp32 after the
# final row update), the unrolled gradient within 1e-5 of its largest entry.
SINK_P_ATOL = 1e-6
SINK_ROW_ATOL = 1e-5
SINK_GRAD_RTOL = 1e-5

# One train step on the card against the CPU, from the same weights and
# batch. In fp32 (TF32 off) both sides compute the same function summed in
# other orders: loss and gradient norm within 1e-3, every H_res_raw gradient
# (kernel B's backward on the card) and the SGD partitions' update with
# cosine > 0.999. In bf16 (~60 layers, cuDNN against the CPU's convolutions,
# as in the serve parity) the loss within 2 % and the gradient norm within
# 5 %; the gradient reaching each H_res passes through the LayerNorms of
# near-constant rows (H_post ~ 1 at init), which amplify bf16 rounding, so
# each H_res_raw gradient has cosine > 0.8 to the CPU's (0.878 at the worst
# layer in the first run) and the SGD update > 0.9. In both, no parameter is
# apart by more than 2·lr (the most a sign flip of an Adam first step, ±lr per
# element, can move it) plus 1e-6.
TRAIN_PARITY = {
    "float32": {"loss_rtol": 1e-3, "grad_norm_rtol": 1e-3, "h_res_grad_min_cos": 0.999,
                "mhc_update_min_cos": 0.999},
    "bfloat16": {"loss_rtol": 0.02, "grad_norm_rtol": 0.05, "h_res_grad_min_cos": 0.8,
                 "mhc_update_min_cos": 0.9},
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# torch's process-wide matmul precision flags, which every entry point of
# the package pins off (``hvs_tpu_torch.device.pin_matmul_precision``).
PRECISION_FLAGS = ("cuda.matmul.allow_tf32", "cudnn.allow_tf32",
                   "cuda.matmul.allow_bf16_reduced_precision_reduction")


def _flag_owner(path: str):
    *parents, leaf = path.split(".")
    obj = torch.backends
    for p in parents:
        obj = getattr(obj, p)
    return obj, leaf


def read_flags() -> dict:
    return {path: bool(getattr(*_flag_owner(path))) for path in PRECISION_FLAGS}


def set_flags(values: dict) -> None:
    for path, value in values.items():
        setattr(*_flag_owner(path), value)


def entry_point_phase(phase, defaults: dict, *args):
    """Run one phase that goes through the package's entry points, starting
    from torch's own flags (``defaults``, read before any phase ran), and
    fail unless those entry points pinned the flags themselves: this script
    never pins them."""
    set_flags(defaults)
    result = phase(*args)
    flags = read_flags()
    if any(flags.values()):
        fail(f"{phase.__name__}: the entry points left the matmul precision flags {flags}")
    return result


def zero_counts() -> None:
    mhc_mod.launches = mhc_mod.launches_unfolded = 0
    sink_mod.launches_forward = sink_mod.launches_backward = 0


def time_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, replayed ``trials`` times between CUDA events; the median trial
    over ``reps``. The graph keeps the host's launch overhead out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(times))


def time_ms_eager(fn, reps: int = 10, trials: int = 3) -> float:
    """Device time of one call of ``fn`` launched eagerly (for work a CUDA
    graph cannot capture, such as an autograd backward): ``reps`` calls
    between CUDA events, median trial over ``reps``."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Kernel A: fused mHC block


def mhc_sites(batch: int, image: int = IMAGE):
    """(tokens, d) of the 18 kernel launches of one flagship forward: 11
    backbone bottlenecks (mid = channels/2), 3 FPN levels, 3 head towers and
    the ViT fusion, at strides 4/8/16/32."""
    g = lambda s: batch * (image // s) ** 2  # noqa: E731
    return ([(g(4), 32)] * 2 + [(g(8), 64)] * 3 + [(g(16), 128)] * 4 + [(g(32), 256)] * 2
            + [(g(8), 256), (g(16), 256), (g(32), 256)] * 2 + [(g(32), 512)])


def mhc_bound_ms(n: int, d: int):
    """Least time on the card: the larger of FLOPs over the bf16 peak and
    bytes (x and out once, four [d, d] bf16 matrices, six fp32 vectors) over
    the memory rate."""
    flops = 8.0 * n * d * d
    nbytes = 4.0 * n * d + 8.0 * d * d + 24.0 * d
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mhc_inputs(n: int, d: int, seed: int):
    """Seeded kernel inputs on the card. H_res is near-identity
    (sinkhorn(6·I + noise)); W1/W2 are lecun-scaled and H_post is scaled by
    1/sqrt(d), so the pre-LN2 signal is O(1) and not a near-constant row that
    LN2 would cancel into rounding noise."""
    r = np.random.default_rng(seed)
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    x = t(r.standard_normal((n, d)), bf)
    w1 = t(r.standard_normal((d, d)) / math.sqrt(d), bf)
    w2 = t(r.standard_normal((d, d)) / math.sqrt(d), bf)
    h_post = t(2.0 / (1.0 + np.exp(-0.1 * r.standard_normal((d, d)))) / math.sqrt(d), bf)
    h_res = sinkhorn_log(t(6.0 * np.eye(d) + r.standard_normal((d, d))), 20).to(bf)
    b1, b2 = t(0.01 * r.standard_normal(d)), t(0.01 * r.standard_normal(d))
    ln = [t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d)),
          t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d))]
    return x, (w1, b1, w2, b2, h_post, h_res.contiguous(), *ln)


def phase_kernels(card: str, shapes=None):
    """Kernel A against its plain version at every main-path shape: the 18
    sites of every engine bucket (which include the serve phase's batch 1
    and 16) and a ragged count (or at the (tokens, d) pairs of ``shapes``,
    to time a few quickly)."""
    if shapes is None:
        shapes = sorted(set().union(*(mhc_sites(b) for b in ENGINE_BUCKETS))
                        | {(1234, d) for d in mhc_mod.SUPPORTED_WIDTHS})
    per_shape = {}
    for n, d in shapes:
        x, args = mhc_inputs(n, d, seed=n * 7 + d)
        out = mhc_mod.mhc_block(x, *args)
        torch.cuda.synchronize()
        ref = mhc_mod.mhc_block_plain(x, *args)
        a = out.float().flatten().cpu().numpy()
        b = ref.float().flatten().cpu().numpy()
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            fail(f"mhc_block n={n} d={d}: non-finite output")
        corr = float(np.corrcoef(a, b)[0, 1])
        mean_abs = float(np.mean(np.abs(a - b)))
        max_abs = float(np.max(np.abs(a - b)))
        ms = time_ms(lambda: mhc_mod.mhc_block(x, *args))
        plain_ms = time_ms(lambda: mhc_mod.mhc_block_plain(x, *args))
        bound, bound_by = mhc_bound_ms(n, d)
        row = {"phase": "kernel", "kernel": "mhc_block", "n": n, "d": d,
               "tile": mhc_mod.launch_plan(n, d), "corr": corr,
               "mean_abs_err": mean_abs, "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
               "library_ms": None, "card": card}
        print(json.dumps(row), flush=True)
        if not (corr > KERNEL_MIN_CORR and mean_abs < KERNEL_MAX_MEAN_ABS):
            fail(f"mhc_block n={n} d={d} disagrees with its plain version: "
                 f"corr {corr} (need > {KERNEL_MIN_CORR}), mean |diff| {mean_abs} "
                 f"(need < {KERNEL_MAX_MEAN_ABS})")
        per_shape[(n, d)] = row
    print_total("mhc_block", per_shape, mhc_sites(SERVE_BATCH), card)
    return per_shape


def print_total(kernel: str, per_shape, sites, card: str) -> None:
    """Kernel time over the 18 sites of one forward, where every site was
    measured, beside the recorded time before the redesign."""
    if all(s in per_shape for s in sites):
        print(json.dumps({"phase": "kernel_total", "kernel": kernel, "sites": len(sites),
                          "ms": sum(per_shape[s]["ms"] for s in sites),
                          "recorded_before_redesign_ms": RECORDED_BEFORE_REDESIGN_MS[kernel],
                          "bound_ms": sum(per_shape[s]["bound_ms"] for s in sites),
                          "card": card}), flush=True)


def kernel_summary(per_shape, launches: int, lightweight: int, exported: int):
    """Kernel A over the 18 launches of one batch-16 forward, from phase 2;
    ``lightweight``: its launches serving ``LightweightHybridVision``;
    ``exported``: its launches from the calls of the loaded ``.pt2`` program;
    the error is the largest at any shape checked."""
    sites = mhc_sites(SERVE_BATCH)
    t_ops = sum(8.0 * n * d * d / PEAK_BF16_FLOPS * 1e3 for n, d in sites)
    t_bytes = sum((4.0 * n * d + 8.0 * d * d + 24.0 * d) / PEAK_BYTES * 1e3 for n, d in sites)
    return {
        "name": "mhc_block",
        "route": "cuda",
        "source": "hvs_tpu_torch/csrc/mhc_block.cu",
        "replaces": "hvs_tpu/ops/pallas/mhc_pallas.py:208",
        "launches": launches,
        "launches_lightweight": lightweight,
        "launches_exported_program": exported,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
        "ms": sum(per_shape[s]["ms"] for s in sites),
        "plain_ms": sum(per_shape[s]["plain_ms"] for s in sites),
        "bound_ms": sum(per_shape[s]["bound_ms"] for s in sites),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        # No single PyTorch call computes the fused block.
        "library_ms": None,
    }


# ---------------------------------------------------------------------------
# Serve path


def phase_serve(card: str, build=None, sites: int = KERNEL_SITES, name: str = "serve") -> int:
    """A model served by ``Detector`` at 640², batch 16 and batch 1: the
    flagship ``ProductionHybridVision``, or what ``build()`` returns with
    ``sites`` kernel-A sites. Counters are zeroed before the load (kernel B,
    one launch per mHC matrix) and again before the forwards. Returns kernel
    A's launches over this phase's forwards (``sites`` per forward)."""
    from hvs_tpu_torch.inference import Detector
    from hvs_tpu_torch.models import ProductionHybridVision
    from hvs_tpu_torch.models.layers import ManifoldHyperConnection

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    det = Detector(build() if build is not None else ProductionHybridVision(seed=0))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_launches = kernel_counts()
    mhc = [m for m in det.model.modules() if isinstance(m, ManifoldHyperConnection)]
    if load_launches["sinkhorn_forward"] != len(mhc) or sum(m.fused for m in mhc) != sites:
        fail(f"{name}: {load_launches['sinkhorn_forward']} kernel B launches at load for "
             f"{len(mhc)} mHC matrices; {sum(m.fused for m in mhc)} kernel A sites, "
             f"expected {sites}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch16 = torch.rand((SERVE_BATCH, IMAGE, IMAGE, 3), generator=gen, device="cuda")
    batch1 = batch16[:1].contiguous()
    iters16, iters1 = 20, 50

    zero_counts()
    forwards = 0
    for images in (batch16, batch1):
        boxes, scores, classes = det(images)
        torch.cuda.synchronize()
        forwards += 1
        b = images.shape[0]
        if (tuple(boxes.shape), tuple(scores.shape), tuple(classes.shape)) != \
                ((b, 100, 4), (b, 100), (b, 100)):
            fail(f"{name} output shapes {boxes.shape}, {scores.shape}, {classes.shape}")
        if classes.dtype != torch.int32 or not (torch.isfinite(boxes).all()
                                                and torch.isfinite(scores).all()):
            fail(f"{name} outputs are not finite or classes are not int32")
    t0 = time.perf_counter()
    for _ in range(iters16):
        det(batch16)
    torch.cuda.synchronize()
    fps = SERVE_BATCH * iters16 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(iters1):
        det(batch1)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / iters1 * 1e3
    forwards += iters16 + iters1
    launches = mhc_mod.launches
    if launches != sites * forwards:
        fail(f"{name}: mhc_block launched {launches} times over {forwards} forwards, expected "
             f"{sites} each")
    print(json.dumps({"phase": name, "image": IMAGE, "fps_batch16": fps,
                      "batch1_frame_ms": frame_ms, "forwards": forwards,
                      "mhc_block_launches": launches,
                      "mhc_block_site_widths": sorted(m.dim for m in mhc if m.fused),
                      "sinkhorn_launches_at_load": load_launches["sinkhorn_forward"],
                      "load_s": load_s, "params": sum(p.numel() for p in det.model.parameters()),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "card": card}), flush=True)
    return launches


def phase_parity(card: str, build=None, name: str = "parity") -> None:
    """Port on the card (kernels) against the port on the CPU (plain
    versions), same weights, one 320² image, bf16 on both: the flagship
    ``ProductionHybridVision``, or what ``build(seed)`` returns."""
    import copy

    from hvs_tpu_torch.inference import Detector
    from hvs_tpu_torch.models import ProductionHybridVision
    from hvs_tpu_torch.models.layers import ManifoldHyperConnection

    model = (build or ProductionHybridVision)(seed=1)
    r = np.random.default_rng(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ManifoldHyperConnection):
                d = m.dim
                m.H_res_raw.copy_(torch.from_numpy(
                    (6.0 * np.eye(d) + r.standard_normal((d, d))).astype(np.float32)))
    cpu_model = copy.deepcopy(model).to("cpu")
    gpu = Detector(model)
    cpu = Detector(cpu_model, device="cpu")
    image = r.uniform(size=(1, 320, 320, 3)).astype(np.float32)
    with torch.inference_mode():
        out_gpu = gpu.model(torch.from_numpy(image).cuda())["detection"]
        out_cpu = cpu.model(torch.from_numpy(image))["detection"]
    raw_g = torch.cat([out_gpu["raw"][k].float().flatten(0, 3).cpu() for k in out_gpu["raw"]])
    raw_c = torch.cat([out_cpu["raw"][k].float().flatten(0, 3) for k in out_cpu["raw"]])
    # Remove each output channel's mean (the -4.0 logit bias) so the
    # correlation measures the spatial signal, not the bias layout.
    mean = raw_c.mean(dim=0, keepdim=True)
    a, b = (raw_g - mean).flatten().numpy(), (raw_c - mean).flatten().numpy()
    corr = float(np.corrcoef(a, b)[0, 1])
    mean_abs = float(np.mean(np.abs(a - b)))
    sg = out_gpu["class_scores"].float().cpu().flatten().numpy()
    sc = out_cpu["class_scores"].float().flatten().numpy()
    score_corr = float(np.corrcoef(sg, sc)[0, 1])
    score_diff = float(np.max(np.abs(sg - sc)))
    finite = bool(np.isfinite(a).all() and np.isfinite(sg).all())
    print(json.dumps({"phase": name, "image": 320, "raw_corr": corr,
                      "raw_mean_abs_err": mean_abs, "raw_max_abs_err": float(np.max(np.abs(a - b))),
                      "raw_abs_mean": float(np.mean(np.abs(raw_c.numpy()))),
                      "class_scores_corr": score_corr, "class_scores_max_abs_err": score_diff,
                      "class_scores_max": float(sc.max()), "card": card}), flush=True)
    if not (finite and corr > E2E_MIN_CORR and mean_abs < E2E_MAX_MEAN_ABS
            and score_diff < E2E_SCORE_ATOL):
        fail(f"{name}: CUDA and CPU serve outputs disagree: raw corr {corr} "
             f"(need > {E2E_MIN_CORR}), "
             f"mean |diff| {mean_abs} (need < {E2E_MAX_MEAN_ABS}); class_scores max |diff| "
             f"{score_diff} (need < {E2E_SCORE_ATOL})")


# ---------------------------------------------------------------------------
# Serving engine


def conditioned_params(seed: int) -> dict:
    """Seeded flagship weights (the port's named parameters, on the card) with
    the prediction convs conditioned as in ``tests/test_torch_serve.py``:
    kernels x4, objectness bias 1, class biases N(0, 1). At plain random init
    no score reaches the 0.25 threshold and the engine checks would compare
    empty outputs."""
    from hvs_tpu_torch.config import ModelConfig

    model = ModelConfig().build_model(production=True, seed=seed)
    r = np.random.default_rng(seed)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    with torch.no_grad():
        for name, value in params.items():
            if ".predict." not in name:
                continue
            if name.endswith("kernel"):
                value.mul_(4.0)
            else:
                bias = value.view(3, -1)
                bias[:, 4] = 1.0
                bias[:, 5:] = torch.from_numpy(
                    r.standard_normal(tuple(bias[:, 5:].shape)).astype(np.float32)).cuda()
    return params


def packed_max_diff(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b)))


def check_detections(dets, shapes, where: str) -> int:
    """Finite Detections inside each image's pixel bounds; returns the count."""
    total = 0
    for det, (h, w) in zip(dets, shapes):
        if det.image_size != (h, w):
            fail(f"engine {where}: image_size {det.image_size}, expected {(h, w)}")
        b = det.boxes
        if not (np.isfinite(b).all() and np.isfinite(det.scores).all()):
            fail(f"engine {where}: non-finite detections")
        if len(b) and (b[:, [0, 2]].min() < 0 or b[:, [0, 2]].max() > w
                       or b[:, [1, 3]].min() < 0 or b[:, [1, 3]].max() > h):
            fail(f"engine {where}: boxes outside the {h}x{w} image")
        total += len(b)
    return total


# Graph replay against the eager serve function on the same input: the same
# kernels in the same order, so the two should be bitwise equal; the limit
# allows fp32 rounding where cuBLAS or cuDNN picks another algorithm inside a
# capture (boxes are normalized, scores in [0, 1], classes and counts exact).
ENGINE_GRAPH_ATOL = 1e-5


def phase_engine(card: str) -> None:
    """The serving engine at the flagship's published widths: one CUDA graph
    per bucket of (1, 2, 4, 8, 16) at 640², and per bucket for 720x1280 raw
    frames (letterbox inside the graph); graph against eager at buckets 1 and
    16; the registered and an unregistered mix of shapes; the micro-batcher
    under 4 client threads for ~5 s with one hot swap mid-run; the stability
    report (kernel B on the card)."""
    import threading

    from hvs_tpu_torch.config import InferenceConfig, ModelConfig
    from hvs_tpu_torch.inference import EngineOverloaded, InferenceEngine

    raw_hw = (720, 1280)
    cfg = InferenceConfig()
    cfg.preprocessing.image_size = IMAGE
    cfg.performance.batch_buckets = ENGINE_BUCKETS
    cfg.performance.warmup_raw_shapes = (raw_hw,)
    old_params, new_params = conditioned_params(0), conditioned_params(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    engine = InferenceEngine(ModelConfig(), cfg, variables={"params": old_params})
    b_per_load = sink_mod.launches_forward
    t0 = time.perf_counter()
    service = engine.warmup(cfg.performance.warmup_raw_shapes)
    capture_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    graphs = len(engine.replays)
    print(json.dumps({"phase": "engine_load", "load_s": engine.load_seconds,
                      "capture_s": capture_s, "graphs": graphs,
                      "service_ms": {str(b): t * 1e3 for b, t in service.items()},
                      "peak_mem_gb": peak_gb, "sinkhorn_launches_per_load": b_per_load,
                      "kernel_sites": engine.kernel_sites, "card": card}), flush=True)
    if graphs != 2 * len(cfg.performance.batch_buckets):
        fail(f"engine captured {graphs} graphs, expected one per bucket and path")
    if engine.kernel_sites != KERNEL_SITES:
        fail(f"engine model has {engine.kernel_sites} kernel sites, expected {KERNEL_SITES}")

    r = np.random.default_rng(0)
    frames = r.integers(0, 256, (SERVE_BATCH, *raw_hw, 3), dtype=np.uint8)
    # Graph against the eager serve function, buckets 1 and 16, both paths.
    for b in (1, SERVE_BATCH):
        for path in ("raw", "letterboxed"):
            entry = engine._serve_fn_raw(b, raw_hw) if path == "raw" else engine._serve_fn(b)
            with engine._serve_lock, torch.cuda.stream(engine._stream):
                if path == "raw":
                    entry.stage(list(frames[:b]), engine._stream)
                else:
                    engine._letterbox_into(entry.static_in, list(frames[:b]))
                out, done = entry.run(engine._stream)
                eager = entry.serve_eager(entry.static_in)
                torch.cuda.synchronize()
            g, e = out.numpy(), eager.cpu().numpy()
            diff = packed_max_diff(g, e)
            valid = int(g[:, 0, 6].sum())
            row = {"phase": "engine_graph_vs_eager", "bucket": b, "path": path,
                   "bitwise_equal": bool(np.array_equal(g, e)), "max_abs_diff": diff,
                   "limit": ENGINE_GRAPH_ATOL, "detections": valid, "card": card}
            print(json.dumps(row), flush=True)
            if not (np.isfinite(g).all() and diff <= ENGINE_GRAPH_ATOL
                    and np.array_equal(g[..., 5:7], e[..., 5:7])):
                fail(f"engine graph and eager serve disagree: {row}")
            if valid == 0:
                fail(f"engine bucket {b} {path}: no detections; the comparison is vacuous")

    # Device time per bucket-16 replay (CUDA events around 10 replays).
    device_ms = {}
    for path, entry in (("raw", engine._serve_fn_raw(SERVE_BATCH, raw_hw)),
                        ("letterboxed", engine._serve_fn(SERVE_BATCH))):
        with engine._serve_lock, torch.cuda.stream(engine._stream):
            times = []
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                z = torch.cuda.Event(enable_timing=True)
                a.record(engine._stream)
                for _ in range(10):
                    entry.graph.replay()
                z.record(engine._stream)
                z.synchronize()
                times.append(a.elapsed_time(z) / 10)
            entry.replays += 30
        device_ms[path] = float(np.median(times))

    # Registered path: infer_batch on 16 raw frames, 20 calls.
    dets = engine.infer_batch(list(frames))
    found = check_detections(dets, [raw_hw] * SERVE_BATCH, "registered path")
    t0 = time.perf_counter()
    for _ in range(20):
        engine.infer_batch(list(frames))
    fps = SERVE_BATCH * 20 / (time.perf_counter() - t0)
    # Unregistered mix: letterboxed eagerly on the card.
    mix = [r.integers(0, 256, (*hw, 3), dtype=np.uint8)
           for hw in ((480, 640), raw_hw, (300, 500), (1080, 1920))]
    dets = engine.infer_batch(mix)
    found_mix = check_detections(dets, [m.shape[:2] for m in mix], "unregistered mix")
    print(json.dumps({"phase": "engine_serve", "infer_batch_fps_16x720p": fps,
                      "device_ms_per_b16_replay": device_ms, "detections_16x720p": found,
                      "detections_mix": found_mix, "card": card}), flush=True)

    # Micro-batcher: 4 clients, ~5 s, one reload to other weights mid-run; a
    # probe thread serves one fixed frame throughout. The old weights' result
    # comes from this engine before the swap; the new weights' from a second
    # engine built on them (its own raw graph at bucket 1), so a swap that
    # left anything stale cannot pass for new.
    probe = frames[0]
    old_probe = engine.infer(probe)
    ref_engine = InferenceEngine(ModelConfig(), cfg, variables={"params": new_params})
    ref_engine.register_raw_shape(raw_hw, buckets=(1,))
    ref_probe = ref_engine.infer(probe)
    del ref_engine
    engine.metrics.reset()
    engine.start_batcher()
    stop = threading.Event()
    futures, rejected_at_client, probes = [], [0], []
    lock = threading.Lock()

    def client(seed: int) -> None:
        rr = np.random.default_rng(seed)
        period = 1.0 / 120.0  # each client offers 120 frames/s
        nxt = time.perf_counter()
        while not stop.is_set():
            try:
                fut = engine.submit(frames[rr.integers(SERVE_BATCH)])
                with lock:
                    futures.append(fut)
            except EngineOverloaded:
                with lock:
                    rejected_at_client[0] += 1
            nxt += period
            time.sleep(max(0.0, nxt - time.perf_counter()))

    def prober() -> None:
        while not stop.is_set():
            started = time.perf_counter()
            probes.append((started, engine.infer(probe)))
            time.sleep(0.02)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    threads.append(threading.Thread(target=prober))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(2.5)
    reload_t0 = time.perf_counter()
    engine.reload({"params": new_params})
    reload_end = time.perf_counter()
    reload_s = reload_end - reload_t0
    time.sleep(2.5)
    stop.set()
    for t in threads:
        t.join()
    results, failed = [], 0
    for fut in futures:
        try:
            results.append(fut.result(timeout=60))
        except EngineOverloaded:
            failed += 1
    elapsed = time.perf_counter() - t0
    stats = engine.get_performance_stats()
    engine.stop_batcher()
    new_probe = engine.infer(probe)
    lat = np.array([d.latency_ms for d in results]) if results else np.zeros(1)

    def same(a, b) -> bool:
        return (len(a) == len(b) and np.array_equal(a.classes, b.classes)
                and np.allclose(a.boxes, b.boxes, atol=1e-3) and np.allclose(a.scores, b.scores,
                                                                            atol=1e-5))

    n_old = sum(same(p, old_probe) for _, p in probes)
    n_new = sum(same(p, ref_probe) for _, p in probes)
    after = [p for started, p in probes if started > reload_end]
    row = {"phase": "engine_batcher", "clients": 4, "seconds": elapsed,
           "completed": len(results), "rejected": rejected_at_client[0],
           "shed": stats.get("batcher_shed"), "shed_futures": failed,
           "queue_capacity": stats.get("batcher_queue_capacity"),
           "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
           "p99_ms": float(np.percentile(lat, 99)), "fps": len(results) / elapsed,
           "reload_s": reload_s, "probes": len(probes), "probes_old": n_old,
           "probes_new": n_new, "probes_after_swap": len(after),
           "probes_after_swap_new": sum(same(p, ref_probe) for p in after),
           "reloaded_equals_fresh_engine": same(new_probe, ref_probe),
           "old_new_differ": not same(old_probe, ref_probe), "card": card}
    print(json.dumps(row), flush=True)
    if len(results) + failed != len(futures):
        fail(f"engine batcher: not every future ended: {row}")
    if not results or not after or n_old + n_new != len(probes) or not row["old_new_differ"] \
            or row["probes_after_swap_new"] != len(after) \
            or not row["reloaded_equals_fresh_engine"]:
        fail(f"engine batcher / hot swap: {row}")
    check_detections(results, [raw_hw] * len(results), "micro-batcher")

    replays = sum(engine.replays.values())
    report = engine.get_stability_report()
    print(json.dumps({"phase": "engine_stability", **report, "card": card}), flush=True)
    if not (report["num_mhc_layers"] == len(SINKHORN_MIX) and report["max_ds_error"] < 1e-3
            and report["eigenvalue_constraint_satisfied"]):
        fail(f"engine stability report: {report}")
    print(json.dumps({"phase": "engine_launches",
                      "graph_replays": {str(k): v for k, v in engine.replays.items()},
                      "replays": replays, "mhc_block_launches": replays * KERNEL_SITES,
                      "sinkhorn_launches_per_load": b_per_load, "card": card}), flush=True)


# ---------------------------------------------------------------------------
# Deployment layer

DEPLOY_BUCKETS = (1, 4)
DEPLOY_RAW_HW = (720, 1280)
DEPLOY_SINGLES = 8
DEPLOY_BATCH = 4
# The exported program against the serve function (JAX's consistency limits,
# hvs_tpu/deployment/model_server.py:139-163).
EXPORT_RTOL, EXPORT_ATOL = 1e-3, 1e-4
GATE_PASS = {"map_50": 0.9, "latency_ms": 8.0, "precision": 0.95, "recall": 0.9,
             "ds_error": 1e-4, "max_eigenvalue": 0.99}
GATE_FAIL = dict(GATE_PASS, map_50=0.4)


def same_detections(a, b, box_atol: float = 1e-3, score_atol: float = 1e-5) -> bool:
    """Two ``Detections`` (or response-shaped tuples) agree: same count and
    classes, boxes and scores within the limits (default: the engine phase's
    hot-swap check, for two runs of one graph)."""
    return (len(a) == len(b) and np.array_equal(a.classes, b.classes)
            and np.allclose(a.boxes, b.boxes, atol=box_atol)
            and np.allclose(a.scores, b.scores, atol=score_atol))


class _Response:
    """A REST or gRPC response's detections, shaped like ``Detections``."""

    def __init__(self, boxes, scores, classes, image_size):
        self.boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        self.scores = np.asarray(scores, np.float32)
        self.classes = np.asarray(classes, np.int64)
        self.image_size = tuple(image_size)

    def __len__(self) -> int:
        return len(self.scores)

    @classmethod
    def rest(cls, body: dict) -> "_Response":
        d = body["detections"]
        return cls([x["box"] for x in d], [x["score"] for x in d], [x["class_id"] for x in d],
                   body["image_size"])

    @classmethod
    def grpc(cls, resp) -> "_Response":
        d = resp.detections
        return cls([[x.x1, x.y1, x.x2, x.y2] for x in d], [x.score for x in d],
                   [x.class_id for x in d], (resp.image_height, resp.image_width))


def cross_bucket(a, b, threshold: float) -> dict:
    """Matches the detections of ``a`` and ``b`` greedily by class and IoU
    (>= 0.5): the largest score difference of a match, and the unmatched
    detections with their distance to ``threshold``."""
    def iou(p, q):
        w = max(0.0, min(p[2], q[2]) - max(p[0], q[0]))
        h = max(0.0, min(p[3], q[3]) - max(p[1], q[1]))
        inter = w * h
        union = (p[2] - p[0]) * (p[3] - p[1]) + (q[2] - q[0]) * (q[3] - q[1]) - inter
        return inter / union if union > 0 else 0.0

    free = list(range(len(b)))
    diffs, unmatched = [], []
    for i in range(len(a)):
        best, best_iou = None, 0.5
        for j in free:
            if a.classes[i] == b.classes[j] and iou(a.boxes[i], b.boxes[j]) >= best_iou:
                best, best_iou = j, iou(a.boxes[i], b.boxes[j])
        if best is None:
            unmatched.append(float(a.scores[i]))
        else:
            free.remove(best)
            diffs.append(abs(float(a.scores[i]) - float(b.scores[best])))
    unmatched += [float(b.scores[j]) for j in free]
    return {"matched": len(diffs), "max_score_diff": max(diffs, default=0.0),
            "unmatched": len(unmatched),
            "unmatched_max_from_threshold": max((abs(u - threshold) for u in unmatched),
                                                default=0.0)}


def _serve_rest(server):
    """Run an aiohttp app on 127.0.0.1 (a free port) on a background loop;
    returns (base url, stop)."""
    import asyncio
    import threading

    from aiohttp import web

    loop = asyncio.new_event_loop()
    runner = web.AppRunner(server.app)
    ready: list = []

    def run() -> None:
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, "127.0.0.1", 0)
            loop.run_until_complete(site.start())
            ready.append(site._server.sockets[0].getsockname()[1])
        except Exception as e:  # reported by the caller
            ready.append(e)
            return
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    for _ in range(6000):
        if ready:
            break
        time.sleep(0.05)
    if not ready or isinstance(ready[0], Exception):
        fail(f"deployment: the REST server did not start: {ready}")

    def stop() -> None:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        server.shutdown()

    return f"http://127.0.0.1:{ready[0]}", stop


def _post(url: str, payload: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            fail(f"deployment: {url} answered {resp.status}")
        return json.loads(resp.read())


def phase_deployment(card: str) -> dict:
    """The deployment layer over the flagship at 640² (seeded conditioned
    weights, bf16), an engine with buckets (1, 4) and 720x1280 raw frames:
    requests through ``deployment/service.py`` (single detects through the
    micro-batcher, a batch, the commands with a graph rebuild), the same
    over a live localhost REST server and gRPC server, each response against
    ``engine.infer`` of its frame; ``ModelExporter`` export, load and
    consistency, with kernel A's launches per call of the loaded program;
    the gated repository (a passing and a failing version, the swap, the
    swapped engine against a fresh one); the health checks."""
    import base64
    import os
    import shutil
    import tempfile

    import cv2

    from hvs_tpu_torch.config import InferenceConfig, ModelConfig
    from hvs_tpu_torch.deployment import (HealthChecker, ModelExporter, ModelServerManager,
                                          RegistryGate, RobotGRPCServer, RobotVisionClient,
                                          ServingModelConfig, VisionAPIServer)
    from hvs_tpu_torch.deployment import service
    from hvs_tpu_torch.inference import InferenceEngine
    from hvs_tpu_torch.inference.preprocessing import decode_jpeg

    cfg = InferenceConfig()
    cfg.preprocessing.image_size = IMAGE
    cfg.performance.batch_buckets = DEPLOY_BUCKETS
    cfg.performance.warmup_raw_shapes = (DEPLOY_RAW_HW,)
    t0 = time.perf_counter()
    engine = InferenceEngine(ModelConfig(), cfg, variables={"params": conditioned_params(0)})
    engine.warmup(cfg.performance.warmup_raw_shapes)
    setup_s = time.perf_counter() - t0
    r = np.random.default_rng(0)
    frames = list(r.integers(0, 256, (DEPLOY_SINGLES, *DEPLOY_RAW_HW, 3), dtype=np.uint8))
    direct = [engine.infer(f) for f in frames]
    if sum(len(d) for d in direct) == 0:
        fail("deployment: no detections on the frames; the comparisons are vacuous")

    # 1. Requests through the framework-free core.
    engine.start_batcher()
    service_ms, mismatched = [], []
    for i, frame in enumerate(frames):
        t1 = time.perf_counter()
        det = service.detect_sync(engine, frame)
        body = service.response_dict(det, str(i))
        service_ms.append((time.perf_counter() - t1) * 1e3)
        if not same_detections(_Response.rest(body), direct[i]) \
                or body["image_size"] != list(DEPLOY_RAW_HW):
            mismatched.append(f"single {i}")
    engine.stop_batcher()
    batch = frames[:DEPLOY_BATCH]
    t1 = time.perf_counter()
    bodies = service.batch_responses(engine, batch, [DEPLOY_RAW_HW] * DEPLOY_BATCH)
    batch_ms = (time.perf_counter() - t1) * 1e3
    as_batch = engine.infer_batch(batch)
    default_threshold = cfg.postprocessing.score_threshold
    batch_vs_single = []
    for i, body in enumerate(bodies):
        got = _Response.rest(body)
        if not same_detections(got, as_batch[i]):
            mismatched.append(f"batch {i} against infer_batch")
        # Printed, not held: bucket 4's graph is another computation than
        # bucket 1's (other cuDNN algorithms, other bf16 roundings), and with
        # these weights most scores saturate near 1, so the candidates that
        # reach the NMS differ between the two.
        batch_vs_single.append(cross_bucket(got, direct[i], default_threshold))
    core = service.DetectionService(engine)
    ping = core.command("ping", {})
    status = core.command("get_status", {})
    probe = frames[0]
    before = engine.infer(probe)
    # The new threshold: the probe's middle score (a value the card holds
    # exactly), so that about half of its detections must go.
    threshold = float(np.sort(before.scores)[len(before) // 2])
    update = core.command("update_config", {"score_threshold": repr(threshold)})
    rebuilt = engine.replays == {}
    t1 = time.perf_counter()
    after = engine.infer(probe)  # recaptures the bucket-1 raw graph
    recapture_s = time.perf_counter() - t1
    keep = before.scores >= threshold
    expected = _Response(before.boxes[keep], before.scores[keep], before.classes[keep],
                         before.image_size)
    threshold_ok = (rebuilt and same_detections(after, expected) and int((~keep).sum()) > 0
                    and (len(after) == 0 or float(after.scores.min()) >= threshold))
    core.command("update_config", {"score_threshold": repr(default_threshold)})
    engine.warmup(cfg.performance.warmup_raw_shapes)
    row = {"phase": "deployment_requests", "singles": DEPLOY_SINGLES, "batch": DEPLOY_BATCH,
           "detections": sum(len(d) for d in direct),
           "service_ms_p50": float(np.percentile(service_ms, 50)),
           "service_ms_max": float(np.max(service_ms)), "batch_ms": batch_ms,
           "batch_vs_single": batch_vs_single,
           "ping": ping["message"], "get_status_keys": len(status["data"]),
           "update_config": update["message"], "new_threshold": threshold,
           "graphs_dropped": rebuilt, "recapture_s": recapture_s,
           "probe_before": len(before), "probe_after": len(after),
           "threshold_applied": threshold_ok, "mismatched": mismatched,
           "engine_setup_s": setup_s, "card": card}
    print(json.dumps(row), flush=True)
    if mismatched or not threshold_ok or ping["message"] != "pong" or not status["success"]:
        fail(f"deployment requests: {row}")

    # The same requests over a live REST server and a live gRPC server.
    blobs = [cv2.imencode(".jpg", f)[1].tobytes() for f in frames]
    decoded = [decode_jpeg(b, IMAGE) for b in blobs]
    want = [engine.infer(d) for d in decoded]
    mismatched = []
    engine.start_batcher()
    url, stop_rest = _serve_rest(VisionAPIServer(engine))
    rest_ms = []
    try:
        for i, blob in enumerate(blobs):
            t1 = time.perf_counter()
            body = _post(url + "/detect", {"image_base64": base64.b64encode(blob).decode()})
            rest_ms.append((time.perf_counter() - t1) * 1e3)
            if not same_detections(_Response.rest(body), want[i]) \
                    or body["image_size"] != list(DEPLOY_RAW_HW):
                mismatched.append(f"rest {i}")
        body = _post(url + "/detect/batch", {"images_base64": [
            base64.b64encode(b).decode() for b in blobs[:DEPLOY_BATCH]]})
        as_batch = engine.infer_batch(decoded[:DEPLOY_BATCH])
        for i, res in enumerate(body["results"]):
            if not same_detections(_Response.rest(res), as_batch[i]):
                mismatched.append(f"rest batch {i}")
        import urllib.request

        with urllib.request.urlopen(url + "/health", timeout=60) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
            metrics_ok = b"hvs_requests_total" in resp.read()
    finally:
        stop_rest()
        engine.stop_batcher()
    grpc_server = RobotGRPCServer(engine, host="127.0.0.1", port=0)
    client = RobotVisionClient(f"127.0.0.1:{grpc_server.start()}")
    grpc_ms = []
    try:
        for i, blob in enumerate(blobs):
            t1 = time.perf_counter()
            resp = client.detect(blob, request_id=str(i))
            grpc_ms.append((time.perf_counter() - t1) * 1e3)
            if resp.error or resp.request_id != str(i) \
                    or not same_detections(_Response.grpc(resp), want[i]):
                mismatched.append(f"grpc {i}")
        streamed = list(client.detect_batch(iter(blobs[:DEPLOY_BATCH])))
        for i, resp in enumerate(streamed):
            if not same_detections(_Response.grpc(resp), want[i]):
                mismatched.append(f"grpc stream {i}")
        grpc_ping = client.command("ping").message
        grpc_status = client.command("get_status")
    finally:
        client.close()
        grpc_server.stop()
    row = {"phase": "deployment_servers", "rest_ms_p50": float(np.percentile(rest_ms, 50)),
           "rest_ms_max": float(np.max(rest_ms)), "grpc_ms_p50": float(np.percentile(grpc_ms, 50)),
           "grpc_ms_max": float(np.max(grpc_ms)), "rest_health": health["status"],
           "metrics": metrics_ok, "grpc_ping": grpc_ping,
           "grpc_requests_served": grpc_status.data.get("requests_served"),
           "mismatched": mismatched, "card": card}
    print(json.dumps(row), flush=True)
    if mismatched or health["status"] != "healthy" or not metrics_ok or grpc_ping != "pong" \
            or len(streamed) != DEPLOY_BATCH:
        fail(f"deployment servers: {row}")

    # 2. Export, load, consistency; kernel A's launches per call of the program.
    workdir = tempfile.mkdtemp(prefix="hvs_deploy_")
    try:
        exporter = ModelExporter(engine.model, IMAGE)
        path = os.path.join(workdir, "model.pt2")
        t1 = time.perf_counter()
        exporter.export_program(path, batch=1)
        export_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        program = exporter.load_program(path)
        load_s = time.perf_counter() - t1
        x = exporter.example_input(1)
        calls = 3
        zero_counts()
        with torch.no_grad():
            for _ in range(calls):
                program(x)
        torch.cuda.synchronize()
        program_launches = mhc_mod.launches
        with torch.no_grad():
            t1 = time.perf_counter()
            for _ in range(10):
                program(x)
            torch.cuda.synchronize()
        program_ms = (time.perf_counter() - t1) / 10 * 1e3
        entry = engine._serve_fn(1)
        with engine._serve_lock, torch.cuda.stream(engine._stream):
            entry.run(engine._stream)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(10):
                entry.run(engine._stream)
            torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t1) / 10 * 1e3
        report = exporter.consistency_check(path, rtol=EXPORT_RTOL, batch=1)
        with torch.no_grad():
            boxes, scores, classes = program(x)
        row = {"phase": "deployment_export", "export_s": export_s, "load_s": load_s,
               "pt2_mb": os.path.getsize(path) / 2**20, "program_ms_b1": program_ms,
               "engine_b1_replay_ms": replay_ms, "calls": calls,
               "mhc_block_launches": program_launches,
               "mhc_block_nodes": sum("hvs.mhc_block" in str(n.target)
                                      for n in program.graph.nodes),
               "valid_detections": int((scores >= 0).sum()), **report,
               "rtol": EXPORT_RTOL, "atol": EXPORT_ATOL, "card": card}
        print(json.dumps(row), flush=True)
        if program_launches != KERNEL_SITES * calls or not report["consistent"] \
                or tuple(boxes.shape) != (1, 100, 4) or classes.dtype != torch.int32:
            fail(f"deployment export: {row}")
        del program

        # 3. The gated repository: version 1 (seed-1 weights) passes the gate,
        # version 2 fails it; the swap against a fresh engine on the seed-1
        # weights (its own raw graph at bucket 1).
        ref_cfg = InferenceConfig()
        ref_cfg.preprocessing.image_size = IMAGE
        ref_cfg.performance.batch_buckets = (1,)
        ref_engine = InferenceEngine(ModelConfig(), ref_cfg,
                                     variables={"params": conditioned_params(1)})
        ref_engine.register_raw_shape(DEPLOY_RAW_HW, buckets=(1,))
        root = os.path.join(workdir, "repository")
        publisher = ModelServerManager(ref_engine, ServingModelConfig(image_size=IMAGE),
                                       RegistryGate())
        v1 = publisher.build_repository(root, 1, metrics=GATE_PASS)
        v2 = publisher.build_repository(root, 2, metrics=GATE_FAIL)
        ref_probe = ref_engine.infer(probe)
        del ref_engine, publisher
        manager = ModelServerManager(engine, ServingModelConfig(image_size=IMAGE), RegistryGate())
        old_probe = engine.infer(probe)
        zero_counts()
        t1 = time.perf_counter()
        loaded = manager.load_from_repository(root)
        torch.cuda.synchronize()
        swap_s = time.perf_counter() - t1
        b_launches = sink_mod.launches_forward
        try:
            manager.load_from_repository(root, version=2)
            refused = False
        except RuntimeError:
            refused = True
        new_probe = engine.infer(probe)
        row = {"phase": "deployment_repository", "v1_admitted": v1["admitted"],
               "v2_admitted": v2["admitted"], "v2_failures": v2["failures"],
               "loaded": loaded, "v2_refused": refused, "load_and_swap_s": swap_s,
               "sinkhorn_launches_per_reload": b_launches,
               "swapped_equals_fresh_engine": same_detections(new_probe, ref_probe),
               "old_new_differ": not same_detections(old_probe, ref_probe), "card": card}
        print(json.dumps(row), flush=True)
        if not (v1["admitted"] and not v2["admitted"] and loaded == 1 and refused
                and row["swapped_equals_fresh_engine"] and row["old_new_differ"]
                and b_launches == len(SINKHORN_MIX)):
            fail(f"deployment repository: {row}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 4. Health, over a fresh metrics window of steady-state requests (the
    # captures and recaptures above are not serving latency).
    engine.metrics.reset()
    for frame in frames:
        engine.infer(frame)
    checker = HealthChecker(engine)
    health = checker.run_checks()
    free, total = torch.cuda.mem_get_info(engine.device)
    device = next(c for c in checker.checkers[0].check() if c.name == "device")
    checks = {c["name"]: c["status"] for c in health["checks"]}
    row = {"phase": "deployment_health", "rollup": health["status"], "checks": health["checks"],
           "memory_fraction": device.data.get("memory_fraction"),
           "mem_get_info_fraction": 1.0 - free / total, "card": card}
    print(json.dumps(row), flush=True)
    if any(checks.get(n) != "healthy" for n in ("model_loaded", "device", "latency")) \
            or not math.isclose(device.data.get("memory_fraction", -1.0), 1.0 - free / total,
                                abs_tol=1e-3):
        fail(f"deployment health: {row}")
    return {"mhc_block_exported": program_launches, "sinkhorn_per_reload": b_launches}


# ---------------------------------------------------------------------------
# Kernel B: Sinkhorn forward and backward


def sinkhorn_logits(n: int, seed: int) -> torch.Tensor:
    """A residual matrix at the mHC init scale (uniform, variance scaling
    0.1 fan_avg) plus unit normal noise, so that the iterations have work."""
    r = np.random.default_rng(seed)
    limit = math.sqrt(3.0 * 0.1 / n)
    x = r.uniform(-limit, limit, (n, n)) + r.standard_normal((n, n))
    return torch.from_numpy(x.astype(np.float32)).cuda()


def sinkhorn_bounds_ms(widths, sm_clock_hz: float):
    """Least times of the [n, n] matrices of ``widths`` together, forward
    (with the history kept) and backward: the larger of the bytes (each input
    read once, each output written once) over the memory rate and the
    exponentials over the SFU rate of all 132 SMs."""
    k = SK_ITERS
    sfu = SFU_PER_CLOCK * sm_clock_hz
    out = {}
    for name, per_byte, exps_per in (("forward", 8.0, 2 * k + 2), ("backward", 16.0, 2 * k)):
        nbytes = sum(per_byte * n * n + 4.0 * 2 * (k + 1) * n for n in widths)
        exps = sum(exps_per * n * n for n in widths)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, exps / sfu * 1e3
        out[name] = (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_sinkhorn(card: str, sm_clock_hz: float):
    """Kernel B, forward and backward, against its plain version: one matrix
    at each of the five path widths, a ragged width, an uneven cluster split
    above 256 (384) and one width of the streamed kernels (640), with each
    launch's cluster size; then the 25 matrices of one step through the
    grouped call, one launch per width, as the train step launches them."""
    rows = {n: sinkhorn_check(n, card, sm_clock_hz)
            for n in sorted(set(SINKHORN_MIX) | {77, 384, 640})}
    return rows, sinkhorn_mix(card, sm_clock_hz)


def sinkhorn_check(n: int, card: str, sm_clock_hz: float) -> dict:
    """Kernel B forward and backward on one [n, n] matrix against its plain
    version, with times and bounds."""
    logits = sinkhorn_logits(n, seed=n)
    dp = sinkhorn_logits(n, seed=n + 1)
    p, hist = sink_mod.sinkhorn_forward(logits, SK_ITERS, keep_history=True)
    grad = sink_mod.sinkhorn_backward(logits, p, dp, hist, SK_ITERS)
    torch.cuda.synchronize()
    x = logits.clone().requires_grad_()
    p_ref = sink_mod.sinkhorn_log_plain(x, SK_ITERS)
    (grad_ref,) = torch.autograd.grad(p_ref, x, dp, retain_graph=True)
    p_err = float((p - p_ref.detach()).abs().max())
    row_err = float((p.sum(dim=-1) - 1.0).abs().max())
    g_scale = float(grad_ref.abs().max())
    g_err = float((grad - grad_ref).abs().max())
    finite = bool(torch.isfinite(p).all() and torch.isfinite(grad).all())
    bounds = sinkhorn_bounds_ms([n], sm_clock_hz)
    plans = {part: sink_mod.launch_plan(n, backward=part == "backward")
             for part in ("forward", "backward")}
    fwd_ms = time_ms(lambda: sink_mod.sinkhorn_forward(logits, SK_ITERS, keep_history=True))
    bwd_ms = time_ms(lambda: sink_mod.sinkhorn_backward(logits, p, dp, hist, SK_ITERS))
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: sink_mod.sinkhorn_log_plain(logits, SK_ITERS))
    plain_bwd_ms = time_ms_eager(
        lambda: torch.autograd.grad(p_ref, x, dp, retain_graph=True))
    row = {"phase": "kernel", "kernel": "sinkhorn", "n": n, "iters": SK_ITERS,
           "forward_cluster": plans["forward"]["cluster"],
           "backward_cluster": plans["backward"]["cluster"],
           "forward_max_active_clusters": plans["forward"]["max_active_clusters"],
           "backward_max_active_clusters": plans["backward"]["max_active_clusters"],
           "p_max_abs_err": p_err, "row_sum_err": row_err, "grad_max_abs_err": g_err,
           "grad_max_abs": g_scale, "forward_ms": fwd_ms, "forward_plain_ms": plain_fwd_ms,
           "forward_bound_ms": bounds["forward"][0], "forward_bound_by": bounds["forward"][1],
           "backward_ms": bwd_ms, "backward_plain_ms": plain_bwd_ms,
           "backward_bound_ms": bounds["backward"][0],
           "backward_bound_by": bounds["backward"][1], "library_ms": None, "card": card}
    print(json.dumps(row), flush=True)
    if not (finite and p_err <= SINK_P_ATOL and row_err <= SINK_ROW_ATOL
            and g_err <= SINK_GRAD_RTOL * g_scale):
        fail(f"sinkhorn n={n} disagrees with its plain version: P max |diff| {p_err} "
             f"(need <= {SINK_P_ATOL}), row sum error {row_err} (need <= {SINK_ROW_ATOL}), "
             f"gradient max |diff| {g_err} (need <= {SINK_GRAD_RTOL} x {g_scale})")
    return row


def sinkhorn_mix(card: str, sm_clock_hz: float, mix=SINKHORN_MIX) -> dict:
    """The matrices of one step (``mix``: their widths; the flagship's 25 by
    default) through ``sinkhorn_log_many`` with autograd, as the model
    forward and the regulariser call it: one forward and one backward launch
    per width, each matrix held against its plain version. Then the launches
    of each direction timed together on the stacked inputs, beside the plain
    version on the same stacks."""
    widths = sorted(set(mix))
    logits = [sinkhorn_logits(n, seed=1000 + i) for i, n in enumerate(mix)]
    weights = [sinkhorn_logits(n, seed=2000 + i) for i, n in enumerate(mix)]
    xs = [x.clone().requires_grad_() for x in logits]
    before = (sink_mod.launches_forward, sink_mod.launches_backward)
    ps = sink_mod.sinkhorn_log_many(xs, SK_ITERS)
    sum((p * w).sum() for p, w in zip(ps, weights)).backward()
    torch.cuda.synchronize()
    launched = (sink_mod.launches_forward - before[0], sink_mod.launches_backward - before[1])
    if launched != (len(widths), len(widths)):
        fail(f"sinkhorn mix launched {launched} (forward, backward), expected "
             f"{(len(widths), len(widths))}: one of each per width")
    p_worst = g_worst = g_abs_worst = 0.0
    for i, (x, p, w) in enumerate(zip(xs, ps, weights)):
        ref = logits[i].clone().requires_grad_()
        p_ref = sink_mod.sinkhorn_log_plain(ref, SK_ITERS)
        (p_ref * w).sum().backward()
        p_err = float((p.detach() - p_ref.detach()).abs().max())
        g_abs = float((x.grad - ref.grad).abs().max())
        g_err = g_abs / float(ref.grad.abs().max())
        p_worst = max(p_worst, p_err)
        g_worst = max(g_worst, g_err)
        g_abs_worst = max(g_abs_worst, g_abs)
        if not (p_err <= SINK_P_ATOL and g_err <= SINK_GRAD_RTOL):
            fail(f"sinkhorn mix matrix {i} (n={mix[i]}): P max |diff| {p_err}, "
                 f"relative gradient error {g_err}")

    # The stacks one train step launches, one per width.
    stacks = [torch.stack([x for x, m in zip(logits, mix) if m == n]) for n in widths]
    dps = [torch.stack([w for w, m in zip(weights, mix) if m == n]) for n in widths]
    fwd = [sink_mod.sinkhorn_forward(x, SK_ITERS, keep_history=True) for x in stacks]
    fwd_ms = time_ms(lambda: [sink_mod.sinkhorn_forward(x, SK_ITERS, keep_history=True)
                              for x in stacks])
    bwd_ms = time_ms(lambda: [sink_mod.sinkhorn_backward(x, p, dp, h, SK_ITERS)
                              for x, (p, h), dp in zip(stacks, fwd, dps)])
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: [sink_mod.sinkhorn_log_plain(x, SK_ITERS)
                                        for x in stacks])
    refs = [x.clone().requires_grad_() for x in stacks]
    p_refs = [sink_mod.sinkhorn_log_plain(r, SK_ITERS) for r in refs]
    plain_bwd_ms = time_ms_eager(lambda: torch.autograd.grad(p_refs, refs, dps,
                                                             retain_graph=True))
    bounds = sinkhorn_bounds_ms(mix, sm_clock_hz)
    clusters = {part: {n: sink_mod.launch_plan(n, backward=part == "backward",
                                               batch=mix.count(n))["cluster"]
                       for n in widths} for part in ("forward", "backward")}
    row = {"phase": "kernel", "kernel": "sinkhorn", "mix": len(mix), "widths": widths,
           "launches_per_direction": len(widths), "forward_clusters": clusters["forward"],
           "backward_clusters": clusters["backward"], "forward_ms": fwd_ms,
           "forward_plain_ms": plain_fwd_ms, "forward_bound_ms": bounds["forward"][0],
           "forward_bound_by": bounds["forward"][1], "backward_ms": bwd_ms,
           "backward_plain_ms": plain_bwd_ms, "backward_bound_ms": bounds["backward"][0],
           "backward_bound_by": bounds["backward"][1], "p_max_abs_err": p_worst,
           "grad_max_abs_err": g_abs_worst, "worst_relative_grad_err": g_worst, "card": card}
    print(json.dumps(row), flush=True)
    return row


def sinkhorn_summary(rows, mixes, launches: dict, chunked: dict, multitask: dict):
    """Kernel B forward and backward over the 25 matrices of one step as the
    train step launches them (one launch per width, the first of ``mixes``,
    timed in this phase), with the largest error of any check (every row
    and mix); ``launches`` counts the eager phases' launches, ``chunked``
    and ``multitask`` the replays' (per captured graph x replays) of
    ``train_chunked`` and the multi-task run."""
    mix = mixes[0]
    out = []
    for part, name in (("forward", "sinkhorn_forward"), ("backward", "sinkhorn_backward")):
        err_key = "p_max_abs_err" if part == "forward" else "grad_max_abs_err"
        out.append({
            "name": name,
            "route": "cuda",
            "source": "hvs_tpu_torch/csrc/sinkhorn.cu",
            "replaces": "hvs_tpu/ops/pallas/sinkhorn_pallas.py:62",
            "launches": launches[name],
            "launches_train_chunked": chunked[name],
            "launches_multitask": multitask[name],
            "max_abs_err": max([m[err_key] for m in mixes] + [r[err_key] for r in rows.values()]),
            "ms": mix[f"{part}_ms"],
            "plain_ms": mix[f"{part}_plain_ms"],
            "bound_ms": mix[f"{part}_bound_ms"],
            "bound_by": mix[f"{part}_bound_by"],
            # No single PyTorch call computes the iterated projection.
            "library_ms": None,
        })
    return out


# ---------------------------------------------------------------------------
# Kernel C: unfolded mHC block


def unfolded_bound_ms(n: int, d: int):
    """As kernel A's bound with the extra ``@ H_pre`` product: 10·N·d² FLOP,
    (4·N·d + 10·d² + 24·d) bytes."""
    t_ops = 10.0 * n * d * d / PEAK_BF16_FLOPS * 1e3
    t_bytes = (4.0 * n * d + 10.0 * d * d + 24.0 * d) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_unfolded(card: str, shapes=None):
    """Kernel C against its plain version at the 18 sites of the validation
    forwards (416², batch 8 in ``train``; 640², batch 4 in
    ``train_chunked``; 320², batch 8 in ``multitask``) and at a ragged count
    (or at ``shapes``). Inputs
    are kernel A's well-conditioned ones with a near-identity
    H_pre = sigmoid(6·I - 3 + noise)."""
    if shapes is None:
        shapes = sorted(set(mhc_sites(TRAIN_BATCH, TRAIN_IMAGE))
                        | set(mhc_sites(CHUNK_VAL_BATCH, max(CHUNK_BATCHES)))
                        | set(mhc_sites(MULTITASK_BATCH, MULTITASK_IMAGE))
                        | {(1234, d) for d in mhc_mod.SUPPORTED_WIDTHS})
    per_shape = {}
    for n, d in shapes:
        x, args = mhc_inputs(n, d, seed=n * 5 + d)
        r = np.random.default_rng(d)
        h_pre = torch.sigmoid(torch.from_numpy(
            (6.0 * np.eye(d) - 3.0 + 0.5 * r.standard_normal((d, d))).astype(np.float32)))
        args = (h_pre.to("cuda", torch.bfloat16).contiguous(), *args)
        out = mhc_mod.mhc_block_unfolded(x, *args)
        torch.cuda.synchronize()
        ref = mhc_mod.mhc_block_unfolded_plain(x, *args)
        a = out.float().flatten().cpu().numpy()
        b = ref.float().flatten().cpu().numpy()
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            fail(f"mhc_block_unfolded n={n} d={d}: non-finite output")
        corr = float(np.corrcoef(a, b)[0, 1])
        mean_abs = float(np.mean(np.abs(a - b)))
        ms = time_ms(lambda: mhc_mod.mhc_block_unfolded(x, *args))
        plain_ms = time_ms(lambda: mhc_mod.mhc_block_unfolded_plain(x, *args))
        bound, bound_by = unfolded_bound_ms(n, d)
        row = {"phase": "kernel", "kernel": "mhc_block_unfolded", "n": n, "d": d,
               "tile": mhc_mod.launch_plan(n, d), "corr": corr,
               "mean_abs_err": mean_abs, "max_abs_err": float(np.max(np.abs(a - b))),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
               "library_ms": None, "card": card}
        print(json.dumps(row), flush=True)
        if not (corr > KERNEL_MIN_CORR and mean_abs < KERNEL_MAX_MEAN_ABS):
            fail(f"mhc_block_unfolded n={n} d={d} disagrees with its plain version: corr {corr} "
                 f"(need > {KERNEL_MIN_CORR}), mean |diff| {mean_abs} "
                 f"(need < {KERNEL_MAX_MEAN_ABS})")
        per_shape[(n, d)] = row
    print_total("mhc_block_unfolded", per_shape, mhc_sites(TRAIN_BATCH, TRAIN_IMAGE), card)
    return per_shape


def unfolded_summary(per_shape, launches: int, chunked: int, multitask: int):
    """Kernel C over the 18 launches of one validation forward (416², batch
    8); ``chunked`` and ``multitask``: its launches in the validation replays
    of ``train_chunked`` and of the multi-task run."""
    sites = mhc_sites(TRAIN_BATCH, TRAIN_IMAGE)
    t_ops = sum(10.0 * n * d * d / PEAK_BF16_FLOPS * 1e3 for n, d in sites)
    t_bytes = sum((4.0 * n * d + 10.0 * d * d + 24.0 * d) / PEAK_BYTES * 1e3 for n, d in sites)
    return {
        "name": "mhc_block_unfolded",
        "route": "cuda",
        "source": "hvs_tpu_torch/csrc/mhc_block.cu",
        "replaces": "hvs_tpu/ops/pallas/mhc_pallas.py:80",
        "launches": launches,
        "launches_train_chunked": chunked,
        "launches_multitask": multitask,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
        "ms": sum(per_shape[s]["ms"] for s in sites),
        "plain_ms": sum(per_shape[s]["plain_ms"] for s in sites),
        "bound_ms": sum(per_shape[s]["bound_ms"] for s in sites),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        # No single PyTorch call computes the fused block.
        "library_ms": None,
    }


# ---------------------------------------------------------------------------
# Training path


def phase_train(card: str) -> dict:
    """The full-width flagship trained through ``ManifoldConstrainedTrainer.train``
    on the entry point's synthetic loader, then validated over 2 batches.

    Kernel B runs one launch per matrix width (5) in each grouped call: per
    train step 5 forward launches in the model forward, 5 in the manifold
    regulariser and 5 in the optimizer's projection (computed every step,
    selected on projection steps), and 10 backward launches (the feature
    head's matrix is in the model's width-256 group, where it gets a zero
    gradient). A validation forward runs 5 forward launches of B (no
    history) and 18 of C. Returns the launch counts of this phase."""
    import shutil
    import tempfile

    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.train import make_synthetic_loader
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig

    steps, warmup, val_batches, project_every = 10, 2, 2, 4
    workdir = tempfile.mkdtemp(prefix="hvs_train_smoke_")
    log_path = f"{workdir}/metrics.jsonl"
    try:
        model = HybridVisionSystem(num_classes=TRAIN_CLASSES, monitor=True, seed=0)
        config = TrainerConfig(num_classes=TRAIN_CLASSES, max_boxes=TRAIN_BOXES,
                               project_every=project_every, stability_check_every=5,
                               backbone_lr_factor=0.1, checkpoint_dir=workdir,
                               metrics_log=log_path)
        trainer = ManifoldConstrainedTrainer(model, config, seed=0)
        trainer.init_state()
        train_fn = make_synthetic_loader(TRAIN_BATCH, TRAIN_IMAGE, steps, TRAIN_CLASSES,
                                         TRAIN_BOXES, seed=0)
        val_fn = make_synthetic_loader(TRAIN_BATCH, TRAIN_IMAGE, val_batches, TRAIN_CLASSES,
                                       TRAIN_BOXES, seed=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        result = trainer.train(train_fn, val_fn, epochs=1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        trainer.close()
        with open(log_path) as f:
            log = [json.loads(line) for line in f]
        # Validation timed on its own, after the counted run.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = trainer.validate(val_fn())
        torch.cuda.synchronize()
        val_ms = (time.perf_counter() - t0) / val_batches * 1e3
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # Each metrics row is written after the step's metrics reached the host
    # (a synchronising copy), so row-to-row time is the step's wall time.
    step_ms = [(b["time"] - a["time"]) * 1e3 for a, b in zip(log, log[1:])][warmup - 1:]
    n_proj = sum(1 for i in range(steps) if (i + 1) % project_every == 0)
    last = log[-1]
    row = {"phase": "train", "image": TRAIN_IMAGE, "batch": TRAIN_BATCH,
           "classes": TRAIN_CLASSES, "steps": steps, "timed_steps": len(step_ms),
           "projection_steps": n_proj, "step_ms_median": float(np.median(step_ms)),
           "step_ms": step_ms, "val_ms_per_batch": val_ms, "wall_s": wall_s,
           "loss_first": log[0]["loss"], "loss_last": last["loss"],
           "grad_norm": last["grad_norm"], "ds_error_max": last["ds_error_max"],
           "signal_ratio_mean": last["signal_ratio_mean"], "val_loss": val["val_loss"],
           "best_val_loss": result["best_val_loss"], "lr_scale": trainer.state.lr_scale,
           "stability_alerts": len(trainer.monitor.alerts), "peak_mem_gb": peak_gb,
           "launches": counts, "card": card}
    print(json.dumps(row), flush=True)
    values = [r[k] for r in log for k in ("loss", "grad_norm", "ds_error_max",
                                          "signal_ratio_mean")]
    values += list(val.values()) + [result["best_val_loss"]]
    if not np.isfinite(values).all():
        fail(f"train: non-finite metrics {row}")
    if trainer.state.step != steps or len(log) != steps:
        fail(f"train ran {trainer.state.step} steps ({len(log)} logged), expected {steps}")
    n_widths = len(set(SINKHORN_MIX))
    want = {"mhc_block": 0, "mhc_block_unfolded": KERNEL_SITES * val_batches,
            "sinkhorn_forward": (3 * steps + val_batches) * n_widths,
            "sinkhorn_backward": 2 * n_widths * steps}
    if counts != want:
        fail(f"train launch counts {counts}, expected {want}")
    return counts


def phase_train_chunked(card: str) -> dict:
    """The on-device training loop through ``ManifoldConstrainedTrainer.train_chunked``
    at ``train_device``'s defaults and full width; then the checks on a
    captured step, and one chunk at the ``train`` phase's configuration.

    Per captured step, kernel B launches 15 forward (model, regulariser,
    projection; 5 widths each) and 10 backward; a validation replay launches
    5 B forward and 18 C. The kernels' counters count host launches
    (warm-up steps and the capture), so the path's launches are each
    captured step's times its replays. Returns those of this phase."""
    import gc
    import shutil
    import tempfile

    from hvs_tpu_torch.data import DeviceData, put_device_data
    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.train_device import synthetic_arrays
    from hvs_tpu_torch.training import (ManifoldConstrainedTrainer, TrainerConfig,
                                        make_eig_telemetry)

    check_sync_debug_mode()
    sizes = tuple(CHUNK_BATCHES)
    n_chunks = CHUNKS_PER_SIZE * len(sizes)
    steps = n_chunks * CHUNK_STEPS
    arrays = synthetic_arrays(CHUNK_IMAGES, max(sizes), CHUNK_BOXES, CHUNK_CLASSES, seed=0)
    val_arrays = synthetic_arrays(CHUNK_VAL_IMAGES, max(sizes), CHUNK_BOXES, CHUNK_CLASSES,
                                  seed=1)
    data = put_device_data(*arrays)
    val_data = put_device_data(*val_arrays)
    print(json.dumps({"phase": "train_chunked_data", "images": CHUNK_IMAGES,
                      "image": max(sizes), "image_bytes": data.images.numel(),
                      "total_bytes": sum(t.numel() * t.element_size() for t in data),
                      "card": card}), flush=True)
    workdir = tempfile.mkdtemp(prefix="hvs_chunked_smoke_")
    try:
        model = HybridVisionSystem(num_classes=CHUNK_CLASSES, monitor=True, seed=0)
        config = TrainerConfig(num_classes=CHUNK_CLASSES, max_boxes=CHUNK_BOXES,
                               ema_decay=0.999, project_every=CHUNK_PROJECT_EVERY,
                               checkpoint_dir=workdir, metrics_log=f"{workdir}/steps.jsonl")
        trainer = ManifoldConstrainedTrainer(model, config, seed=0)
        trainer.init_state()
        progress = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        result = trainer.train_chunked(
            data, total_steps=steps, out_sizes=sizes, batch_sizes=CHUNK_BATCHES,
            chunk_steps=CHUNK_STEPS, val_data=val_data, val_out_size=max(sizes),
            val_batch_size=CHUNK_VAL_BATCH, val_every_chunks=n_chunks, eig_every_chunks=2,
            progress_fn=progress.append)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        host_counts = kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        trainer.close()
        with open(f"{workdir}/steps.jsonl") as f:
            log = [json.loads(line) for line in f]
        chunks, val = trainer.chunks, trainer.val_chunk
        launches = {k: sum(c.launches[k] * c.replays for c in chunks.values())
                    + val.launches[k] * val.replays for k in host_counts}
        rows = []
        for o, c in chunks.items():
            wall = [t["wall_ms"] / CHUNK_STEPS for t in c.timings]
            dev = [t["device_ms"] / CHUNK_STEPS for t in c.timings]
            rows.append({"phase": "train_chunked", "image": o, "batch": c.batch_size,
                         "classes": CHUNK_CLASSES, "chunks": len(c.timings),
                         "chunk_steps": CHUNK_STEPS, "ms_per_step": wall,
                         "steps_per_s": [1e3 / w for w in wall], "device_ms_per_step": dev,
                         "capture_s": c.capture_s, "peak_gb_after_capture": c.peak_gb,
                         "launches_per_step": c.launches, "replays": c.replays,
                         "pulls": c.pulls, "card": card})
        val_row = {"phase": "train_chunked_val", "image": val.out_size, "batch": val.batch_size,
                   "batches": val.n_batches, "ms_per_batch": val.timings[-1]["wall_ms"]
                   / val.n_batches, "capture_s": val.capture_s, "launches_per_batch":
                   val.launches, "replays": val.replays, "pulls": val.pulls,
                   "val_loss": result["best_val_loss"], "card": card}
        summary = {"phase": "train_chunked_run", "steps": steps, "wall_s": wall_s,
                   "peak_mem_gb": peak_gb, "steps_per_sec": result["steps_per_sec"],
                   "loss_first": log[0]["loss"], "loss_last": log[-1]["loss"],
                   "lr_scale": trainer.state.lr_scale,
                   "stability_alerts": len(trainer.monitor.alerts),
                   "eig": {k: v for k, v in progress[-2].items() if k.startswith("eig_")},
                   "launches_host": host_counts, "launches_replayed": launches, "card": card}
        for row in rows + [val_row, summary]:
            print(json.dumps(row), flush=True)

        # Check 5 and 6: one pull per chunk, the count, finite metrics, the
        # launches per step.
        n_widths = len(set(SINKHORN_MIX))
        want_step = {"mhc_block": 0, "mhc_block_unfolded": 0,
                     "sinkhorn_forward": 3 * n_widths, "sinkhorn_backward": 2 * n_widths}
        want_val = {"mhc_block": 0, "mhc_block_unfolded": KERNEL_SITES,
                    "sinkhorn_forward": n_widths, "sinkhorn_backward": 0}
        for o, c in chunks.items():
            if (c.pulls, c.replays, len(c.timings)) != (CHUNKS_PER_SIZE,
                                                        CHUNKS_PER_SIZE * CHUNK_STEPS,
                                                        CHUNKS_PER_SIZE):
                fail(f"train_chunked at {o}: {c.pulls} pulls and {c.replays} replays, "
                     f"expected {CHUNKS_PER_SIZE} and {CHUNKS_PER_SIZE * CHUNK_STEPS}")
            if c.launches != want_step:
                fail(f"train_chunked at {o}: launches per captured step {c.launches}, "
                     f"expected {want_step}")
        if val.launches != want_val or val.pulls != 1:
            fail(f"train_chunked validation: launches per batch {val.launches} (expected "
                 f"{want_val}), {val.pulls} pulls (expected 1)")
        if trainer.state.step != steps or int(trainer.tx.count) != steps or len(log) != steps:
            fail(f"train_chunked ran {trainer.state.step} steps (count {int(trainer.tx.count)}, "
                 f"{len(log)} rows), expected {steps}")
        values = [r[k] for r in log for k in ("loss", "grad_norm", "ds_error_max",
                                              "signal_ratio_mean", "lr")]
        if not np.isfinite(values + [result["best_val_loss"]]).all():
            fail(f"train_chunked: non-finite metrics {summary}")
        # Check 4: each step's lr is the host schedule's at that step.
        for r in log:
            want_lr = trainer.schedule(r["step"] - 1)
            if abs(r["lr"] - want_lr) > 1e-6 * want_lr + 1e-12:
                fail(f"train_chunked step {r['step']}: lr {r['lr']} on the card, "
                     f"{want_lr} on the host")

        # Checks 1-3 on the 416² step, made a projection step.
        step_row = captured_step_checks(trainer, chunks[min(sizes)], data,
                                        make_eig_telemetry(config.sk_iters), card)
        del trainer, chunks, val, model
        gc.collect()
        torch.cuda.empty_cache()

        # One chunk at the train phase's configuration, beside its eager step.
        same = chunked_at_train_config(
            DeviceData(data.images, data.boxes, data.labels % TRAIN_CLASSES, data.mask), card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({**step_row, **same}), flush=True)
    return launches


def check_sync_debug_mode() -> None:
    """torch's sync debug mode, which ``TrainChunk.run`` sets to "error"
    around a chunk's replays, does raise on a host sync here."""
    x = torch.ones(1, device="cuda")
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x.item()
    except RuntimeError:
        return
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    fail("torch.cuda.set_sync_debug_mode('error') did not raise on a sync")


def _draws_tuple(draws) -> tuple:
    """A step's draws (``AugmentDraws``, or the multi-task step's indices) as
    a tuple of tensors."""
    return (draws,) if isinstance(draws, torch.Tensor) else tuple(draws)


def replay_against_eager(trainer, chunk, count: int, probe=None):
    """From one state (parameters, optimizer state with its count set to
    ``count``, EMA, generator, lr_scale 1): a replay of ``chunk``'s captured
    step against the same step run eagerly, which draws the same batch.
    ``probe(trainer)`` runs after the replay, before the state is put back.
    Returns (the comparison, the replay's run, the eager run); a run holds
    its metrics row, parameters, draws and batch."""
    trainer.tx.count.fill_(count)
    trainer.lr_scale_t.fill_(1.0)
    state = trainer.state_tensors()
    n_params = len(list(trainer.model.parameters()))
    start = [x.detach().clone() for x in state]
    gen = trainer.generator.get_state()

    def run(replay: bool) -> dict:
        chunk.pos.zero_()
        chunk.replay() if replay else chunk.step()
        torch.cuda.synchronize()
        out = {"row": chunk.metrics[0].clone(),
               "params": [x.detach().clone() for x in state[:n_params]],
               "draws": tuple(d.clone() for d in _draws_tuple(chunk.last_draws)),
               "batch": {k: v.clone() for k, v in chunk.last_batch.items()}}
        if replay and probe is not None:
            out["probe"] = probe(trainer)
        with torch.no_grad():
            for x, v in zip(state, start):
                x.copy_(v)
        trainer.generator.set_state(gen)
        return out

    g = run(True)
    e = run(False)
    keys = chunk.keys
    rows = {k: (float(g["row"][i]), float(e["row"][i])) for i, k in enumerate(keys)}
    upd_g = torch.cat([(a - s).flatten() for a, s in zip(g["params"], start)])
    upd_e = torch.cat([(a - s).flatten() for a, s in zip(e["params"], start)])
    lr = trainer.schedule(count)
    cmp = {"projection_count": count,
           "same_draws": all(torch.equal(a, b) for a, b in zip(g["draws"], e["draws"])),
           "same_batch": all(torch.equal(g["batch"][k], e["batch"][k]) for k in g["batch"]),
           "forward_metrics_equal": all(rows[k][0] == rows[k][1] for k in keys
                                        if k != "grad_norm"),
           "grad_norm_rel_diff": abs(rows["grad_norm"][0] - rows["grad_norm"][1])
           / rows["grad_norm"][1],
           "update_cos": float((upd_g * upd_e).sum() / (upd_g.norm() * upd_e.norm() + 1e-30)),
           "param_max_abs_diff": float((upd_g - upd_e).abs().max()),
           "param_limit": 2 * lr + 1e-6, "loss_graph": rows["loss"][0],
           "loss_eager": rows["loss"][1]}
    tol = TRAIN_PARITY["float32"]
    if not (cmp["same_draws"] and cmp["same_batch"] and cmp["forward_metrics_equal"]
            and cmp["grad_norm_rel_diff"] <= tol["grad_norm_rtol"]
            and cmp["update_cos"] > tol["mhc_update_min_cos"]
            and cmp["param_max_abs_diff"] <= cmp["param_limit"]):
        fail(f"a replay of the captured step disagrees with the eager step: {cmp}; "
             f"metrics {rows}")
    return cmp, g, e


def captured_step_checks(trainer, chunk, data, eig_fn, card: str) -> dict:
    """From one state, with the count set so the step projects: a replay of
    the captured step against the same step run eagerly (check 1,
    ``replay_against_eager``); the replay's batch against ``apply_augment``
    on the CPU with the replay's draws (check 2: pixel values within 1e-4,
    boxes within 1e-5, mask and labels exact); every constrained matrix
    after the replayed projection step (check 3)."""
    from hvs_tpu_torch.constants import IMAGENET_STD
    from hvs_tpu_torch.data import AugmentDraws, DeviceData, apply_augment

    cmp, g, _ = replay_against_eager(
        trainer, chunk, CHUNK_PROJECT_EVERY - 1,
        probe=lambda t: {k: float(v) for k, v in eig_fn(t.params()).items()})

    # Check 2: the sampler on the card against apply_augment on the CPU.
    d = AugmentDraws(*g["draws"])
    idx = d.idx
    cpu_data = DeviceData(*(t.index_select(0, idx).cpu() for t in data))
    cpu_draws = AugmentDraws(torch.arange(len(idx)), *(t.cpu() for t in d[1:]))
    want = apply_augment(cpu_data, cpu_draws, chunk.out_size, chunk.aug)
    # In pixel values ([0, 1], before the ImageNet normalization divides by
    # std ~0.225): each output pixel is two fp32 products over 640 terms,
    # summed in other orders by cuBLAS and the CPU.
    std = torch.tensor(IMAGENET_STD)
    img_err = float(((g["batch"]["images"].cpu() - want["images"]) * std).abs().max())
    box_err = float((g["batch"]["boxes"].cpu() - want["boxes"]).abs().max())
    mask_equal = bool(torch.equal(g["batch"]["box_mask"].cpu(), want["box_mask"])
                      and torch.equal(g["batch"]["labels"].cpu(), want["labels"]))

    eig = g["probe"]
    row = {"phase": "train_chunked_checks", "image": chunk.out_size, "batch": chunk.batch_size,
           **cmp, "sampler_pixel_max_abs_err": img_err, "sampler_box_max_abs_err": box_err,
           "sampler_mask_labels_equal": mask_equal,
           "ds_error_max_proj_after_projection": eig["ds_error_max_proj"],
           "max_eigenvalue_after_projection": eig["max_eigenvalue"], "card": card}
    print(json.dumps(row), flush=True)
    if not (img_err <= 1e-4 and box_err <= 1e-5 and mask_equal):
        fail(f"train_chunked: the card's sampler disagrees with apply_augment on the CPU: {row}")
    if not eig["ds_error_max_proj"] <= 1e-5:
        fail(f"train_chunked: after the projection step the DS error is "
             f"{eig['ds_error_max_proj']} (need <= 1e-5)")
    return {"checks": "passed"}


def chunked_at_train_config(data, card: str) -> dict:
    """One chunk of 10 steps at the ``train`` phase's configuration (416²,
    batch 8, 8 classes, warm-up and projection as there), so that the
    chunked step and the eager step of that phase stand side by side."""
    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig

    model = HybridVisionSystem(num_classes=TRAIN_CLASSES, monitor=True, seed=0)
    config = TrainerConfig(num_classes=TRAIN_CLASSES, max_boxes=CHUNK_BOXES, project_every=4,
                           backbone_lr_factor=0.1)
    trainer = ManifoldConstrainedTrainer(model, config, seed=0)
    trainer.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_chunked(data, total_steps=CHUNK_STEPS, batch_size=TRAIN_BATCH,
                          out_sizes=(TRAIN_IMAGE,), chunk_steps=CHUNK_STEPS,
                          eig_every_chunks=0)
    c = trainer.chunks[TRAIN_IMAGE]
    t = c.timings[0]
    row = {"phase": "train_chunked_at_train_config", "image": TRAIN_IMAGE,
           "batch": TRAIN_BATCH, "classes": TRAIN_CLASSES, "chunk_steps": CHUNK_STEPS,
           "ms_per_step": t["wall_ms"] / CHUNK_STEPS,
           "device_ms_per_step": t["device_ms"] / CHUNK_STEPS, "capture_s": c.capture_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    print(json.dumps(row), flush=True)
    return {"at_train_config_ms_per_step": row["ms_per_step"]}


def phase_train_parity(card: str) -> None:
    """One train step, dropout off, full width at 320², batch 2: the port on
    the card (kernels) against the port on the CPU (plain versions), from
    the same weights (H_res near identity, as in the serve parity) and batch,
    in fp32 (where the two should agree to rounding) and in bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        row = train_step_pair(dtype)
        row["card"] = card
        print(json.dumps(row), flush=True)
        if not train_parity_within_limits(row):
            fail(f"train step on the card disagrees with the CPU: {row}; limits "
                 f"{TRAIN_PARITY[row['dtype']]}, parameters within {row['param_limit']}")


def train_parity_within_limits(row: dict) -> bool:
    """Whether a ``train_step_pair`` row meets the limits of its dtype."""
    tol = TRAIN_PARITY[row["dtype"]]
    return bool(row["finite"]
                and abs(row["loss_cuda"] - row["loss_cpu"]) <= tol["loss_rtol"] * abs(row["loss_cpu"])
                and abs(row["grad_norm_cuda"] - row["grad_norm_cpu"])
                <= tol["grad_norm_rtol"] * row["grad_norm_cpu"]
                and row["h_res_grads"] == len(SINKHORN_MIX)
                and row["h_res_grad_cos_min"] > tol["h_res_grad_min_cos"]
                and row["mhc_update_cos"] > tol["mhc_update_min_cos"]
                and row["param_max_abs_diff"] <= row["param_limit"])


def train_step_pair(dtype: torch.dtype, task: str = "detection") -> dict:
    """One train step on the card against the CPU from the same weights and
    batch; for ``task="multi_task"`` the flagship with both dense heads on a
    batch of ``train_multitask``'s synthetic dense images."""
    import copy

    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.models.layers import Dropout, ManifoldHyperConnection
    from hvs_tpu_torch.train import make_synthetic_loader
    from hvs_tpu_torch.train_multitask import synthetic_dense_arrays
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig, train_step
    from hvs_tpu_torch.training.optimizer import partition_label
    from hvs_tpu_torch.training.trainer import batch_to

    dense = task == "multi_task"
    model = HybridVisionSystem(num_classes=TRAIN_CLASSES, monitor=True, seed=1, dtype=dtype,
                               use_segmentation=dense, use_depth=dense, task=task)
    r = np.random.default_rng(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
            if isinstance(m, ManifoldHyperConnection):
                d = m.dim
                m.H_res_raw.copy_(torch.from_numpy(
                    (6.0 * np.eye(d) + r.standard_normal((d, d))).astype(np.float32)))
    cpu_model = copy.deepcopy(model).to("cpu")
    start = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    # No warmup, so the step moves every parameter (lr(0) = 1e-3).
    config = TrainerConfig(num_classes=TRAIN_CLASSES, warmup_steps=0, backbone_lr_factor=0.1)
    if dense:
        images, boxes, labels, mask, seg, depth = synthetic_dense_arrays(2, 320, CHUNK_BOXES,
                                                                         TRAIN_CLASSES, seed=3)
        batch = {"images": images, "boxes": boxes, "labels": labels, "box_mask": mask,
                 "seg_labels": seg.astype(np.int64), "depth": depth}
    else:
        batch = next(make_synthetic_loader(2, 320, 1, TRAIN_CLASSES, TRAIN_BOXES, seed=3)())
    results = {}
    for name, m, dev in (("cuda", model, torch.device("cuda")),
                         ("cpu", cpu_model, torch.device("cpu"))):
        # Through the trainer, the entry point (it pins the precision flags
        # and builds the optimizer); one step, gradients returned.
        trainer = ManifoldConstrainedTrainer(m, config, device=dev)
        trainer.init_state()
        params = trainer.params()
        lr = trainer.schedule
        t0 = time.perf_counter()
        metrics, grads = train_step(m, trainer.tx, config, trainer.state, batch_to(batch, dev),
                                    task)
        results[name] = dict(
            loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
            h_res={k: g.float().cpu() for k, g in grads.items() if k.endswith("H_res_raw")},
            params={k: v.detach().float().cpu() for k, v in params.items()},
            seconds=time.perf_counter() - t0)

    def cos(a, b):
        return float((a * b).sum() / (a.norm() * b.norm() + 1e-30))

    g, c = results["cuda"], results["cpu"]
    hres_cos = {k: cos(g["h_res"][k], c["h_res"][k]) for k in c["h_res"]}
    # The SGD partitions' update is -lr·factor·(clipped gradient), so its
    # cosine measures the gradients the optimizer used; an Adam first step is
    # ±lr·factor per element, bounded below.
    mhc = [k for k in start if partition_label(k, 0.1).startswith("mhc")]
    upd = {side: torch.cat([(r_["params"][k] - start[k]).flatten() for k in mhc])
           for side, r_ in results.items()}
    max_dp = max(float((g["params"][k] - c["params"][k]).abs().max()) for k in start)
    finite = bool(np.isfinite([g["loss"], c["loss"], g["grad_norm"], c["grad_norm"]]).all()
                  and all(torch.isfinite(v).all() for v in g["params"].values()))
    return {"phase": "train_parity", "task": task, "dtype": str(dtype).split(".")[-1],
            "image": 320,
            "batch": 2, "loss_cuda": g["loss"], "loss_cpu": c["loss"],
            "grad_norm_cuda": g["grad_norm"], "grad_norm_cpu": c["grad_norm"],
            "h_res_grads": len(hres_cos), "h_res_grad_cos_min": min(hres_cos.values()),
            "h_res_grad_cos": sorted(hres_cos.values()),
            "mhc_update_cos": cos(upd["cuda"], upd["cpu"]), "param_max_abs_diff": max_dp,
            "param_limit": 2 * lr(0) + 1e-6, "finite": finite, "step_s_cuda": g["seconds"],
            "step_s_cpu": c["seconds"]}


# ---------------------------------------------------------------------------
# The multi-task model and the lightweight variant


def phase_multitask(card: str) -> dict:
    """The multi-task training run of ``python -m hvs_tpu_torch.train_multitask``
    at full width: its set-up (``prepare``: data, model, trainer, the captured
    step and evaluation), 2 chunks of 10 captured steps and one captured
    validation pass, counters zeroed just before the set-up. Per captured
    step kernel B launches 15 forward (model, regulariser, projection; 5
    widths each) and 10 backward; per validation batch B 5 and C 18. Then a
    replay against the eager step, the dense labels at the heads' stride, and
    one step on the card against the CPU in fp32. Returns the launches of the
    path (each captured graph's count times its replays)."""
    import gc

    from hvs_tpu_torch.train_multitask import parse_args, prepare

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    run = prepare(parse_args(MULTITASK_ARGS))
    setup_s = time.perf_counter() - t0
    trainer, chunk, evaluator = run.trainer, run.chunk, run.evaluator
    if (chunk.out_size, chunk.batch_size) != (MULTITASK_IMAGE, MULTITASK_BATCH):
        fail(f"multitask: steps at {chunk.out_size}² batch {chunk.batch_size}, the kernel "
             f"phases checked C at {MULTITASK_IMAGE}² batch {MULTITASK_BATCH}")
    hosts = [chunk.run() for _ in range(MULTITASK_CHUNKS)]
    val, iou = evaluator.run()
    torch.cuda.synchronize()
    host_counts = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: chunk.launches[k] * chunk.replays + evaluator.launches[k] * evaluator.replays
                for k in host_counts}
    wall = [t["wall_ms"] / chunk.chunk_steps for t in chunk.timings]
    row = {"phase": "multitask", "image": chunk.out_size, "batch": chunk.batch_size,
           "classes": trainer.config.num_classes, "params": run.params,
           "chunks": len(chunk.timings), "chunk_steps": chunk.chunk_steps, "ms_per_step": wall,
           "steps_per_s": [1e3 / w for w in wall],
           "device_ms_per_step": [t["device_ms"] / chunk.chunk_steps for t in chunk.timings],
           "capture_s": chunk.capture_s, "setup_s": setup_s,
           "peak_gb_after_capture": chunk.peak_gb, "peak_mem_gb": peak_gb,
           "val_batches": evaluator.n_batches, "val_capture_s": evaluator.capture_s,
           "val_ms_per_batch": evaluator.timings[-1]["wall_ms"] / evaluator.n_batches,
           "val": val, "seg_iou": [float(x) for x in iou],
           "loss_first": float(hosts[0]["loss"][0]), "loss_last": float(hosts[-1]["loss"][-1]),
           "launches_per_step": chunk.launches, "launches_per_val_batch": evaluator.launches,
           "launches_host": host_counts, "launches_replayed": launches, "card": card}
    print(json.dumps(row), flush=True)

    if run.params != MULTITASK_PARAMS:
        fail(f"multitask: {run.params} parameters, the JAX model has {MULTITASK_PARAMS}")
    n_widths = len(set(SINKHORN_MIX))
    want_step = {"mhc_block": 0, "mhc_block_unfolded": 0, "sinkhorn_forward": 3 * n_widths,
                 "sinkhorn_backward": 2 * n_widths}
    want_val = {"mhc_block": 0, "mhc_block_unfolded": KERNEL_SITES,
                "sinkhorn_forward": n_widths, "sinkhorn_backward": 0}
    steps = MULTITASK_CHUNKS * chunk.chunk_steps
    if (chunk.launches, chunk.replays, chunk.pulls) != (want_step, steps, MULTITASK_CHUNKS):
        fail(f"multitask: per captured step {chunk.launches} (expected {want_step}), "
             f"{chunk.replays} replays and {chunk.pulls} pulls (expected {steps} and "
             f"{MULTITASK_CHUNKS})")
    if (evaluator.launches, evaluator.replays, evaluator.pulls) != (
            want_val, evaluator.n_batches, 1):
        fail(f"multitask validation: per batch {evaluator.launches} (expected {want_val}), "
             f"{evaluator.replays} replays, {evaluator.pulls} pulls")
    if int(trainer.tx.count) != steps:
        fail(f"multitask: optimizer count {int(trainer.tx.count)}, expected {steps}")
    values = [v for h in hosts for v in h.values()] + [list(val.values()), iou]
    if not all(np.isfinite(v).all() for v in values):
        fail(f"multitask: non-finite losses or metrics {row}")

    cmp, _, eager = replay_against_eager(trainer, chunk, MULTITASK_CHECK_COUNT)
    stride = dense_labels_at_head_stride(trainer, eager["batch"])
    print(json.dumps({"phase": "multitask_checks", **cmp, **stride, "card": card}), flush=True)
    del trainer, chunk, evaluator, run
    gc.collect()
    torch.cuda.empty_cache()

    pair = train_step_pair(torch.float32, task="multi_task")
    pair["card"] = card
    print(json.dumps(pair), flush=True)
    if not train_parity_within_limits(pair):
        fail(f"multitask step on the card disagrees with the CPU: {pair}; limits "
             f"{TRAIN_PARITY['float32']}, parameters within {pair['param_limit']}")
    return launches


def dense_labels_at_head_stride(trainer, batch) -> dict:
    """The segmentation labels and depth of a train batch reach
    ``multi_task_loss`` at the heads' stride: an eval forward's heads come
    out at half the input's size, and the loss of the full-size labels equals
    that of the labels strided by 2 beforehand, and not that of labels
    strided from an offset of one pixel."""
    from hvs_tpu_torch.training import multi_task_loss
    from hvs_tpu_torch.training.trainer import _targets

    images, nc = batch["images"], trainer.config.num_classes
    with torch.no_grad():
        trainer.model.eval()
        out = trainer.model(images, task="multi_task")
        targets = _targets(trainer.config, images, batch)

        def losses(offset: int, fy: int = 1) -> tuple:
            dense = {k: batch[k][:, offset::fy, offset::fy] for k in ("seg_labels", "depth")}
            _, m = multi_task_loss(out, {**batch, **dense, "targets": targets}, nc)
            return float(m["segmentation_loss"]), float(m["depth_loss"])

        seg_hw, depth_hw = tuple(out["segmentation"].shape[1:3]), tuple(out["depth"].shape[1:3])
        fy = images.shape[1] // seg_hw[0]
        full, strided, shifted = losses(0), losses(0, fy), losses(1, fy)
    row = {"head_stride": fy, "seg_grid": seg_hw, "depth_grid": depth_hw,
           "seg_depth_loss": full, "seg_depth_loss_prestrided": strided,
           "seg_depth_loss_offset_by_one": shifted}
    if not (fy == 2 and depth_hw == seg_hw and seg_hw[0] * 2 == images.shape[1]
            and full == strided and all(a != b for a, b in zip(full, shifted))):
        fail(f"multitask: the dense labels do not reach the loss at the heads' stride: {row}")
    return row


def lightweight_sites(batch: int, image: int = IMAGE):
    """(tokens, d) of the 6 kernel-A launches of one ``LightweightHybridVision``
    forward: the FPN levels and the head towers at strides 8, 16, 32, d = 128."""
    return [(batch * (image // s) ** 2, 128) for s in (8, 16, 32)] * 2


def phase_lightweight(card: str, sm_clock_hz: float) -> dict:
    """``LightweightHybridVision`` with the serving flags: served by
    ``Detector`` at 640², batch 16 and batch 1 (6 kernel-A launches per
    forward, all at d = 128; kernel B once per matrix at load), then held
    CUDA against CPU at 320²; kernel A at its 6 sites of both batches and
    kernel B, forward and backward, at the bottleneck widths 24, 48, 96 and
    192 and over the model's 13 matrices in one grouped call, against their
    plain versions. Returns the rows of the kernel checks and kernel A's
    launches over the served forwards."""
    from hvs_tpu_torch.models import LightweightHybridVision

    def build(seed: int = 0):
        return LightweightHybridVision(precomputed_constraints=True, dropout_rate=0.0,
                                       seed=seed)

    launches = phase_serve(card, build, LIGHT_SITES, "lightweight_serve")
    phase_parity(card, build, "lightweight_parity")
    shapes = sorted(set(lightweight_sites(SERVE_BATCH) + lightweight_sites(1)))
    a_rows = phase_kernels(card, shapes)
    b_rows = {n: sinkhorn_check(n, card, sm_clock_hz) for n in LIGHT_WIDTHS}
    b_mix = sinkhorn_mix(card, sm_clock_hz, LIGHT_MIX)
    return {"mhc_block": launches, "a_rows": a_rows, "b_rows": b_rows, "b_mix": b_mix}


# ---------------------------------------------------------------------------
# The data and evaluation layer


def shapes_split_checks(root: str, split: str, count: int, size: int, seed: int,
                        dense: bool, regenerate: int) -> dict:
    """The annotation JSON of a generated split against its files (every
    image listed is on disk at its stated size, nothing else is, every box
    lies in the frame with a category of the taxonomy), and image
    ``regenerate`` made again alone from its own stream: the same boxes and
    labels as the JSON and the same JPEG bytes (and mask and depth PNGs)."""
    import cv2

    from hvs_tpu_torch.data.shapes import generate_image

    with open(f"{root}/annotations/instances_{split}.json") as f:
        ann = json.load(f)
    names = {im["file_name"] for im in ann["images"]}
    ids = {im["id"] for im in ann["images"]}
    on_disk = set(os.listdir(f"{root}/{split}"))
    sized = all((im["width"], im["height"]) == (size, size) for im in ann["images"])
    boxes_ok = all(a["image_id"] in ids and 1 <= a["category_id"] <= DATA_CLASSES
                   and a["bbox"][0] >= 0 and a["bbox"][1] >= 0
                   and a["bbox"][0] + a["bbox"][2] <= size
                   and a["bbox"][1] + a["bbox"][3] <= size and a["area"] > 0
                   for a in ann["annotations"])
    first = cv2.imread(f"{root}/{split}/{sorted(names)[0]}")
    stream_seed = seed if split == "train" else seed + 1_000_003
    rng = np.random.default_rng(np.random.SeedSequence([stream_seed, regenerate]))
    out = generate_image(rng, size=size, with_dense=dense, num_classes=DATA_CLASSES)
    img, boxes, labels = out[:3]
    info = ann["images"][regenerate]
    mine = [a for a in ann["annotations"] if a["image_id"] == info["id"]]
    clip = np.clip(np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 0] + boxes[:, 2],
                             boxes[:, 1] + boxes[:, 3]], 1).astype(np.float64), 0, size)
    want_boxes = [[float(x1), float(y1), float(x2 - x1), float(y2 - y1)]
                  for x1, y1, x2, y2 in clip]
    jpeg = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                        [cv2.IMWRITE_JPEG_QUALITY, 92])[1].tobytes()
    with open(f"{root}/{split}/{info['file_name']}", "rb") as f:
        same_jpeg = f.read() == jpeg
    same_dense = True
    if dense:
        stem = info["file_name"].replace(".jpg", ".png")
        seg = cv2.imread(f"{root}/masks/{split}/{stem}", cv2.IMREAD_UNCHANGED)
        depth = cv2.imread(f"{root}/depth/{split}/{stem}", cv2.IMREAD_UNCHANGED)
        same_dense = (np.array_equal(seg, out[3]) and np.array_equal(
            depth, np.clip(out[4] * 1000.0, 0, 65535).astype(np.uint16)))
    row = {"split": split, "images": len(ann["images"]), "boxes": len(ann["annotations"]),
           "files_match_json": on_disk == names and len(names) == count,
           "sizes_ok": sized and first is not None and first.shape == (size, size, 3),
           "boxes_ok": boxes_ok, "regenerated": regenerate,
           "regenerated_boxes_equal": [a["bbox"] for a in mine] == want_boxes,
           "regenerated_labels_equal": [a["category_id"] for a in mine]
           == [int(c) + 1 for c in labels],
           "regenerated_jpeg_equal": same_jpeg, "regenerated_dense_equal": same_dense}
    if not all(v for k, v in row.items() if k not in ("split", "images", "boxes",
                                                      "regenerated")):
        fail(f"data: the generated {split} split of {root} fails its checks: {row}")
    return row


def upload_checks(host, data) -> dict:
    """Each tensor on the card equal to its host array, dtype included."""
    same = [t.device.type == "cuda" and t.dtype == torch.from_numpy(a).dtype
            and torch.equal(t.cpu(), torch.from_numpy(a)) for t, a in zip(data, host)]
    if len(same) != len(host) or not all(same):
        fail(f"data: uploaded tensors differ from the host arrays: {same}")
    return {"tensors_equal_host": len(same)}


def add_replayed(launches: dict, *graphs) -> None:
    """Add each captured graph's launches times its replays to ``launches``."""
    for g in graphs:
        for k in launches:
            launches[k] += g.launches.get(k, 0) * g.replays


def phase_data(card: str) -> dict:
    """The data and evaluation layer, through the entry points, at full width:
      1. generate (``python -m hvs_tpu_torch.make_shapes_dataset``) a shapes
         dataset at 640², 8 classes, seed 0, and a dense one at 320²; hold
         each split's JSON against its files and one image regenerated alone;
      2. decode both with ``load_coco_arrays`` and upload them
         (``put_device_data``, ``put_dense_data``); hold the card's tensors
         equal to the host arrays;
      3. train from disk: ``train_device`` at 640² batch 8 for 2 chunks of 10
         (B 15 + 10 per captured step, C 18 and B 5 per validation batch; its
         checkpoint kept), ``train`` for one epoch at 416² batch 8 through
         ``COCODataModule`` (the host loader's batches/s beside the eager
         step), ``train_multitask`` for 2 chunks of 10 at 320²;
      4. evaluate (``hvs_tpu_torch.evaluate``) the val split at 640² with the
         ``train_device`` checkpoint: A at 18 per replay, each image's
         detections bitwise equal to ``engine.infer`` of its frame, the
         evaluator's numbers equal to a recomputation from them, and the
         ``--synthetic`` self-check at 1.0.
    Returns the launches of the path (counted launches of the eager run,
    each captured graph's launches times its replays)."""
    import gc
    import shutil
    import tempfile

    import cv2

    from hvs_tpu_torch import evaluate, make_shapes_dataset, train, train_device, \
        train_multitask
    from hvs_tpu_torch.config import TrainingConfig
    from hvs_tpu_torch.data import (COCODataModule, generate_shapes_dataset, load_coco_arrays,
                                    put_dense_data, put_device_data)
    from hvs_tpu_torch.inference.engine import WARMUP_CALLS
    from hvs_tpu_torch.utils import DetectionEvaluator

    n_widths = len(set(SINKHORN_MIX))
    want_step = {"mhc_block": 0, "mhc_block_unfolded": 0, "sinkhorn_forward": 3 * n_widths,
                 "sinkhorn_backward": 2 * n_widths}
    want_val = {"mhc_block": 0, "mhc_block_unfolded": KERNEL_SITES,
                "sinkhorn_forward": n_widths, "sinkhorn_backward": 0}
    launches = {k: 0 for k in want_step}
    workdir = tempfile.mkdtemp(prefix="hvs_data_smoke_")
    root, dense_root = f"{workdir}/shapes640", f"{workdir}/shapes320_dense"
    try:
        # 1. Generate.
        gen = {}
        for where, size, n_train, n_val, dense in (
                (root, DATA_IMAGE, DATA_TRAIN, DATA_VAL, False),
                (dense_root, DATA_DENSE_IMAGE, DATA_DENSE_TRAIN, DATA_DENSE_VAL, True)):
            t0 = time.perf_counter()
            if dense:  # what train_multitask generates when its data root is absent
                generate_shapes_dataset(where, num_train=n_train, num_val=n_val, size=size,
                                        seed=0, with_dense=True)
            else:
                make_shapes_dataset.main(["--root", where, "--train", str(n_train), "--val",
                                          str(n_val), "--size", str(size), "--seed", "0"])
            seconds = time.perf_counter() - t0
            checks = [shapes_split_checks(where, split, n, size, 0, dense, n - 1)
                      for split, n in (("train", n_train), ("val", n_val))]
            gen[size] = {"images": n_train + n_val, "seconds": seconds,
                         "s_per_image": seconds / (n_train + n_val), "dense": dense,
                         "checks": checks}
        print(json.dumps({"phase": "data_generate", **{str(k): v for k, v in gen.items()},
                          "card": card}), flush=True)

        # 2. Load: decode on the host, upload, hold the card's copy.
        t0 = time.perf_counter()
        host = load_coco_arrays(root, "train", max_boxes=DATA_BOXES)
        dense_host = load_coco_arrays(dense_root, "train", max_boxes=DATA_BOXES, dense=True)
        decode_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = put_device_data(*host)
        dense = put_dense_data(*dense_host)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        nbytes = sum(a.nbytes for a in host) + sum(a.nbytes for a in dense_host)
        row = {"phase": "data_load", "images": len(host[0]) + len(dense_host[0]),
               "decode_s": decode_s, "upload_s": upload_s, "bytes": nbytes,
               "upload_gb_per_s": nbytes / upload_s / 1e9,
               **upload_checks(host, data), "dense": upload_checks(dense_host, dense),
               "card": card}
        print(json.dumps(row), flush=True)
        del data, dense

        # 3a. train_device from disk, one size, 2 chunks; its checkpoint kept.
        run_dir = f"{workdir}/run"
        zero_counts()
        t0 = time.perf_counter()
        trainer, summary = train_device.run(train_device.parse_args([
            "--data-root", root, "--num-classes", str(DATA_CLASSES), "--train-sizes",
            str(DATA_IMAGE), "--max-boxes", str(DATA_BOXES), "--total-steps",
            str(DATA_CHUNKS * DATA_CHUNK_STEPS), "--chunk-steps", str(DATA_CHUNK_STEPS),
            "--val-every-chunks", str(DATA_CHUNKS), "--eig-every-chunks", str(DATA_CHUNKS),
            "--run-dir", run_dir]))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        (size, chunk), = trainer.chunks.items()
        val = trainer.val_chunk
        with open(f"{run_dir}/steps.jsonl") as f:
            log = [json.loads(line) for line in f]
        row = {"phase": "data_train_device", "image": size, "batch": chunk.batch_size,
               "steps": summary["steps"], "wall_s": wall_s,
               "ms_per_step": [t["wall_ms"] / DATA_CHUNK_STEPS for t in chunk.timings],
               "capture_s": chunk.capture_s, "val_batches": val.n_batches,
               "loss_first": log[0]["loss"], "loss_last": log[-1]["loss"],
               "best_val_loss": summary["best_val_loss"], "launches_per_step": chunk.launches,
               "replays": chunk.replays, "launches_per_val_batch": val.launches,
               "val_replays": val.replays, "card": card}
        print(json.dumps(row), flush=True)
        steps = DATA_CHUNKS * DATA_CHUNK_STEPS
        if (chunk.launches, chunk.replays, summary["steps"]) != (want_step, steps, steps) \
                or (val.launches, val.replays) != (want_val, val.n_batches):
            fail(f"data: train_device from disk launched {row}; expected {want_step} per "
                 f"step over {steps} replays and {want_val} per validation batch")
        values = [r[k] for r in log for k in ("loss", "grad_norm", "ds_error_max")]
        if len(log) != steps or not np.isfinite(values + [summary["best_val_loss"]]).all():
            fail(f"data: train_device from disk: non-finite or missing metrics {row}")
        add_replayed(launches, chunk, val)
        checkpoint = f"{run_dir}/checkpoints/final"
        del trainer, chunk, val
        gc.collect()
        torch.cuda.empty_cache()

        # 3b. train through COCODataModule, one epoch, eager steps.
        cfg_path = f"{workdir}/training.yaml"
        tcfg = TrainingConfig(batch_size=DATA_TRAIN_BATCH, epochs=1,
                              checkpoint_dir=f"{workdir}/ckpt", log_dir=f"{workdir}/logs",
                              metrics_log=f"{workdir}/train_steps.jsonl")
        tcfg.dataset.root, tcfg.dataset.train_split, tcfg.dataset.val_split = root, "train", "val"
        tcfg.dataset.image_size, tcfg.dataset.max_boxes = DATA_TRAIN_IMAGE, DATA_BOXES
        tcfg.save(cfg_path)
        ds = tcfg.dataset
        dm = COCODataModule(root=root, image_size=ds.image_size, batch_size=tcfg.batch_size,
                            max_boxes=ds.max_boxes, num_workers=ds.num_workers,
                            train_split="train", val_split="val",
                            augmentation_config=tcfg.augmentation)
        dm.setup()
        t0 = time.perf_counter()
        n_loaded = sum(1 for _ in dm.train_dataloader())
        loader_batches_per_s = n_loaded / (time.perf_counter() - t0)
        zero_counts()
        t0 = time.perf_counter()
        summary = train.main(["--config", cfg_path])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = kernel_counts()
        with open(tcfg.metrics_log) as f:
            log = [json.loads(line) for line in f]
        step_ms = [(b["time"] - a["time"]) * 1e3 for a, b in zip(log, log[1:])]
        n_steps, n_val = DATA_TRAIN // DATA_TRAIN_BATCH, DATA_VAL // DATA_TRAIN_BATCH
        want = {"mhc_block": 0, "mhc_block_unfolded": KERNEL_SITES * n_val,
                "sinkhorn_forward": (3 * n_steps + n_val) * n_widths,
                "sinkhorn_backward": 2 * n_widths * n_steps}
        row = {"phase": "data_train", "image": ds.image_size, "batch": tcfg.batch_size,
               "steps": summary["steps"], "num_classes": summary["num_classes"],
               "wall_s": wall_s, "loader_batches_per_s": loader_batches_per_s,
               "loader_batches": n_loaded, "step_ms_median": float(np.median(step_ms)),
               "steps_per_s": 1e3 / float(np.median(step_ms)),
               "loader_sets_the_pace": loader_batches_per_s < 1e3 / float(np.median(step_ms)),
               "train_loss": summary["train_loss"], "best_val_loss": summary["best_val_loss"],
               "launches": counts, "card": card}
        print(json.dumps(row), flush=True)
        if (summary["steps"], summary["num_classes"], n_loaded) != (n_steps, DATA_CLASSES,
                                                                     n_steps) \
                or counts != want:
            fail(f"data: train from disk: {row}; expected {n_steps} steps of "
                 f"{DATA_CLASSES} classes and launches {want}")
        if not np.isfinite(summary["train_loss"] + [summary["best_val_loss"]]
                           + [r["loss"] for r in log]).all():
            fail(f"data: train from disk: non-finite losses {row}")
        for k in launches:
            launches[k] += counts[k]
        gc.collect()
        torch.cuda.empty_cache()

        # 3c. train_multitask from the dense dataset on disk, 2 chunks.
        zero_counts()
        prepared, report = train_multitask.run(train_multitask.parse_args([
            "--data-root", dense_root, "--size", str(DATA_DENSE_IMAGE), "--steps",
            str(DATA_CHUNKS * DATA_CHUNK_STEPS), "--chunk-steps", str(DATA_CHUNK_STEPS),
            "--output", f"{workdir}/multitask.json"]))
        torch.cuda.synchronize()
        chunk, ev = prepared.chunk, prepared.evaluator
        row = {"phase": "data_multitask", "image": chunk.out_size, "batch": chunk.batch_size,
               "train_images": report["train_images"],
               "ms_per_step": [t["wall_ms"] / chunk.chunk_steps for t in chunk.timings],
               "before": report["before"], "after": {k: v for k, v in report["after"].items()
                                                     if np.isscalar(v)},
               "launches_per_step": chunk.launches, "replays": chunk.replays,
               "launches_per_val_batch": ev.launches, "val_replays": ev.replays, "card": card}
        print(json.dumps(row), flush=True)
        if (chunk.launches, chunk.replays) != (want_step, steps) or ev.launches != want_val \
                or ev.replays != 2 * ev.n_batches or report["train_images"] != DATA_DENSE_TRAIN:
            fail(f"data: train_multitask from disk: {row}; expected {want_step} per step over "
                 f"{steps} replays and {want_val} per validation batch, twice")
        if not all(np.isfinite(v) for side in ("before", "after") for v in row[side].values()):
            fail(f"data: train_multitask from disk: non-finite metrics {row}")
        add_replayed(launches, chunk, ev)
        del prepared, chunk, ev
        gc.collect()
        torch.cuda.empty_cache()

        # 4. Evaluate the val split with the train_device checkpoint.
        zero_counts()
        result = evaluate.run(evaluate.parse_args([
            "--data-root", root, "--split", "val", "--checkpoint", checkpoint, "--image-size",
            str(DATA_IMAGE), "--output", f"{workdir}/evaluation.json"]))
        counts = kernel_counts()
        engine, dets, report = result.engine, result.detections, result.report
        replays = sum(engine.replays.values())
        captures = len(engine.replays)
        # The same frames again on the warm graph (the run's first image
        # paid for the capture): decode and infer per image.
        t0 = time.perf_counter()
        again = [engine.infer(cv2.imread(f"{root}/val/{im['file_name']}"))
                 for im in result.dataset.images]
        warm_s = time.perf_counter() - t0
        same = [np.array_equal(a.boxes, d.boxes) and np.array_equal(a.scores, d.scores)
                and np.array_equal(a.classes, d.classes) for a, d in zip(again, dets)]
        recomputed = DetectionEvaluator(num_classes=DATA_CLASSES)
        for i, d in enumerate(dets):
            recomputed.add_image(d.boxes, d.scores, d.classes,
                                 *evaluate.ground_truth(result.dataset, i))
        acc = {k: v for k, v in recomputed.evaluate().items() if not isinstance(v, dict)}
        synthetic = evaluate.main(["--synthetic"])
        row = {"phase": "data_evaluate", "image": DATA_IMAGE, "images": len(dets),
               "seconds": result.seconds, "images_per_s": len(dets) / result.seconds,
               "ms_per_image": result.seconds / len(dets) * 1e3,
               "warm_ms_per_image": warm_s / len(dets) * 1e3,
               "warm_images_per_s": len(dets) / warm_s,
               "engine_p50_ms": report["performance"].get("p50_latency_ms"),
               "detections": int(sum(len(d) for d in dets)),
               "mAP@0.5": report["accuracy"]["mAP@0.5"],
               "mAP@[.5:.95]": report["accuracy"]["mAP@[.5:.95]"],
               "note": "figures of a 20-step checkpoint, not an accuracy",
               "replays": replays, "graphs": captures, "kernel_sites": engine.kernel_sites,
               "mhc_block_host_launches": counts["mhc_block"],
               "detections_equal_infer": sum(same), "evaluator_equal_recomputed":
               acc == report["accuracy"], "synthetic_self_check": synthetic["mAP@0.5"],
               "p95_latency_ms": report["performance"].get("p95_latency_ms"),
               "stability": report["stability"], "card": card}
        print(json.dumps(row), flush=True)
        if engine.kernel_sites != KERNEL_SITES or replays != len(dets) or captures != 1 \
                or counts["mhc_block"] != KERNEL_SITES * (WARMUP_CALLS + 1):
            fail(f"data: evaluate launched {row}; expected one graph with "
                 f"{KERNEL_SITES} kernel-A sites, one replay per image")
        if len(dets) != DATA_VAL or sum(same) != len(dets) or acc != report["accuracy"] \
                or synthetic["mAP@0.5"] != 1.0:
            fail(f"data: evaluate: {row}")
        launches["mhc_block"] += replays * KERNEL_SITES
        del engine, result, again
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a CUDA card")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"phase": "device", "card": card, "kind": kind,
                      "sm_clock_max_mhz": nvidia_smi("clocks.max.sm"),
                      "count": torch.cuda.device_count(), "torch": torch.__version__,
                      "cuda": torch.version.cuda, "port": hvs_tpu_torch.__name__}), flush=True)
    sm_clock_hz = float(nvidia_smi("clocks.max.sm")) * 1e6
    t0 = time.perf_counter()
    build.build(["mhc_block", "sinkhorn"])
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "per_source_s": build.build_seconds}), flush=True)

    # The kernel phases hold each kernel against a plain version whose
    # result does not depend on these flags; every later phase starts from
    # torch's own flags and must find them pinned by the package.
    defaults = read_flags()
    print(json.dumps({"phase": "flags", "torch_defaults": defaults}), flush=True)
    per_shape = phase_kernels(card)
    sink_rows, sink_mix = phase_sinkhorn(card, sm_clock_hz)
    unfolded_rows = phase_unfolded(card)
    serve_launches = entry_point_phase(phase_serve, defaults, card)
    entry_point_phase(phase_parity, defaults, card)
    entry_point_phase(phase_engine, defaults, card)
    deployment = entry_point_phase(phase_deployment, defaults, card)
    train_launches = entry_point_phase(phase_train, defaults, card)
    chunked_launches = entry_point_phase(phase_train_chunked, defaults, card)
    entry_point_phase(phase_train_parity, defaults, card)
    multitask_launches = entry_point_phase(phase_multitask, defaults, card)
    light = entry_point_phase(phase_lightweight, defaults, card, sm_clock_hz)
    data = entry_point_phase(phase_data, defaults, card)

    kernels = [
        kernel_summary({**per_shape, **light["a_rows"]}, serve_launches, light["mhc_block"],
                       deployment["mhc_block_exported"]),
        *sinkhorn_summary({**sink_rows, **light["b_rows"]}, [sink_mix, light["b_mix"]],
                          train_launches, chunked_launches, multitask_launches),
        unfolded_summary(unfolded_rows, train_launches["mhc_block_unfolded"],
                         chunked_launches["mhc_block_unfolded"],
                         multitask_launches["mhc_block_unfolded"])]
    for k in kernels:
        k["launches_data"] = data[k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
