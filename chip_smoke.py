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
     18 sites beside the time recorded before their redesign; A and C also
     at every width on inputs whose residual sum is ill-conditioned (the
     sum and LN2 in fp32; ``ILL_ROWS``) and on inputs ill-conditioned in
     their GELUs (H_post near 1; against the plain version and, beside it,
     against an fp64 evaluation; ``GELU_FP64_MARGIN``);
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
     bundle: every provider's cloud bundle generated and parsed; the file
     set that ``Dockerfile.inference``'s build stage copies, staged in a
     temp directory, where ``python -m hvs_tpu_torch.build`` builds the
     kernels (build s); ``entrypoint.sh api`` from that copy serving the
     flagship at 640² from a checkpoint (startup s to the first 200 on
     ``/health``), 4 720x1280 JPEGs through ``/detect`` against an
     in-process engine, ``entrypoint.sh healthcheck`` (the probe: A and B
     once each against their plain versions), SIGTERM (shutdown s), and the
     deploy tool's ``docker``, ``k8s`` and ``edge`` dry runs;
  7. infer: ``python -m hvs_tpu_torch.infer`` in-process (``infer.main``)
     on one 720x1280 JPEG, a directory of 8, a 24-frame MJPG clip and the
     synthetic camera, from a checkpoint the port trainer saved with EMA
     weights: ``results.json``'s keys as ``scripts/inference.py`` writes
     them, each image's detections bitwise ``engine.infer``'s, kernel A at
     18 launches per replay, B at 25 at each load, the EMA weights served;
     hard, soft and matrix NMS in one engine's graphs at buckets 1 and 16
     (each replay bitwise its eager run; device ms and launches per replay;
     a hot swap under soft NMS; the card's NMS against the CPU's on the same
     head outputs, within the bound ``nms_rtol`` states);
     ``InferenceProfiler`` over the buckets and ``ModelProfiler``'s
     ``cost_analysis`` of the b16 forward;
  8. train: the full-width ``HybridVisionSystem`` (telemetry on, the JAX
     dropout rates, bf16) trained by ``ManifoldConstrainedTrainer.train`` on
     the synthetic batches of ``hvs_tpu_torch.train`` (416², batch 8, 8
     classes, 64 boxes) for a few steps with a projection inside, then
     validated over 2 batches; counters zeroed just before, read just after;
  9. train_chunked: the on-device loop (``train_chunked``) with
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
 10. train_parity: one train step, dropout off, the full-width model at 320²,
     batch 2: the card (kernels) against the CPU (plain versions);
     train_trajectory: 80 steps of the full-width model in bf16 (dropout
     off) through the captured chunk steps at 128² and 160² alternating, a
     warm-up of 30, a projection at step 60, the EMA on, against the same
     steps on this machine's CPU fed the same draws: 20-step window means of
     the loss within 10 % and the largest grad norm after step 20 within
     JAX's own bf16/fp32 spread;
     ddp: ``train_device``'s captured step at 416² batch 16 data-parallel
     over an NCCL process group of one process (its all-reduces captured),
     against the step without a process group from the same state, with the
     step's ms with and without the all-reduce, and a captured validation
     pass;
     tp: tensor parallelism, two processes spawned on the one card over
     gloo (a 1 x 2 mesh, each holding its blocks of the rule-matched
     parameters): the ``train`` phase's flagship at 416² batch 8 trained
     4 steps (a projection at step 4) and validated over 2 batches through
     ``ManifoldConstrainedTrainer.train``, against the same run in this
     process (step 1 at the bf16 train-parity limits, the later steps at
     the trajectory limits), then 4 steps in fp32, conditioned as the
     train_parity step (dropout off, H_res near a scaled identity), held
     step by step; B
     per step and C per validation batch (on gathered weights) counted on
     each process; the checkpoint reloaded bit-exact into one process and
     served by ``Detector`` at 640² batch 1 (A at its 18 sites against its
     plain version); ms per step of two processes sharing the card;
 11. multitask: ``python -m hvs_tpu_torch.train_multitask``'s run at its
     defaults (the flagship with the segmentation and depth heads, 8
     classes, 320², batch 8) on 800 synthetic dense images: its set-up
     (data on the card, the captured step and evaluation), 2 chunks of 10
     captured steps and one captured validation pass over 100 images; ms
     and device ms per step, capture s, peak memory, the parameter count
     against the JAX model's; the launches per captured step (B 15 forward,
     10 backward) and per validation batch (B 5, C 18); a replay against
     the eager step from one state; the dense labels reaching the loss at
     the heads' stride; one multi-task step CUDA against CPU in fp32;
 12. lightweight: ``LightweightHybridVision`` with the serving flags served
     by ``Detector`` at 640², batch 16 and batch 1 (frames/s, ms/frame, 6
     kernel-A launches per forward at d = 128, B once per matrix at load),
     CUDA against CPU at 320²; kernel A at its 6 sites of both batches, and
     kernel B forward and backward at the bottleneck widths 24, 48, 96 and
     192 and over its 13 matrices in one grouped call, against their plain
     versions;
 13. data: the data and evaluation layer through its entry points: a shapes
     dataset generated at 640² (8 classes) and a dense one at 320², each
     split's JSON held against its files and an image regenerated alone;
     both decoded (``load_coco_arrays``) and uploaded, the card's tensors
     equal to the host arrays; ``train_device``, ``train`` (through
     ``COCODataModule``: the host loader's batches/s beside the eager step)
     and ``train_multitask`` trained from those files (B 15 + 10 per step,
     C 18 per validation batch); ``evaluate`` of the val split with the
     ``train_device`` checkpoint (A at 18 per replay, each image's
     detections equal to ``engine.infer`` of its frame, the evaluator's
     numbers equal to a recomputation, the ``--synthetic`` self-check at 1.0);
 14. int8: int8 serving of the flagship at 640² (``phase_int8``): calibration
     on 16 generated frames, an engine per variant (int8, int8_fpn, int8_mhc,
     int8_vit, int8_all) at buckets 1 and 16 with kernel A at 18, 18, 7, 17
     and 6 sites per replay, each replay bitwise its eager serve function,
     device ms beside bf16's, raw head outputs against bf16's, ``_int_mm``'s
     accumulators against the plain integer product at every product shape
     of a b16 forward, and a ``reload`` of scales taking effect;
 15. rag: the flagship with ``rag.enabled`` and the 8 shapes classes, the
     gate open (``phase_rag``): ``InferenceEngine`` at 640² with graphs at
     buckets 1 and 16 (A at 19 sites per replay, B at 26 matrices at load
     and per ``reload``, each replay bitwise its eager run), kernel A at
     the knowledge module's site against its plain version, a ``reload``
     and ``rebuild_serve_fns``, the ``.pt2`` export (19 launches per call),
     the card against the CPU, and ``train_device --use-rag``'s captured
     steps and validation pass (C at 19 per batch);
 16. manifold_attention: ``HybridVisionEncoder`` with
     ``use_manifold_attention`` at the flagship's ViT widths in bf16 on the
     scale_large map of a 640² batch of 16 (``phase_manifold_attention``):
     10 eager training steps (B per mHC layer forward and backward, the
     regulariser's and the optimizer's grouped projections), the serve
     encoder (B 31 at load, A 1 per forward) against the CPU, and a
     deterministic forward (C 1);
 17. bench (after ``data``, on its work directory): the measurement and
     accuracy entry points run as a user runs them, each a subprocess
     (``phase_bench``): ``bench`` at its defaults and int8 on conditioned
     weights (one line with ``bench.py``'s keys, the replay equal to an
     eager call, A 18 per forward, B 25 at load), ``benchmark`` (its three
     files, memory by batch), ``accuracy_sweep`` of phase ``data``'s
     checkpoint (its 640² entry equal to that phase's ``evaluate``),
     ``summarize_run`` of that run (equal to ``torch_run_summary.py``), and
     ``serve_bench`` closed, rated (nothing shed) and overload (some shed);
 18. roofline (after ``bench``; ``phase_roofline``): the operation count
     (``ModelProfiler.cost_analysis``) of a 320² b2 serve forward, a 416² b2
     validation forward and a 416² b2 train step equal on the card and on
     the CPU, kernel C counted at 10·N·d² at its 18 sites; the roofline
     tools in this process at cut sizes (``roofline`` at buckets 8 and 16
     with ``mfu`` and ``hbm_utilization`` in (0, 1.05], ``bytes_attribution``
     with its stages summing to the serve call, ``train_roofline`` at 416²
     b16, both ceilings, ``cls_loss_ab`` at 2 x 10 steps), and the
     detection path without mHC (``use_mhc=False``): no A and no B;
 19. tours (``phase_tours``): the six runnable tours (``examples/torch_*.py``)
     at their default, full-width sizes, each a process of its own, all at
     once: exit 0, the summary line within ``tests/test_torch_tours.py``'s
     limits (nb_02's count equal to this process's count of the same
     forward), A launched by the engines' tours and B by every tour that
     loads the flagship; the kernels line's ``launches_tours``.
Phase 2's Sinkhorn part also runs the public projections that launch B
(``project_to_doubly_stochastic``, ``birkhoff_project``,
``sinkhorn_with_diagnostics``) and the Stiefel and SPD functions on the card
against the CPU in fp64 (``math_ops_check``).
The package pins its matmul precision flags itself (fp32 accumulation;
``hvs_tpu_torch.device.pin_matmul_precision``): this script never pins
them. It puts back torch's own flags before each phase that goes through an
entry point (3-15) and fails unless they are pinned after it (phase 16
builds the encoder directly and pins them as those entry points do; the
entry points of phase 17 and the tours of phase 19 run in processes of their
own, each from torch's own flags); the plain
versions of A and C sum their products in fp32 whatever the flags.
The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every kernel of the port with its measurements.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

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
# The manifold_attention phase: HybridVisionEncoder at the flagship's ViT
# widths (cnn 512, dim 256, depth 6, 8 heads) with use_manifold_attention,
# bf16, on a seeded scale_large map of a 640² batch of 16 (20 x 20 tokens +
# cls); 10 eager training steps (projection every 5), then the serve encoder
# and a deterministic forward; the serve encoder against the CPU at batch 2.
MA_BATCH, MA_GRID, MA_CHANNELS, MA_DIM, MA_DEPTH, MA_HEADS = 16, 20, 512, 256, 6, 8
MA_STEPS, MA_WARMUP, MA_PROJECT_EVERY, MA_LR, MA_CPU_BATCH = 10, 2, 5, 1e-4, 2
# The math ops on the card against the CPU in fp64 (the sinkhorn phase): on
# well-conditioned inputs (SPD eigenvalues in [0.5, ~4], random frames whose
# principal angles lie away from 0) fp32 QR, solve, SVD and eigh agree with
# fp64 to ~n·eps·cond, 1e-5 relative at these sizes; 1e-4 allows for it.
MATH_FP32_RTOL = 1e-4
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

# Kernel-vs-plain criteria: the two compute the same roundings (the kernel's
# GELU takes the exact tanh in PyTorch's order); they differ where fp32
# accumulation order flips a bf16 rounding (the final LayerNorm can amplify
# such a flip). Sound
# builds read corr >= 0.99998 and mean |diff| <= 1e-3 at every main-path
# shape; a build without the GELU reads corr 0.9922-0.9989 and mean |diff|
# 0.036-0.100 there (PERF.md), so the limits sit between the two, tighter
# than tests/test_pallas.py's 0.999 / 0.05.
KERNEL_MIN_CORR = 0.9999
KERNEL_MAX_MEAN_ABS = 5e-3
# Ill-conditioned inputs (the kernel and unfolded phases, ILL_ROWS rows at
# every width): x = 3 ± 0.3 and a near-uniform H_res (Sinkhorn of 0.1·noise),
# so x @ H_res is ~3 in every channel with a spread under one bf16 step of 3,
# and a small H_post (0.05·N(0, 1/d)), so y @ H_post carries the row's
# spread. Their sum is what a bf16 rounding destroys: a plain chain that
# rounds it reads corr 0.971-0.978 against the fp32 sum, while a 2^-12
# relative change of tanh in the GELUs leaves 0.999995
# (scripts/torch_mhc_sum_conditioning.py).
ILL_ROWS = 4096
# GELU-conditioned inputs (the rows kernel_gelu_conditioned, ILL_ROWS rows at
# every width): the ill-conditioned ones with H_post = 2·sigmoid(0.01·noise),
# near 1 everywhere, as an mHC layer at its init scale and trained sites
# whose H_post stays there. y @ H_post then carries little spread across
# channels and LN2 amplifies the last bit of each GELU output: a 2^-12
# relative change of tanh alone (about the hardware tanh's error) takes the
# plain chain to corr 0.77-0.92 against itself. Each row holds the kernel's
# corr to an fp64 evaluation of the same chain (rounding nowhere) no more
# than GELU_FP64_MARGIN below the plain version's: the kernel may be no
# farther from the exact function than its plain version. The rows of
# GELU_CORR_GATED are also held against the plain version at
# KERNEL_MIN_CORR / KERNEL_MAX_MEAN_ABS; the others stay under that limit
# with the exact tanh, so they gate on the fp64 reading alone. On the H100
# (NVIDIA H100 80GB HBM3, 700 W) the kernels with the exact tanh read corr
# 0.99985 / 0.99970 / 0.99921 / 0.99741 / 0.99217 (A) and 0.99995 / 0.99979 /
# 0.99930 / 0.99561 / 0.98573 (C) at d = 32 ... 512 against their plain
# versions: the products' fp32 summation order still flips a bf16 rounding
# before a GELU now and then, and LN2 spreads it (the hardware tanh read
# 0.929-0.994; PERF.md, ROADMAP §3).
GELU_FP64_MARGIN = 1e-3
GELU_CORR_GATED = {("mhc_block_unfolded", 32)}

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

# The train_trajectory phase: the full-width flagship (8 classes, bf16,
# dropout off) trained on the card through its captured TrainChunk steps and
# on this machine's CPU through the same chunk bodies eagerly, fed the
# card's draws, from the same weights: sizes 128² and 160² alternating by
# chunk of 10, batch 4, warm-up 30 (the peak rate reached), step 60 a
# projection step, EMA 0.999, 64 shapes-benchmark frames at 160². The card
# and the CPU run one program in bf16 and differ by rounding alone. The loss
# limit: 20-step window means within 10 %, between JAX's own seed-to-seed
# spread at this configuration on the CPU (6.0 %) and its bf16-to-fp32 spread
# (18.5 %) (scripts/torch_train_parity.py trajectory, 200 steps). The grad
# norm: the largest after the first 20 steps (the init transient, where bf16
# rounding at init sets every run's largest), within JAX's bf16-to-fp32
# spread of that largest, a factor 1.80 either way (the same record).
TRAJ_SIZES, TRAJ_BATCH, TRAJ_CHUNK, TRAJ_STEPS, TRAJ_WINDOW = (128, 160), 4, 10, 80, 20
TRAJ_PROJECT_EVERY = 60  # 20 steps of the run follow the projection
TRAJ_IMAGES, TRAJ_IMAGE, TRAJ_WARMUP, TRAJ_CLASSES, TRAJ_BOXES = 64, 160, 30, 8, 16
TRAJ_LOSS_WINDOW_RTOL = 0.10
TRAJ_TRANSIENT = 20
TRAJ_GRAD_NORM_RATIO = 1.80
# The ddp phase: train_device's captured step at 416² batch 16 (80 classes),
# data parallel over an NCCL process group of one process (a localhost TCP
# store), against the same step without a process group; 64 seeded 640²
# images, validation over 16 at 640² batch 4.
DDP_IMAGE, DDP_BATCH, DDP_IMAGES, DDP_VAL_IMAGES, DDP_VAL_BATCH = 416, 16, 64, 16, 4
# The tp phase: the train phase's model and batches (416², batch 8, 8
# classes, bf16, telemetry and dropout on) trained through
# ManifoldConstrainedTrainer.train by TP_MODEL processes that share the card
# over gloo (a 1 x TP_MODEL mesh), against the same steps in one process from
# the same weights and generator: TP_STEPS steps at the peak rate (no
# warm-up), step TP_PROJECT_EVERY a projection step, validation over
# TP_VAL_BATCHES batches. The checkpoint is then served at 640² batch 1. The
# same steps in fp32 (no validation) follow, uncounted.
TP_MODEL, TP_STEPS, TP_PROJECT_EVERY, TP_VAL_BATCHES = 2, 4, 4, 2
TP_TIMEOUT_S = 600  # the workers' deadline, after which they are killed
# (run, dtype, validation batches): the counted bf16 run at the train phase's
# weights (init scale, dropout on), then fp32 conditioned as train_parity's
# step (dropout off, H_res near a scaled identity; ``condition``).
TP_RUNS = (("tp", torch.bfloat16, TP_VAL_BATCHES), ("tp32", torch.float32, 0))
# The limits. Step 1 starts both runs from the same weights, batch and
# dropout masks: the train-parity limits of its dtype (TRAIN_PARITY). Later
# steps start from weights up to 2·lr apart per element per step (Adam's
# first steps are about ±lr per element, and a gradient at rounding noise
# flips its sign), and in bf16 the mHC layers at their init scale amplify a
# last-bit change (H_post near 1; GELU_FP64_MARGIN's comment): on the card
# step 1 read 1.3 % / 1.9 % (loss / grad norm) and steps 2-4 up to 7 % / 40 %,
# where the CPU's fp32 run of the same steps agreed within 3e-5 / 1e-4. So
# in bf16 the later steps are held as train_trajectory holds the card
# against the CPU: the run's mean loss within TRAJ_LOSS_WINDOW_RTOL and its
# largest grad norm after step 1 within TRAJ_GRAD_NORM_RATIO either way;
# in fp32, conditioned as train_parity's step, every step is held at the
# fp32 train-parity limits (at the init scale with dropout on, fp32 read
# 3.7e-4 at step 1 and 2.7 % by step 3 on the card). In both, the
# mHC partitions' update cosine above its limit, and every parameter within
# the most two AdamW runs can part in TP_STEPS steps (tp_param_limit).


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


def timed(phase, *args):
    """``phase(*args)``, with its wall seconds printed after it (the script
    has a time limit; this says where it goes)."""
    t0 = time.perf_counter()
    result = phase(*args)
    print(json.dumps({"phase_seconds": phase.__name__, "seconds": time.perf_counter() - t0}),
          flush=True)
    return result


def entry_point_phase(phase, defaults: dict, *args):
    """Run one phase that goes through the package's entry points, starting
    from torch's own flags (``defaults``, read before any phase ran), and
    fail unless those entry points pinned the flags themselves: this script
    never pins them."""
    set_flags(defaults)
    result = timed(phase, *args)
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


def mhc_inputs(n: int, d: int, seed: int, ill: bool = False, h_post_near_1: bool = False):
    """Seeded kernel inputs on the card. H_res is near-identity
    (sinkhorn(6·I + noise)); W1/W2 are lecun-scaled and H_post is scaled by
    1/sqrt(d), so the pre-LN2 signal is O(1) and not a near-constant row that
    LN2 would cancel into rounding noise. ``ill``: the residual sum
    ill-conditioned instead (as ``ILL_ROWS`` describes); with
    ``h_post_near_1`` also the GELUs (``GELU_FP64_MARGIN``'s comment)."""
    r = np.random.default_rng(seed)
    dev = torch.device("cuda")
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    x = t((3.0 + 0.3 * r.standard_normal((n, d))) if ill else r.standard_normal((n, d)), bf)
    w1 = t(r.standard_normal((d, d)) / math.sqrt(d), bf)
    w2 = t(r.standard_normal((d, d)) / math.sqrt(d), bf)
    if ill:
        h_post = t(2.0 / (1.0 + np.exp(-0.01 * r.standard_normal((d, d)))) if h_post_near_1
                   else 0.05 * r.standard_normal((d, d)) / math.sqrt(d), bf)
        h_res = sinkhorn_log(t(0.1 * r.standard_normal((d, d))), 20).to(bf)
    else:
        h_post = t(2.0 / (1.0 + np.exp(-0.1 * r.standard_normal((d, d)))) / math.sqrt(d), bf)
        h_res = sinkhorn_log(t(6.0 * np.eye(d) + r.standard_normal((d, d))), 20).to(bf)
    b1, b2 = t(0.01 * r.standard_normal(d)), t(0.01 * r.standard_normal(d))
    ln = [t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d)),
          t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d))]
    return x, (w1, b1, w2, b2, h_post, h_res.contiguous(), *ln)


def phase_kernels(card: str, shapes=None):
    """Kernel A against its plain version at every main-path shape: the 18
    sites of every engine bucket (which include the serve phase's batch 1
    and 16), a ragged count and the ill-conditioned rows at every width (or
    at the (tokens, d) pairs of ``shapes`` only, to time a few quickly)."""
    ill = shapes is None
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
    for d in mhc_mod.SUPPORTED_WIDTHS if ill else ():
        x, args = mhc_inputs(ILL_ROWS, d, seed=d, ill=True)
        per_shape[("ill", d)] = ill_conditioned_check(
            "mhc_block", d, mhc_mod.mhc_block(x, *args), mhc_mod.mhc_block_plain(x, *args), card)
    for d in mhc_mod.SUPPORTED_WIDTHS if ill else ():
        x, args = mhc_inputs(ILL_ROWS, d, seed=d, ill=True, h_post_near_1=True)
        per_shape[("gelu", d)] = gelu_conditioned_check(
            "mhc_block", x, args, mhc_mod.mhc_block(x, *args), mhc_mod.mhc_block_plain(x, *args),
            card)
    return per_shape


def mhc_chain64(x, w1, b1, w2, b2, h_post, h_res, ln1s, ln1b, ln2s, ln2b, h_pre=None):
    """The mHC block in fp64 on the given operands, rounding nowhere (exact
    tanh GELUs, two-pass LayerNorms with eps 1e-6)."""
    def ln(v, scale, bias):
        mu = v.mean(-1, keepdim=True)
        var = (v - mu).square().mean(-1, keepdim=True)
        return (v - mu) / torch.sqrt(var + 1e-6) * scale.double() + bias.double()

    f64 = lambda t: t.double()  # noqa: E731
    x = f64(x)
    y = ln(x, ln1s, ln1b)
    if h_pre is not None:
        y = y @ f64(h_pre)
    y = F.gelu(y @ f64(w1) + f64(b1), approximate="tanh")
    y = F.gelu(y @ f64(w2) + f64(b2), approximate="tanh")
    return ln(x @ f64(h_res) + y @ f64(h_post), ln2s, ln2b)


def gelu_conditioned_check(kernel: str, x, args, out, ref, card: str, h_pre=None) -> dict:
    """A kernel on the GELU-conditioned inputs: its corr to the fp64 chain
    no more than ``GELU_FP64_MARGIN`` below the plain version's, and, for
    the rows of ``GELU_CORR_GATED``, against its plain version at
    ``KERNEL_MIN_CORR`` / ``KERNEL_MAX_MEAN_ABS``."""
    torch.cuda.synchronize()
    exact = mhc_chain64(x, *args, h_pre=h_pre).flatten().cpu().numpy()
    a = out.float().flatten().cpu().numpy()
    b = ref.float().flatten().cpu().numpy()
    d = x.shape[1]
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        fail(f"{kernel} GELU-conditioned d={d}: non-finite output")
    corr = float(np.corrcoef(a, b)[0, 1])
    mean_abs = float(np.mean(np.abs(a - b)))
    k64, p64 = float(np.corrcoef(a, exact)[0, 1]), float(np.corrcoef(b, exact)[0, 1])
    row = {"phase": "kernel_gelu_conditioned", "kernel": kernel, "n": x.shape[0], "d": d,
           "corr": corr, "mean_abs_err": mean_abs, "max_abs_err": float(np.max(np.abs(a - b))),
           "kernel_vs_fp64_corr": k64, "plain_vs_fp64_corr": p64,
           "kernel_vs_fp64_mean_abs": float(np.mean(np.abs(a - exact))),
           "plain_vs_fp64_mean_abs": float(np.mean(np.abs(b - exact))),
           "gated_on": "plain and fp64" if (kernel, d) in GELU_CORR_GATED else "fp64",
           "card": card}
    print(json.dumps(row), flush=True)
    if (kernel, d) in GELU_CORR_GATED and not (corr > KERNEL_MIN_CORR
                                               and mean_abs < KERNEL_MAX_MEAN_ABS):
        fail(f"{kernel} d={d} disagrees with its plain version on GELU-conditioned inputs: "
             f"corr {corr} (need > {KERNEL_MIN_CORR}), mean |diff| {mean_abs} "
             f"(need < {KERNEL_MAX_MEAN_ABS})")
    if not k64 >= p64 - GELU_FP64_MARGIN:
        fail(f"{kernel} d={d} lies farther from the fp64 chain than its plain version on "
             f"GELU-conditioned inputs: corr {k64} against {p64} (margin {GELU_FP64_MARGIN})")
    return row


def ill_conditioned_check(kernel: str, d: int, out, ref, card: str) -> dict:
    """A kernel's output on the ill-conditioned inputs (``ILL_ROWS``) against
    its plain version's, at ``KERNEL_MIN_CORR``; a build that rounds the
    residual sum fails it."""
    torch.cuda.synchronize()
    a = out.float().flatten().cpu().numpy()
    b = ref.float().flatten().cpu().numpy()
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        fail(f"{kernel} ill-conditioned d={d}: non-finite output")
    corr = float(np.corrcoef(a, b)[0, 1])
    mean_abs = float(np.mean(np.abs(a - b)))
    row = {"phase": "kernel_ill_conditioned", "kernel": kernel, "n": ILL_ROWS, "d": d,
           "corr": corr, "mean_abs_err": mean_abs, "max_abs_err": float(np.max(np.abs(a - b))),
           "card": card}
    print(json.dumps(row), flush=True)
    if not (corr > KERNEL_MIN_CORR and mean_abs < KERNEL_MAX_MEAN_ABS):
        fail(f"{kernel} d={d} disagrees with its plain version on ill-conditioned inputs: "
             f"corr {corr} (need > {KERNEL_MIN_CORR}), mean |diff| {mean_abs} "
             f"(need < {KERNEL_MAX_MEAN_ABS})")
    return row


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


def conditioned_params(seed: int, mcfg=None) -> dict:
    """Seeded flagship weights (the port's named parameters, on the card; the
    model of ``mcfg``, default the flagship's config) with the prediction
    convs conditioned as in ``tests/test_torch_serve.py``: kernels x4,
    objectness bias 1, class biases N(0, 1). At plain random init no score
    reaches the 0.25 threshold and the engine checks would compare empty
    outputs."""
    from hvs_tpu_torch.config import ModelConfig

    model = (mcfg or ModelConfig()).build_model(production=True, seed=seed)
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
                    r.standard_normal(tuple(bias[:, 5:].shape)).astype(np.float32)).to(bias.device)
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
# Deployment bundles: the image's file set, its entrypoint and probe

BUNDLE_FRAMES = 4
BUNDLE_RAW_HW = (720, 1280)
BUNDLE_STARTUP_TIMEOUT_S = 300
# No generated or shipped deployment file of the port names the TPU stack.
BUNDLE_FORBIDDEN = r"jax|libtpu|google\.com/tpu|gke-tpu|tpu-"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bundle_files_check(workdir: str) -> dict:
    """Every provider's bundle generated and each file parsed; the serving
    manifests ask for one nvidia.com/gpu on an H100 node."""
    import re

    import yaml

    from hvs_tpu_torch.deployment import cloud_codegen

    files, bad = [], []
    for provider in cloud_codegen.PROVIDERS:
        files += cloud_codegen.generate(provider, f"{workdir}/bundles")
    for path in files:
        with open(path) as f:
            text = f.read()
        try:
            if path.endswith(".yaml"):
                list(yaml.safe_load_all(text))
            elif path.endswith(".py"):
                compile(text, path, "exec")
            elif path.endswith(".sh"):
                subprocess.run(["bash", "-n", path], check=True, capture_output=True)
        except Exception as e:  # reported below
            bad.append(f"{path}: {e}")
        if re.search(BUNDLE_FORBIDDEN, text, re.IGNORECASE):
            bad.append(f"{path} names the TPU stack")
    with open(f"{workdir}/bundles/gke-gpu/deployment.yaml") as f:
        pod = yaml.safe_load(f)["spec"]["template"]["spec"]
    container = pod["containers"][0]
    row = {"phase": "bundle_files", "providers": len(cloud_codegen.PROVIDERS),
           "files": len(files), "bad": bad,
           "gpu_limit": container["resources"]["limits"].get("nvidia.com/gpu"),
           "node_selector": pod["nodeSelector"],
           "startup_probe": container.get("startupProbe")}
    print(json.dumps(row), flush=True)
    if bad or row["gpu_limit"] != "1" or "h100" not in str(pod["nodeSelector"]) \
            or not row["startup_probe"]:
        fail(f"bundle files: {row}")
    return row


def dry_runs_check() -> dict:
    """``docker``, ``k8s`` and ``edge --host localhost`` of the deploy tool
    with ``--dry-run``: their printed commands."""
    import io

    from hvs_tpu_torch import deploy

    printed = {}
    for name, argv in (("docker", ["docker", "--dry-run"]), ("k8s", ["k8s", "--dry-run"]),
                       ("edge", ["edge", "--host", "localhost", "--dry-run"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = deploy.main(argv)
        printed[name] = [line[2:] for line in out.getvalue().splitlines() if line.startswith("$ ")]
        if rc != 0:
            fail(f"bundle: deploy {name} --dry-run exit {rc}: {printed[name]}")
    edge = printed["edge"]
    checks = {
        "docker_builds_the_image": any(c.startswith("docker build -f") and
                                       c.split()[3].endswith("Dockerfile.inference")
                                       for c in printed["docker"]),
        "k8s_applies_every_manifest": sum(c.startswith("kubectl apply") for c in printed["k8s"])
        == 6 and printed["k8s"][-1].startswith("kubectl rollout status"),
        "edge_checks_the_card_first": bool(edge) and "compute_cap" in edge[0]
        and any(c.startswith("scp") for c in edge[1:]),
        "edge_runs_infer": any("hvs_tpu_torch.infer --source 0" in c for c in edge)}
    row = {"phase": "bundle_dry_run", "commands": printed, **checks}
    print(json.dumps(row), flush=True)
    if not all(checks.values()):
        fail(f"bundle dry runs: {row}")
    return row


def phase_bundle(card: str) -> dict:
    """The deployment bundle on the card: every provider's bundle generated
    and parsed; exactly the file set that ``Dockerfile.inference``'s build
    stage copies, staged in a temp directory, where ``python -m
    hvs_tpu_torch.build`` builds the kernels with nothing on ``PYTHONPATH``
    but the copy; from that copy, ``entrypoint.sh api`` serving the flagship
    at 640² from a checkpoint of ``conditioned_params(0)`` (seconds to the
    first 200 on ``/health``), 4 JPEG frames of 720x1280 POSTed to
    ``/detect``, each held against ``engine.infer`` of an in-process engine
    on the same checkpoint (``same_detections``' limits, as phase
    ``deployment``), ``entrypoint.sh healthcheck`` (exit 0 and its JSON
    line), SIGTERM to the server (seconds to its exit), and the deploy
    tool's dry runs. Kernel launches in this process: the in-process
    engine's load and replays and one in-process probe (A 1, B 1)."""
    import base64
    import shutil
    import signal
    import tempfile
    import urllib.request

    import cv2

    from hvs_tpu_torch.config import InferenceConfig, ModelConfig
    from hvs_tpu_torch.deployment import image_files, probe
    from hvs_tpu_torch.inference import InferenceEngine
    from hvs_tpu_torch.inference.preprocessing import decode_jpeg

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="hvs_bundle_")
    server = log = None
    try:
        bundle_files_check(workdir)

        # The image's file set, and the image's build step run in it.
        staged = image_files.stage(dest=f"{workdir}/image")
        app = staged["workdir"]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = app
        t0 = time.perf_counter()
        built = subprocess.run([sys.executable, "-m", "hvs_tpu_torch.build"], cwd=app, env=env,
                               capture_output=True, text=True, timeout=900)
        build_s = time.perf_counter() - t0
        libraries = [json.loads(line) for line in built.stdout.splitlines()
                     if line.startswith("{") and '"library"' in line]
        row = {"phase": "bundle_build", "copied": [os.path.relpath(p, workdir)
                                                   for p in staged["written"]],
               "exit": built.returncode, "build_s": build_s,
               "per_source_s": {os.path.basename(r["source"]): r["build_s"] for r in libraries},
               "in_copy": all(r["library"].startswith(app) for r in libraries),
               "card": card}
        print(json.dumps(row), flush=True)
        if built.returncode != 0 or len(libraries) != 2 or not row["in_copy"]:
            fail(f"bundle build: {row}; {built.stderr[-2000:]}")

        # The served subprocess, from the copy, on a checkpoint of seeded weights.
        params = conditioned_params(0)
        checkpoint = f"{workdir}/flagship.pt"
        torch.save({"params": {k: v.cpu() for k, v in params.items()}}, checkpoint)
        del params
        run_dir = f"{workdir}/run"
        os.makedirs(run_dir)
        port = _free_port()
        url = f"http://127.0.0.1:{port}"
        log = open(f"{workdir}/server.log", "w")
        t_start = time.perf_counter()
        server = subprocess.Popen(
            ["sh", f"{workdir}/image/entrypoint.sh", "api", "--checkpoint", checkpoint,
             "--image-size", str(IMAGE)], cwd=run_dir, env=dict(env, PORT=str(port)),
            stdout=log, stderr=subprocess.STDOUT)

        # Meanwhile, the in-process engine on the same checkpoint.
        zero_counts()
        cfg = InferenceConfig()
        cfg.preprocessing.image_size = IMAGE
        cfg.performance.batch_buckets = (1,)
        cfg.checkpoint_path = checkpoint
        engine = InferenceEngine(ModelConfig(), cfg)
        b_at_load = sink_mod.launches_forward
        r = np.random.default_rng(0)
        frames = r.integers(0, 256, (BUNDLE_FRAMES, *BUNDLE_RAW_HW, 3), dtype=np.uint8)
        blobs = [cv2.imencode(".jpg", f)[1].tobytes() for f in frames]
        want = [engine.infer(decode_jpeg(b, IMAGE)) for b in blobs]
        if sum(len(w) for w in want) == 0:
            fail("bundle: no detections on the frames; the comparisons are vacuous")

        startup_s = None
        while time.perf_counter() - t_start < BUNDLE_STARTUP_TIMEOUT_S:
            if server.poll() is not None:
                break
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as resp:
                    if resp.status == 200:
                        startup_s = time.perf_counter() - t_start
                        health = json.loads(resp.read())
                        break
            except OSError:
                time.sleep(0.25)
        if startup_s is None:
            log.flush()
            with open(f"{workdir}/server.log") as f:
                tail = f.read()[-3000:]
            fail(f"bundle: the entrypoint's api server did not answer /health within "
                 f"{BUNDLE_STARTUP_TIMEOUT_S} s (exit {server.poll()}): {tail}")
        detect_ms, mismatched = [], []
        for i, blob in enumerate(blobs):
            t0 = time.perf_counter()
            body = _post(url + "/detect", {"image_base64": base64.b64encode(blob).decode()})
            detect_ms.append((time.perf_counter() - t0) * 1e3)
            if not same_detections(_Response.rest(body), want[i]) \
                    or body["image_size"] != list(BUNDLE_RAW_HW):
                mismatched.append(i)

        # The probe as the container runs it, then once in this process.
        t0 = time.perf_counter()
        checked = subprocess.run(["sh", f"{workdir}/image/entrypoint.sh", "healthcheck"],
                                 cwd=run_dir, env=env, capture_output=True, text=True,
                                 timeout=300)
        probe_s = time.perf_counter() - t0
        lines = [line for line in checked.stdout.splitlines() if line.startswith("{")]
        probe_report = json.loads(lines[-1]) if lines else {}
        a0, b0, c0 = mhc_mod.launches, sink_mod.launches_forward, mhc_mod.launches_unfolded
        in_process = probe.run()
        torch.cuda.synchronize()
        probe_launches = {"mhc_block": mhc_mod.launches - a0,
                          "sinkhorn_forward": sink_mod.launches_forward - b0}

        t0 = time.perf_counter()
        server.send_signal(signal.SIGTERM)
        server_rc = server.wait(timeout=120)
        shutdown_s = time.perf_counter() - t0
        server = None

        launches = {"mhc_block": sum(engine.replays.values()) * KERNEL_SITES
                    + probe_launches["mhc_block"],
                    "sinkhorn_forward": b_at_load + probe_launches["sinkhorn_forward"],
                    "sinkhorn_backward": sink_mod.launches_backward,
                    "mhc_block_unfolded": mhc_mod.launches_unfolded - c0}
        row = {"phase": "bundle_server", "startup_s": startup_s, "health": health,
               "detect_ms": detect_ms, "detect_ms_p50": float(np.percentile(detect_ms, 50)),
               "detections": sum(len(w) for w in want), "mismatched": mismatched,
               "healthcheck_exit": checked.returncode, "healthcheck": probe_report,
               "healthcheck_s": probe_s, "probe_in_process": in_process,
               "probe_launches": probe_launches, "shutdown_s": shutdown_s,
               "server_exit": server_rc, "engine_load_s": engine.load_seconds,
               "launches": launches, "card": card}
        print(json.dumps(row), flush=True)
        if mismatched or checked.returncode != 0 or probe_report.get("status") != "healthy" \
                or probe_launches != {"mhc_block": 1, "sinkhorn_forward": 1} \
                or b_at_load != len(SINKHORN_MIX) or launches["mhc_block_unfolded"] != 0 \
                or server_rc not in (0, -signal.SIGTERM):
            fail(f"bundle server: {row}")
        del engine

        dry_runs_check()
        print(json.dumps({"phase": "bundle", "seconds": time.perf_counter() - t_phase,
                          "build_s": build_s, "startup_s": startup_s, "shutdown_s": shutdown_s,
                          "card": card}), flush=True)
        return launches
    finally:
        if server is not None:
            server.kill()
            server.wait()
        if log is not None:
            log.close()
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# The serve CLI, checkpoints, the NMS methods and the profiler

INFER_RAW_HW = (720, 1280)  # the CLI's JPEGs and video frames
INFER_DIR_IMAGES = 8
INFER_VIDEO_FRAMES = 24
INFER_SYNTHETIC_FRAMES = 30
NMS_BUCKETS = (1, SERVE_BATCH)
NMS_METHODS = ("hard", "soft", "matrix")
# The keys scripts/inference.py writes into results.json, per source, and
# prints on its last line (tests/test_torch_infer.py holds the port's CLI to
# the reference script's on the CPU).
INFER_FILE_KEYS = {"results", "performance"}
INFER_RESULT_KEYS = {
    "image": {"file", "num_detections", "detections", "timing_ms"},
    "video": {"video", "frames", "fps", "latency_mean_ms", "latency_p95_ms", "frames_tracked"},
    "synthetic": {"source", "frames", "fps", "latency_mean_ms", "latency_p95_ms",
                  "frames_tracked"}}
INFER_SUMMARY_KEYS = {"processed", "total_detections", "mean_latency_ms", "results_file"}
# The card's NMS against the CPU's on the same head outputs. Both sides
# compute the candidates, boxes and IoUs with the same IEEE operations (each
# elementwise operation its own kernel, so nothing contracts into an FMA),
# so hard NMS must agree bitwise. A soft or matrix score is the candidate's
# score times decay factors exp(.): the card's expf is within 2 ulp of the
# exact value and the CPU's within 1, so a factor may differ by 3 ulp, and
# each product rounds once on either side (1 ulp more); an ulp is at most
# 2^-23 relative, so each factor adds at most 8 * 2^-24. A soft score takes
# at most M = pre_nms_top_k = 512 factors, a matrix score one. A detection
# may be kept on one side only where its score lies within that bound of
# final_threshold, or of the K-th score where all K slots are full.
NMS_FACTORS = {"hard": 0, "soft": 512, "matrix": 1}


def nms_rtol(method: str) -> float:
    return NMS_FACTORS[method] * 8 * 2.0 ** -24


def nms_agreement(card, cpu, method: str, final_threshold: float) -> dict:
    """Detections of the card's and the CPU's ``NMSResult`` paired by box
    and class: the largest relative score difference of a pair, and the
    detections on one side only, each within the bound of a cut or not."""
    rtol = nms_rtol(method)
    worst, one_sided, unexplained = 0.0, 0, 0
    for i in range(card.scores.shape[0]):
        sides = []
        for r in (card, cpu):
            n = int(r.num_valid[i])
            boxes, scores, classes = (r.boxes[i, :n].cpu().numpy(), r.scores[i, :n].cpu().numpy(),
                                      r.classes[i, :n].cpu().numpy())
            found = {}
            for b, s, c in zip(boxes, scores, classes):
                found.setdefault((b.tobytes(), int(c)), []).append(float(s))
            kth = float(scores[-1]) if n == r.scores.shape[1] else None
            sides.append((found, kth))
        (a, a_kth), (b, b_kth) = sides
        for key in set(a) | set(b):
            sa, sb = sorted(a.get(key, [])), sorted(b.get(key, []))
            for x, y in zip(sa, sb):
                worst = max(worst, abs(x - y) / max(abs(y), 1e-30))
            for s in sa[len(sb):] + sb[len(sa):]:
                one_sided += 1
                near = [final_threshold] + [k for k in (a_kth, b_kth) if k is not None]
                if not any(abs(s - t) <= rtol * abs(s) for t in near):
                    unexplained += 1
    return {"rtol": rtol, "max_rel_score_diff": worst, "one_sided": one_sided,
            "one_sided_outside_bound": unexplained,
            "agree": worst <= rtol and unexplained == 0}


def graph_launches(engine, entry) -> int:
    """Kernels and memory operations of one replay of a captured serve graph
    on the card (``torch.profiler``); the replay counts as one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with engine._serve_lock, torch.cuda.stream(engine._stream):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            entry.graph.replay()
            torch.cuda.synchronize()
    entry.replays += 1
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def infer_media(workdir: str) -> dict:
    """One 720x1280 JPEG, a directory of 8, and a 24-frame MJPG clip, from
    the shapes generator's 640² frames (80 classes) resized."""
    import cv2

    from hvs_tpu_torch.data import generate_shapes_image

    rng = np.random.default_rng(5)
    h, w = INFER_RAW_HW

    def frame():
        image = generate_shapes_image(rng, size=IMAGE, num_classes=80)[0]
        return np.ascontiguousarray(cv2.resize(image, (w, h))[..., ::-1])

    image = f"{workdir}/image.jpg"
    cv2.imwrite(image, frame())
    os.makedirs(f"{workdir}/dir")
    for i in range(INFER_DIR_IMAGES):
        cv2.imwrite(f"{workdir}/dir/{i:02d}.jpg", frame())
    video = f"{workdir}/clip.avi"
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 24, (w, h))
    for _ in range(INFER_VIDEO_FRAMES):
        writer.write(frame())
    writer.release()
    return {"image": image, "dir": f"{workdir}/dir", "video": video}


def save_infer_checkpoint(workdir: str, params: dict, ema: dict) -> str:
    """``params`` and ``ema`` saved by the port trainer's
    ``save_checkpoint`` (the train state of a trainer with EMA)."""
    from hvs_tpu_torch.config import ModelConfig
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig

    trainer = ManifoldConstrainedTrainer(ModelConfig().build_model(seed=0),
                                         TrainerConfig(ema_decay=0.999, checkpoint_dir=workdir))
    trainer.init_state()
    with torch.no_grad():
        for name, p in trainer.params().items():
            p.copy_(params[name])
            trainer.state.ema_params[name].copy_(ema[name])
    return trainer.save_checkpoint("infer")


def phase_infer(card: str) -> dict:
    """The serve path's entry point and options at the flagship's published
    widths (640² letterbox, 80 classes, bf16, seeded conditioned weights):
      1. a checkpoint saved by the port trainer (params and different EMA
         weights), served by ``python -m hvs_tpu_torch.infer`` in-process
         (``infer.main``) on one 720x1280 JPEG, a directory of 8, a 24-frame
         MJPG clip and the synthetic camera (30 frames): ``results.json``'s
         keys as ``scripts/inference.py`` writes them, each image's
         detections bitwise equal to ``engine.infer`` of its decoded frame,
         kernel A at 18 launches per replay, kernel B at 25 at the load, the
         EMA weights served; ms per image, frames/s per stream, load s;
      2. hard, soft and matrix NMS in one engine's graphs at buckets 1 and 16
         (rebuilt per method): each replay bitwise its eager run, device ms
         and launches per replay; a hot swap under soft NMS; the card's NMS
         against the CPU's on the same head outputs (``nms_agreement``);
      3. ``InferenceProfiler.run`` over the engine's buckets (1, 16) and
         ``ModelProfiler.cost_analysis`` of the b16 forward.
    Returns kernel A's and B's launches over the phase's serve paths."""
    import gc
    import shutil
    import tempfile

    import cv2

    from hvs_tpu_torch import infer
    from hvs_tpu_torch.config import InferenceConfig, ModelConfig
    from hvs_tpu_torch.data import generate_shapes_image
    from hvs_tpu_torch.inference import InferenceEngine
    from hvs_tpu_torch.inference.engine import WARMUP_CALLS
    from hvs_tpu_torch.models.yolo_head import postprocess_detections
    from hvs_tpu_torch.utils import InferenceProfiler, ModelProfiler

    workdir = tempfile.mkdtemp(prefix="hvs_infer_smoke_")
    launches = {"mhc_block": 0, "sinkhorn_forward": 0}
    try:
        params, ema = conditioned_params(0), conditioned_params(1)
        checkpoint = save_infer_checkpoint(workdir, params, ema)
        media = infer_media(workdir)
        config = f"{workdir}/inference.json"
        with open(config, "w") as f:
            json.dump({"preprocessing": {"image_size": IMAGE},
                       "performance": {"batch_buckets": [1]}}, f)
        gc.collect()
        torch.cuda.empty_cache()

        # 1. The CLI on every source.
        sources = {"image": ["--image", media["image"]], "dir": ["--dir", media["dir"]],
                   "video": ["--video", media["video"], "--frames", str(INFER_VIDEO_FRAMES)],
                   "synthetic": ["--source", "synthetic", "--frames",
                                 str(INFER_SYNTHETIC_FRAMES)]}
        rows = {}
        for name, args in sources.items():
            zero_counts()
            t0 = time.perf_counter()
            run = infer.main([*args, "--checkpoint", checkpoint, "--config", config,
                              "--output", f"{workdir}/out_{name}"])
            wall_s = time.perf_counter() - t0
            counts = kernel_counts()
            engine = run.engine
            replays = sum(engine.replays.values())  # the run's, before the checks below
            with open(run.results_file) as f:
                written = json.load(f)
            kind = "image" if name in ("image", "dir") else name
            keys_ok = (set(written) == INFER_FILE_KEYS and set(run.summary) == INFER_SUMMARY_KEYS
                       and all(set(r) == INFER_RESULT_KEYS[kind] for r in written["results"]))
            row = {"phase": "infer_cli", "source": name, "wall_s": wall_s,
                   "load_s": engine.load_seconds, "graphs": len(engine.replays),
                   "replays": replays, "kernel_sites": engine.kernel_sites,
                   "mhc_block_host_launches": counts["mhc_block"],
                   "sinkhorn_launches_at_load": counts["sinkhorn_forward"],
                   "keys_as_reference": keys_ok, "summary": run.summary}
            ok = keys_ok and engine.kernel_sites == KERNEL_SITES and len(engine.replays) == 1 \
                and counts["mhc_block"] == KERNEL_SITES * (WARMUP_CALLS + 1) \
                and counts["sinkhorn_forward"] == len(SINKHORN_MIX)
            if kind == "image":
                same, dets = 0, 0
                for r in run.results:
                    det = engine.infer(cv2.imread(r["file"]))
                    d = r["detections"]
                    same += (np.array_equal(np.asarray(d["boxes"], np.float32).reshape(-1, 4),
                                            det.boxes)
                             and np.array_equal(np.asarray(d["scores"], np.float32), det.scores)
                             and np.array_equal(np.asarray(d["classes"]), det.classes))
                    dets += r["num_detections"]
                row.update(images=len(run.results), detections=dets,
                           detections_equal_infer=same,
                           ms_per_image=float(np.mean([r["timing_ms"]["infer_e2e"]
                                                       for r in run.results])),
                           decode_ms_per_image=float(np.mean([r["timing_ms"]["load"]
                                                              for r in run.results])))
                ok &= same == len(run.results) and dets > 0 and len(run.results) == (
                    1 if name == "image" else INFER_DIR_IMAGES)
            else:
                r = run.results[0]
                want = INFER_VIDEO_FRAMES if name == "video" else INFER_SYNTHETIC_FRAMES
                row.update(frames=r["frames"], fps=r["fps"], latency_mean_ms=r["latency_mean_ms"],
                           latency_p95_ms=r["latency_p95_ms"])
                ok &= r["frames"] == want
            if name == "image":
                served = dict(engine.model.named_parameters())
                row["serves_ema"] = all(torch.equal(served[k], ema[k]) for k in served)
                row["ema_differs"] = not all(torch.equal(params[k], ema[k]) for k in served)
                ok &= row["serves_ema"] and row["ema_differs"]
            launches["mhc_block"] += replays * KERNEL_SITES
            launches["sinkhorn_forward"] += counts["sinkhorn_forward"]
            row.update(replays=replays, card=card)
            print(json.dumps(row), flush=True)
            if not ok:
                fail(f"infer: the CLI on {name}: {row}")
            rows[name] = row
            del engine, run
            gc.collect()
            torch.cuda.empty_cache()

        # 2. The NMS methods in one engine's graphs.
        cfg = InferenceConfig()
        cfg.preprocessing.image_size = IMAGE
        cfg.performance.batch_buckets = NMS_BUCKETS
        zero_counts()
        engine = InferenceEngine(ModelConfig(), cfg, variables={"params": params})
        b_at_load = sink_mod.launches_forward
        rng = np.random.default_rng(6)
        frames = np.stack([generate_shapes_image(rng, size=IMAGE, num_classes=80)[0]
                           for _ in range(SERVE_BATCH)])
        nms_rows = {}
        for method in NMS_METHODS:
            cfg.postprocessing.nms_method = method
            engine.rebuild_serve_fns()
            row = {"phase": "infer_nms", "method": method, "buckets": {}}
            for b in NMS_BUCKETS:
                a0 = mhc_mod.launches
                entry = engine._serve_fn(b)
                a_per = (mhc_mod.launches - a0) / (WARMUP_CALLS + 1)
                graph, eager = serve_bucket(engine, b, frames)
                row["buckets"][b] = {
                    "captured_for": entry.nms_method, "a_per_replay": a_per,
                    "bitwise_equal_eager": bool(np.array_equal(graph, eager)),
                    "detections": int(graph[:, 0, 6].sum()),
                    "ms": replay_ms(engine, entry), "launches": graph_launches(engine, entry)}
            if method == "soft":
                row["reload"] = reload_check(engine, {"params": ema}, {"params": params}, frames)
            # This method's graphs go at the next rebuild: count their replays now.
            launches["mhc_block"] += sum(engine.replays.values()) * KERNEL_SITES
            row["card"] = card
            print(json.dumps(row), flush=True)
            nms_rows[method] = row
            for b, r in row["buckets"].items():
                if r["captured_for"] != method or r["a_per_replay"] != KERNEL_SITES \
                        or not r["bitwise_equal_eager"] or r["detections"] == 0:
                    fail(f"infer: {method} NMS at bucket {b}: {r}")
        reload = nms_rows["soft"]["reload"]
        if not (reload["changed"] and reload["equals_eager_after"] and reload["restored"]):
            fail(f"infer: a hot swap under soft NMS: {reload}")
        launches["sinkhorn_forward"] += sink_mod.launches_forward  # the load and 2 swaps

        pp = cfg.postprocessing
        x = torch.from_numpy(frames).to(engine.device).float() / 255.0
        x = (x - engine._mean) / engine._std
        with torch.inference_mode():
            head = engine.model(x)["detection"]
            head_cpu = {k: v.cpu() for k, v in head.items() if isinstance(v, torch.Tensor)}
            agreement = {}
            for method in NMS_METHODS:
                final = {"hard": pp.score_threshold, "soft": 0.001, "matrix": 0.05}[method]
                args = (pp.score_threshold, pp.iou_threshold, pp.max_detections,
                        pp.pre_nms_top_k, method)
                agreement[method] = nms_agreement(postprocess_detections(head, *args),
                                                  postprocess_detections(head_cpu, *args),
                                                  method, final)
        print(json.dumps({"phase": "infer_nms_card_vs_cpu", "batch": SERVE_BATCH,
                          "methods": agreement, "card": card}), flush=True)
        if not all(a["agree"] for a in agreement.values()):
            fail(f"infer: the card's NMS against the CPU's: {agreement}")

        # 3. The profilers (after the launch counts: not the serve path's),
        # on the default method's graphs.
        cfg.postprocessing.nms_method = "hard"
        engine.rebuild_serve_fns()
        sweep = InferenceProfiler(lambda b: engine.infer_batch, batch_sizes=NMS_BUCKETS)
        sweep.run(lambda b: list(frames[:b]), iters=10)
        model = engine.model

        def forward(images):
            with torch.inference_mode():
                return model(images)

        profiler = ModelProfiler(forward, x)
        costs = profiler.cost_analysis()
        report = profiler.profile(iters=5)
        a_flops = sum(8 * n * d * d for n, d in mhc_sites(SERVE_BATCH))
        prof_row = {"phase": "infer_profilers", "sweep": {str(b): r for b, r in
                                                          sweep.results.items()},
                    "optimal_batch": sweep.optimal_batch(),
                    "scaling_efficiency": {str(b): e for b, e in
                                           sweep.scaling_efficiency().items()},
                    "b16_forward_flops": costs["flops"],
                    "b16_forward_bytes_accessed": costs["bytes accessed"],
                    "kernel_a_flops": a_flops, "b16_forward_ms": report.wall_time_ms,
                    "achieved_tflops": report.achieved_tflops, "peak_mem_mb": report.memory_mb,
                    "recommendations": report.recommendations, "card": card}
        print(json.dumps(prof_row), flush=True)
        if not (costs["flops"] > a_flops > 0 and report.wall_time_ms > 0
                and all(r["latency_ms"] > 0 for r in sweep.results.values())):
            fail(f"infer: profilers: {prof_row}")
        summary = {
            "phase": "infer",
            "cli_ms_per_image": {k: rows[k]["ms_per_image"] for k in ("image", "dir")},
            "cli_fps": {k: rows[k]["fps"] for k in ("video", "synthetic")},
            "cli_load_s": {k: r["load_s"] for k, r in rows.items()},
            "cli_wall_s": {k: r["wall_s"] for k, r in rows.items()},
            "nms_replay_ms": {m: {str(b): r["buckets"][b]["ms"] for b in NMS_BUCKETS}
                              for m, r in nms_rows.items()},
            "nms_launches_per_replay": {m: {str(b): r["buckets"][b]["launches"]
                                            for b in NMS_BUCKETS}
                                        for m, r in nms_rows.items()},
            "sinkhorn_launches_per_load": b_at_load, "launches": launches, "card": card}
        print(json.dumps(summary), flush=True)
        del engine, model, profiler
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches


def reload_check(engine, new: dict, old: dict, frames: np.ndarray) -> dict:
    """A hot swap to the variables ``new``: the b16 replay changes and
    equals the eager serve function after it; a swap back to ``old``
    restores it bitwise."""
    before, _ = serve_bucket(engine, SERVE_BATCH, frames)
    engine.reload(new)
    after, eager_after = serve_bucket(engine, SERVE_BATCH, frames)
    engine.reload(old)
    back, _ = serve_bucket(engine, SERVE_BATCH, frames)
    return {"changed": not np.array_equal(before, after),
            "max_abs_change": packed_max_diff(before, after),
            "equals_eager_after": bool(np.array_equal(after, eager_after)),
            "restored": bool(np.array_equal(before, back))}


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
    grouped call, one launch per width, as the train step launches them;
    then the math ops that project through it and the decompositions
    (``math_ops_check``)."""
    rows = {n: sinkhorn_check(n, card, sm_clock_hz)
            for n in sorted(set(SINKHORN_MIX) | {77, 384, 640})}
    mix = sinkhorn_mix(card, sm_clock_hz)
    math_ops_check(card)
    return rows, mix


def math_ops_check(card: str) -> dict:
    """The public projections of ``ops.sinkhorn`` and ``ops.manifold`` on
    the card: ``project_to_doubly_stochastic(method="log")``,
    ``birkhoff_project`` and ``sinkhorn_with_diagnostics`` each launch B
    once (forward) on a bf16 [256, 256] matrix and a stack of two fp32 ones,
    and agree with the plain version at ``SINK_P_ATOL`` (the bf16 result
    within one bf16 step of its largest entry); the Stiefel and SPD functions (QR, solve, SVD, eigh) run once
    in fp32 and in fp64 against their CPU results in fp64, within
    ``MATH_FP32_RTOL`` and 1e-10 of the largest magnitude."""
    from hvs_tpu_torch.ops import manifold as man

    row = {"phase": "math_ops", "card": card}
    worst = 0.0
    for name, fn in (("project_to_doubly_stochastic",
                      lambda m: sink_mod.project_to_doubly_stochastic(m, SK_ITERS, 1.0, "log")),
                     ("birkhoff_project", lambda m: man.birkhoff_project(m, SK_ITERS)),
                     ("sinkhorn_with_diagnostics",
                      lambda m: sink_mod.sinkhorn_with_diagnostics(m, SK_ITERS)[0])):
        for logits in (sinkhorn_logits(256, seed=31).to(torch.bfloat16),
                       torch.stack([sinkhorn_logits(96, seed=32), sinkhorn_logits(96, seed=33)])):
            zero_counts()
            got = fn(logits)
            torch.cuda.synchronize()
            launched = kernel_counts()
            want = sink_mod.sinkhorn_log_plain(logits.float(), SK_ITERS)
            err = float((got.float() - want).abs().max())
            # A bf16 result: the fp32 projections round to bf16 apart by at
            # most one step of the largest entry.
            tol = SINK_P_ATOL if logits.dtype == torch.float32 else max(
                SINK_P_ATOL, 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7))
            worst = max(worst, err)
            if (launched["sinkhorn_forward"], launched["sinkhorn_backward"]) != (1, 0) \
                    or got.dtype != logits.dtype or not err <= tol:
                fail(f"{name} on the card: launches {launched}, dtype {got.dtype}, "
                     f"max |diff| against the plain version {err} (need <= {tol})")
    row["projections_max_abs_err"] = worst
    _, diag = sink_mod.sinkhorn_with_diagnostics(sinkhorn_logits(256, seed=34), SK_ITERS)
    row["diagnostics"] = {k: float(v.max()) for k, v in diag.items()}
    if not row["diagnostics"]["row_sum_error"] <= SINK_ROW_ATOL:
        fail(f"sinkhorn_with_diagnostics on the card: {row['diagnostics']}")

    r = np.random.default_rng(35)
    a = r.standard_normal((64, 64))
    spd_x = a @ a.T / 64 + 0.5 * np.eye(64)
    b = r.standard_normal((64, 64))
    spd_y = b @ b.T / 64 + 0.5 * np.eye(64)
    tangent = 0.1 * (a + a.T)
    frame = np.linalg.qr(r.standard_normal((128, 32)))[0]
    frame2 = np.linalg.qr(r.standard_normal((128, 32)))[0]
    move = 0.1 * r.standard_normal((128, 32))
    cases = {
        "stiefel_project": (man.stiefel_project, (r.standard_normal((128, 32)),)),
        "stiefel_retract_cayley": (man.stiefel_retract_cayley, (frame, move)),
        "stiefel_distance": (man.stiefel_distance, (frame, frame2)),
        "spd_project": (man.spd_project, (a,)),
        "spd_retract_expm": (man.spd_retract_expm, (spd_x, tangent)),
        "spd_distance": (man.spd_distance, (spd_x, spd_y)),
    }
    errors = {}
    for name, (fn, args) in cases.items():
        want = fn(*(torch.from_numpy(x) for x in args)).numpy()
        scale = max(1.0, float(np.abs(want).max()))
        for dtype, tol in ((torch.float32, MATH_FP32_RTOL), (torch.float64, 1e-10)):
            got = fn(*(torch.from_numpy(x).to("cuda", dtype) for x in args))
            err = float(np.abs(got.double().cpu().numpy() - want).max()) / scale
            errors[f"{name}_{str(dtype)[6:]}"] = err
            if not (np.isfinite(err) and err <= tol):
                fail(f"{name} in {dtype} on the card against the CPU in fp64: relative "
                     f"max |diff| {err} (need <= {tol})")
    row["decompositions_rel_err"] = errors
    print(json.dumps(row), flush=True)
    return row


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
    ``train_chunked``; 320², batch 8 in ``multitask``), at a ragged count
    and on the ill-conditioned rows at every width (or at ``shapes`` only).
    Inputs are kernel A's with a near-identity H_pre = sigmoid(6·I - 3 +
    noise)."""
    ill = shapes is None
    if shapes is None:
        shapes = sorted(set(mhc_sites(TRAIN_BATCH, TRAIN_IMAGE))
                        | set(mhc_sites(CHUNK_VAL_BATCH, max(CHUNK_BATCHES)))
                        | set(mhc_sites(MULTITASK_BATCH, MULTITASK_IMAGE))
                        | {(1234, d) for d in mhc_mod.SUPPORTED_WIDTHS})
    per_shape = {}
    for n, d in shapes:
        x, args = mhc_inputs(n, d, seed=n * 5 + d)
        args = (near_identity_h_pre(d), *args)
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
    for d in mhc_mod.SUPPORTED_WIDTHS if ill else ():
        x, args = mhc_inputs(ILL_ROWS, d, seed=d + 1, ill=True)
        args = (near_identity_h_pre(d), *args)
        per_shape[("ill", d)] = ill_conditioned_check(
            "mhc_block_unfolded", d, mhc_mod.mhc_block_unfolded(x, *args),
            mhc_mod.mhc_block_unfolded_plain(x, *args), card)
    for d in mhc_mod.SUPPORTED_WIDTHS if ill else ():
        x, args = mhc_inputs(ILL_ROWS, d, seed=d + 1, ill=True, h_post_near_1=True)
        h_pre = near_identity_h_pre(d)
        per_shape[("gelu", d)] = gelu_conditioned_check(
            "mhc_block_unfolded", x, args, mhc_mod.mhc_block_unfolded(x, h_pre, *args),
            mhc_mod.mhc_block_unfolded_plain(x, h_pre, *args), card, h_pre=h_pre)
    return per_shape


def near_identity_h_pre(d: int) -> torch.Tensor:
    """H_pre = sigmoid(6·I - 3 + noise), bf16 on the card."""
    r = np.random.default_rng(d)
    return torch.sigmoid(torch.from_numpy(
        (6.0 * np.eye(d) - 3.0 + 0.5 * r.standard_normal((d, d))).astype(np.float32))
    ).to("cuda", torch.bfloat16).contiguous()


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
# Training held against its CPU run, and data parallelism


def shapes_arrays(n: int, size: int, seed: int, max_boxes: int):
    """``n`` frames of the shapes benchmark (``data/shapes.py``'s generator)
    as ``load_coco_arrays`` returns them: uint8 images, normalized cxcywh
    boxes, labels and mask, padded to ``max_boxes``."""
    from hvs_tpu_torch.data.shapes import generate_image

    rng = np.random.default_rng(seed)
    images = np.zeros((n, size, size, 3), np.uint8)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int32)
    mask = np.zeros((n, max_boxes), np.float32)
    for i in range(n):
        img, xywh, lab = generate_image(rng, size=size)
        k = min(len(lab), max_boxes)
        x, y, w, h = (xywh[:k, j] for j in range(4))
        images[i] = img
        boxes[i, :k] = np.stack([(x + w / 2) / size, (y + h / 2) / size, w / size, h / size], -1)
        labels[i, :k] = lab[:k]
        mask[i, :k] = 1.0
    return images, boxes, labels, mask


def phase_train_trajectory(card: str, steps: int = TRAJ_STEPS, sizes=TRAJ_SIZES,
                           batch: int = TRAJ_BATCH, warmup: int = TRAJ_WARMUP,
                           project_every: int = TRAJ_PROJECT_EVERY) -> dict:
    """``steps`` steps of the full-width flagship in bf16 (dropout off)
    on the card, through its captured ``TrainChunk`` steps, against the same
    steps on this machine's CPU through the chunk bodies run eagerly, fed
    the draws each replay made, from the same weights. Compares the 20-step
    window means of the loss and the largest grad norm after the first 20
    steps within the limits above. Returns kernel B's launches on the card's path (each captured
    step's times its replays; counters zeroed just before).
    ``scripts/torch_train_parity.py trajectory --device cuda`` calls it with
    its own steps, sizes, batch, warm-up and projection period."""
    import copy

    from hvs_tpu_torch.data import AugmentDraws, put_device_data
    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.models.layers import Dropout
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig
    from hvs_tpu_torch.training.chunk import TrainChunk

    arrays = shapes_arrays(TRAJ_IMAGES, TRAJ_IMAGE, seed=0, max_boxes=TRAJ_BOXES)
    model = HybridVisionSystem(num_classes=TRAJ_CLASSES, monitor=True, seed=0)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    cpu_model = copy.deepcopy(model).to("cpu")
    config = TrainerConfig(num_classes=TRAJ_CLASSES, max_boxes=TRAJ_BOXES,
                           warmup_steps=warmup, total_steps=6000, ema_decay=0.999,
                           project_every=project_every)
    zero_counts()
    sides = {}
    for name, m, dev in (("cuda", model, torch.device("cuda")),
                         ("cpu", cpu_model, torch.device("cpu"))):
        trainer = ManifoldConstrainedTrainer(m, config, device=dev, seed=0)
        trainer.init_state()
        data = put_device_data(*arrays, device=dev)
        sides[name] = (trainer, {o: TrainChunk(trainer, data, o, batch, TRAJ_CHUNK)
                                 for o in sizes})
    rows = {"cuda": [], "cpu": []}
    seconds = {"cuda": 0.0, "cpu": 0.0}
    for i in range(steps):
        size = sizes[(i // TRAJ_CHUNK) % len(sizes)]
        card_chunk, cpu_chunk = sides["cuda"][1][size], sides["cpu"][1][size]
        if i % TRAJ_CHUNK == 0:
            card_chunk.pos.zero_()
            cpu_chunk.pos.zero_()
        t0 = time.perf_counter()
        card_chunk.replay()
        torch.cuda.synchronize()
        seconds["cuda"] += time.perf_counter() - t0
        draws = AugmentDraws(*(d.cpu() for d in card_chunk.last_draws))
        t0 = time.perf_counter()
        cpu_chunk.step(draws)
        seconds["cpu"] += time.perf_counter() - t0
        if (i + 1) % TRAJ_CHUNK == 0:
            for side, chunk in (("cuda", card_chunk), ("cpu", cpu_chunk)):
                host = chunk.pull()
                rows[side] += [{k: float(v[j]) for k, v in host.items()}
                               for j in range(TRAJ_CHUNK)]
    launches = {k: sum(c.launches[k] * c.replays for c in sides["cuda"][1].values())
                for k in kernel_counts()}

    def windows(side, key):
        v = np.array([r[key] for r in rows[side]], np.float64)
        return v.reshape(-1, TRAJ_WINDOW).mean(1)

    card_w, cpu_w = windows("cuda", "loss"), windows("cpu", "loss")
    gap = float(np.max(np.abs(card_w - cpu_w) / np.abs(cpu_w)))
    g_card = max(r["grad_norm"] for r in rows["cuda"][TRAJ_TRANSIENT:])
    g_cpu = max(r["grad_norm"] for r in rows["cpu"][TRAJ_TRANSIENT:])
    finite = bool(np.isfinite([r[k] for side in rows for r in rows[side]
                               for k in ("loss", "grad_norm")]).all())
    row = {"phase": "train_trajectory", "steps": steps, "sizes": list(sizes),
           "batch": batch, "dtype": "bfloat16",
           "loss_window_means_cuda": card_w.round(4).tolist(),
           "loss_window_means_cpu": cpu_w.round(4).tolist(),
           "loss_window_max_rel_gap": gap, "limit_loss_window_rtol": TRAJ_LOSS_WINDOW_RTOL,
           "grad_norm_max_after_transient_cuda": g_card,
           "grad_norm_max_after_transient_cpu": g_cpu, "transient_steps": TRAJ_TRANSIENT,
           "grad_norm_max_cuda": max(r["grad_norm"] for r in rows["cuda"]),
           "grad_norm_max_cpu": max(r["grad_norm"] for r in rows["cpu"]),
           "grad_norm_p50_cuda": float(np.median([r["grad_norm"] for r in rows["cuda"]])),
           "grad_norm_p50_cpu": float(np.median([r["grad_norm"] for r in rows["cpu"]])),
           "limit_grad_norm_ratio": TRAJ_GRAD_NORM_RATIO,
           "lr_last": rows["cuda"][-1]["lr"], "projection_at_step": config.project_every,
           "ms_per_step_cuda": 1e3 * seconds["cuda"] / steps,
           "ms_per_step_cpu": 1e3 * seconds["cpu"] / steps,
           "launches_per_step": sides["cuda"][1][sizes[0]].launches,
           "launches": launches, "card": card}
    print(json.dumps(row), flush=True)
    ratio = g_card / g_cpu
    if not (finite and gap <= TRAJ_LOSS_WINDOW_RTOL
            and 1 / TRAJ_GRAD_NORM_RATIO <= ratio <= TRAJ_GRAD_NORM_RATIO):
        fail(f"train_trajectory: the card's run parts from the CPU's beyond the limits: {row}")
    return launches


def phase_ddp(card: str) -> dict:
    """``train_device``'s captured step (416² batch 16) data-parallel over an
    NCCL process group of one process (``init_process_group`` with a
    ``tcp://127.0.0.1`` store, in this process), its all-reduces captured in
    the graph, with a captured validation pass; then the same step without a
    process group, from the same weights and generator. One replay of each
    from the same state (a projection step): forward metrics bitwise equal,
    the grad norm within the fp32 train-parity limit (the backward's atomics
    order sums differently in two graphs), every parameter within 2·lr, the
    update's cosine above 0.999; then ms per step with and without the
    all-reduce (plain, data-parallel, data-parallel, plain; CUDA events).
    Returns the data-parallel path's launches (counters zeroed before it)."""
    import copy
    import socket

    import torch.distributed as dist

    from hvs_tpu_torch.data import put_device_data
    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.parallel import Mesh, make_mesh
    from hvs_tpu_torch.train_device import synthetic_arrays
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig
    from hvs_tpu_torch.training.chunk import TrainChunk, ValChunk

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        mesh = make_mesh()
        if not (mesh.distributed and mesh.shape == {"data": 1, "model": 1}):
            fail(f"ddp: make_mesh() under a process group gave {mesh}")
        data = put_device_data(*synthetic_arrays(DDP_IMAGES, IMAGE, CHUNK_BOXES, CHUNK_CLASSES,
                                                 seed=0))
        val_data = put_device_data(*synthetic_arrays(DDP_VAL_IMAGES, IMAGE, CHUNK_BOXES,
                                                     CHUNK_CLASSES, seed=1))
        model = HybridVisionSystem(num_classes=CHUNK_CLASSES, monitor=True, seed=0)
        plain_model = copy.deepcopy(model)
        config = TrainerConfig(num_classes=CHUNK_CLASSES, max_boxes=CHUNK_BOXES,
                               ema_decay=0.999)
        pool = torch.cuda.graph_pool_handle()
        zero_counts()
        ddp = ManifoldConstrainedTrainer(model, config, seed=0, mesh=mesh)
        ddp.init_state()
        t0 = time.perf_counter()
        chunk = TrainChunk(ddp, data, DDP_IMAGE, ddp._share(DDP_BATCH), CHUNK_STEPS, pool=pool)
        capture_s = time.perf_counter() - t0
        val = ValChunk(ddp, val_data, DDP_VAL_BATCH, IMAGE, DDP_VAL_IMAGES // DDP_VAL_BATCH,
                       pool=pool)
        plain = ManifoldConstrainedTrainer(plain_model, config, seed=0, mesh=Mesh(data=1))
        plain.init_state()
        plain_chunk = TrainChunk(plain, data, DDP_IMAGE, DDP_BATCH, CHUNK_STEPS, pool=pool)

        # One replay of each from the same state, at a projection step.
        results = {}
        count = config.project_every - 1
        for name, t, c in (("ddp", ddp, chunk), ("plain", plain, plain_chunk)):
            t.tx.count.fill_(count)
            t.lr_scale_t.fill_(1.0)
            start = [p.detach().clone() for p in t.params().values()]
            c.pos.zero_()
            c.replay()
            torch.cuda.synchronize()
            results[name] = {
                "row": dict(zip(c.keys, c.metrics[0].tolist())),
                "update": torch.cat([(p.detach() - s).flatten().float()
                                     for p, s in zip(t.params().values(), start)]),
                "draws": tuple(d.clone() for d in c.last_draws)}
        d, p = results["ddp"], results["plain"]
        same_draws = all(torch.equal(a, b) for a, b in zip(d["draws"], p["draws"]))
        forward_equal = all(d["row"][k] == p["row"][k] for k in d["row"]
                            if k not in ("grad_norm",))
        grad_rel = abs(d["row"]["grad_norm"] - p["row"]["grad_norm"]) / p["row"]["grad_norm"]
        cos = float((d["update"] * p["update"]).sum()
                    / (d["update"].norm() * p["update"].norm() + 1e-30))
        max_diff = float((d["update"] - p["update"]).abs().max())
        limit = 2 * ddp.schedule(count) + 1e-6
        bitwise = bool(torch.equal(d["update"], p["update"])) and forward_equal

        # ms per step: plain, data-parallel, data-parallel, plain.
        for c in (plain_chunk, chunk, chunk, plain_chunk):
            c.run()
        v = val.run()
        torch.cuda.synchronize()
        launches = {k: chunk.launches[k] * chunk.replays + val.launches[k] * val.replays
                    for k in kernel_counts()}
        tol = TRAIN_PARITY["float32"]
        row = {"phase": "ddp", "backend": dist.get_backend(), "world_size": dist.get_world_size(),
               "image": DDP_IMAGE, "batch": DDP_BATCH, "classes": CHUNK_CLASSES,
               "capture_s": capture_s, "captured_with_all_reduce": chunk.graph is not None,
               "same_draws": same_draws, "forward_metrics_equal": forward_equal,
               "bitwise": bitwise, "grad_norm_rel_diff": grad_rel, "update_cos": cos,
               "param_max_abs_diff": max_diff, "param_limit": limit,
               "ms_per_step_ddp": [t["device_ms"] / CHUNK_STEPS for t in chunk.timings],
               "ms_per_step_plain": [t["device_ms"] / CHUNK_STEPS for t in plain_chunk.timings],
               "val_loss": v, "launches_per_step": chunk.launches,
               "launches_per_val_batch": val.launches, "launches": launches, "card": card}
        print(json.dumps(row), flush=True)
        if not (same_draws and forward_equal and grad_rel <= tol["grad_norm_rtol"]
                and cos > tol["mhc_update_min_cos"] and max_diff <= limit
                and np.isfinite(v) and chunk.graph is not None):
            fail(f"ddp: the data-parallel replay disagrees with the plain one: {row}")
        n_widths = len(set(SINKHORN_MIX))
        if (chunk.launches["sinkhorn_forward"], chunk.launches["sinkhorn_backward"],
                val.launches["mhc_block_unfolded"]) != (3 * n_widths, 2 * n_widths,
                                                        KERNEL_SITES):
            fail(f"ddp: launches per step {chunk.launches}, per validation batch "
                 f"{val.launches}")
        return launches
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Tensor parallelism: two processes sharing the card


def condition(model) -> None:
    """Dropout off and each H_res_raw 6·I + N(0, 1) from a fixed seed, as
    ``train_step_pair`` conditions the train_parity step: the residual sum
    then carries the spread LN2 needs, so rounding is not amplified."""
    from hvs_tpu_torch.models.layers import Dropout, ManifoldHyperConnection

    r = np.random.default_rng(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
            if isinstance(m, ManifoldHyperConnection):
                d = m.dim
                m.H_res_raw.copy_(torch.from_numpy(
                    (6.0 * np.eye(d) + r.standard_normal((d, d))).astype(np.float32)))


def tp_run(workdir: str, name: str, mesh=None, device=None, dtype=torch.bfloat16,
           val_batches: int = TP_VAL_BATCHES, conditioned: bool = False):
    """The tp phase's training run (``TP_*``): the flagship in ``dtype``
    built from seed 0, trained through ``ManifoldConstrainedTrainer.train``
    with ``hvs_tpu_torch.train``'s synthetic batches (validation over
    ``val_batches``, none at 0), checkpoints under ``workdir/name``;
    ``conditioned``: dropout off and every H_res_raw near a scaled identity,
    as the train_parity phase conditions its step. Counters are zeroed just
    before ``train`` and read just after. Returns (the run's row, the
    trainer, the whole parameters before training on the CPU)."""
    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.parallel import held_fraction
    from hvs_tpu_torch.train import make_synthetic_loader
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig

    log_path = f"{workdir}/{name}.jsonl"
    config = TrainerConfig(num_classes=TRAIN_CLASSES, max_boxes=TRAIN_BOXES, warmup_steps=0,
                           project_every=TP_PROJECT_EVERY, stability_check_every=TP_STEPS,
                           backbone_lr_factor=0.1, checkpoint_dir=f"{workdir}/{name}",
                           metrics_log=log_path)
    model = HybridVisionSystem(num_classes=TRAIN_CLASSES, monitor=True, seed=0, device=device,
                               dtype=dtype)
    if conditioned:
        condition(model)
    start = {k: v.detach().float().cpu().clone() for k, v in model.named_parameters()}
    trainer = ManifoldConstrainedTrainer(model, config, device=device, seed=0, mesh=mesh)
    trainer.init_state()
    train_fn = make_synthetic_loader(TRAIN_BATCH, TRAIN_IMAGE, TP_STEPS, TRAIN_CLASSES,
                                     TRAIN_BOXES, seed=0)
    val_fn = make_synthetic_loader(TRAIN_BATCH, TRAIN_IMAGE, val_batches, TRAIN_CLASSES,
                                   TRAIN_BOXES, seed=1) if val_batches else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    result = trainer.train(train_fn, val_fn, epochs=1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kernel_counts()
    trainer.close()
    log = []
    if trainer.is_writer:
        with open(log_path) as f:
            log = [json.loads(line) for line in f]
    row = {"launches": counts, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "wall_s": wall_s, "step_ms": [(b["time"] - a["time"]) * 1e3
                                         for a, b in zip(log, log[1:])],
           "loss": [r["loss"] for r in log], "grad_norm": [r["grad_norm"] for r in log],
           "val_loss": result["history"]["val_loss"], "steps": trainer.state.step,
           "lr": config.learning_rate,
           "held": held_fraction(model, trainer.mesh) if trainer.sharded else None}
    return row, trainer, start


def tp_worker(rank: int, port: int, workdir: str) -> None:
    """One process of the tp phase's mesh (``torch.multiprocessing``
    spawns it): joins the others on card 0 over gloo through
    ``parallel.setup``, trains (``tp_run``: the counted bf16 run ``tp``, then
    ``tp32`` in fp32), writes each run's row to ``workdir/<run>_rank<rank>.json``
    and, from the first process, the whole parameters gathered over the
    model group to ``workdir/<run>_final.pt``."""
    import torch.distributed as dist

    from hvs_tpu_torch.config.training import DistributedConfig
    from hvs_tpu_torch.parallel import gather_parameters, setup

    mesh, device = setup("cuda:0", DistributedConfig(
        enabled=True, coordinator_address=f"127.0.0.1:{port}", num_processes=TP_MODEL,
        process_id=rank), n_model=TP_MODEL, backend="gloo")
    try:
        for name, dtype, val in TP_RUNS:
            row, trainer, _ = tp_run(workdir, name, mesh, device, dtype, val,
                                     conditioned=dtype == torch.float32)
            whole = gather_parameters(trainer.model)
            row.update(backend=dist.get_backend(), mesh=mesh.shape,
                       model_rank=mesh.model_rank, device=str(device),
                       sharded_params=len(trainer.sharded))
            if rank == 0:
                torch.save({k: v.cpu() for k, v in whole.items()}, f"{workdir}/{name}_final.pt")
            with open(f"{workdir}/{name}_rank{rank}.json", "w") as f:
                json.dump(row, f)
            del trainer, whole
        dist.barrier()
    finally:
        dist.destroy_process_group()


def tp_serve_sites(det, images) -> tuple:
    """One forward of ``det`` on ``images`` with its kernel-A launches
    counted (zeroed just before, read just after), and each fused site's
    input and operands as the serve branch hands them to the kernel."""
    from hvs_tpu_torch.models.layers import ManifoldHyperConnection

    sites, hooks = [], []

    def keep(module, args):
        dt = module.dtype
        sites.append((module.dim, args[0].to(dt).reshape(-1, module.dim).contiguous().clone(),
                      (module.w1_folded, module.mlp_in_bias, module.mlp_out_kernel.to(dt),
                       module.mlp_out_bias, module.h_post, module.h_res, module.norm_pre_scale,
                       module.norm_pre_bias, module.norm_post_scale, module.norm_post_bias)))

    for m in det.model.modules():
        if isinstance(m, ManifoldHyperConnection) and m.fused:
            hooks.append(m.register_forward_pre_hook(keep))
    zero_counts()
    try:
        out = det(images)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return out, kernel_counts(), sites


def tp_param_limit(lr: float, steps: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The most one element can differ between two AdamW runs after
    ``steps`` steps from one start: step t moves it by lr·|m̂/√v̂|, at most
    lr·sqrt(Σ w_i² / u_i) over the weights w and u that the bias-corrected
    moments give the step's gradients (Cauchy-Schwarz; 1 at t = 1, 1.007 at
    t = 4), the two runs in opposite directions."""
    total = 0.0
    for t in range(1, steps + 1):
        w = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
        u = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
        total += math.sqrt(sum(a * a / c for a, c in zip(w, u)))
    return 2 * lr * total + 1e-6


def tp_agreement(one: dict, tp: dict, start: dict, one_final: dict, tp_final: dict,
                 dtype: str) -> dict:
    """How far the sharded run ``tp`` lies from the one-process run ``one``
    of the same steps, and whether within the limits of ``dtype``
    (``TP_MODEL``'s comment)."""
    from hvs_tpu_torch.training.optimizer import partition_label

    tol = TRAIN_PARITY[dtype]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(tp["loss"], one["loss"])]
    grad_rel = [abs(a - b) / b for a, b in zip(tp["grad_norm"], one["grad_norm"])]
    mhc = [k for k in start if partition_label(k, 0.1).startswith("mhc")]
    # In fp64: over ~10^7 entries an fp32 sum reads cosines above 1 by 1e-3.
    upd = {side: torch.cat([(p[k].double() - start[k].double()).flatten() for k in mhc])
           for side, p in (("tp", tp_final), ("one", one_final))}
    upd_cos = float((upd["tp"] * upd["one"]).sum()
                    / (upd["tp"].norm() * upd["one"].norm() + 1e-30))
    max_dp = max(float((tp_final[k].float() - one_final[k]).abs().max()) for k in start)
    limit = tp_param_limit(one["lr"], TP_STEPS)
    mean_loss_rel = abs(np.mean(tp["loss"]) - np.mean(one["loss"])) / abs(np.mean(one["loss"]))
    grad_max_ratio = max(tp["grad_norm"][1:]) / max(one["grad_norm"][1:])
    if dtype == "float32":
        steps_ok = all(r <= tol["loss_rtol"] for r in loss_rel) \
            and all(r <= tol["grad_norm_rtol"] for r in grad_rel)
    else:
        steps_ok = (loss_rel[0] <= tol["loss_rtol"] and grad_rel[0] <= tol["grad_norm_rtol"]
                    and mean_loss_rel <= TRAJ_LOSS_WINDOW_RTOL
                    and 1 / TRAJ_GRAD_NORM_RATIO <= grad_max_ratio <= TRAJ_GRAD_NORM_RATIO)
    ok = (steps_ok and len(loss_rel) == TP_STEPS and upd_cos > tol["mhc_update_min_cos"]
          and max_dp <= limit and np.isfinite(tp["loss"] + tp["grad_norm"]).all())
    return {"dtype": dtype, "loss_tp": tp["loss"], "loss_one": one["loss"],
            "loss_rel_diff": loss_rel, "grad_norm_tp": tp["grad_norm"],
            "grad_norm_one": one["grad_norm"], "grad_norm_rel_diff": grad_rel,
            "mean_loss_rel_diff": mean_loss_rel, "grad_norm_max_ratio_after_step_1":
            grad_max_ratio, "mhc_update_cos": upd_cos, "param_max_abs_diff": max_dp,
            "param_limit": limit, "ok": bool(ok)}


def phase_tp(card: str) -> dict:
    """Tensor parallelism on the card: ``TP_MODEL`` processes (spawned)
    share card 0 over gloo, a 1 x ``TP_MODEL`` mesh that splits the
    rule-matched parameters, and train the flagship (``tp_run``) in bf16,
    then in fp32, against the same runs in this process
    (``tp_agreement``); kernel B at the train phase's launches per step on
    every process and C at 18 per validation batch on the gathered weights;
    the checkpoint (one-process layout) equal to the gathered parameters and
    reloaded bit-exact into a one-process trainer, then served
    (``tp_serve``). Returns the first process's launches in the bf16 run
    plus the serving's."""
    import gc
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as tmp_mp

    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig

    runs = TP_RUNS
    workdir = tempfile.mkdtemp(prefix="hvs_tp_smoke_")
    one, ranks, start, one_final, tp_final = {}, {}, {}, {}, {}
    try:
        for name, dtype, val in runs:
            one[name], trainer, start[name] = tp_run(workdir, f"one_{name}", dtype=dtype,
                                                     val_batches=val,
                                                     conditioned=dtype == torch.float32)
            one_final[name] = {k: v.detach().float().cpu().clone()
                               for k, v in trainer.params().items()}
            del trainer
            gc.collect()
            torch.cuda.empty_cache()

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        ctx = tmp_mp.start_processes(tp_worker, args=(port, workdir), nprocs=TP_MODEL,
                                     join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > TP_TIMEOUT_S:
                    fail(f"tp: the {TP_MODEL} processes did not finish in {TP_TIMEOUT_S} s")
        except tmp_mp.ProcessException as e:
            fail(f"tp: a process of the mesh failed: {e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        spawn_s = time.perf_counter() - t0
        for name, _, _ in runs:
            ranks[name] = []
            for r in range(TP_MODEL):
                with open(f"{workdir}/{name}_rank{r}.json") as f:
                    ranks[name].append(json.load(f))
            tp_final[name] = torch.load(f"{workdir}/{name}_final.pt")

        # The checkpoint: the gathered parameters, reloaded bit-exact.
        ckpt = torch.load(f"{workdir}/tp/best.pt", map_location="cuda")
        saved_equal = set(ckpt["params"]) == set(tp_final["tp"]) and all(
            torch.equal(ckpt["params"][k].cpu(), v) for k, v in tp_final["tp"].items())
        reload = ManifoldConstrainedTrainer(
            HybridVisionSystem(num_classes=TRAIN_CLASSES, monitor=True, seed=1),
            TrainerConfig(num_classes=TRAIN_CLASSES, checkpoint_dir=f"{workdir}/reload"))
        reload.init_state()
        reload.load_checkpoint(f"{workdir}/tp/best")
        opt = reload.tx.state_dict()
        reloaded_equal = (
            all(torch.equal(p.detach(), ckpt["params"][k]) for k, p in reload.params().items())
            and all(torch.equal(opt[g][k], ckpt["opt_state"][g][k])
                    for g in ("mu", "nu", "trace") for k in opt[g])
            and reload.state.step == ckpt["step"] == TP_STEPS)
        del reload
        gc.collect()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    agree = {name: tp_agreement(one[name], ranks[name][0], start[name], one_final[name],
                                tp_final[name], str(dtype).split(".")[-1])
             for name, dtype, _ in runs}
    r0, o = ranks["tp"][0], one["tp"]
    val_rel = abs(r0["val_loss"][-1] - o["val_loss"][-1]) / abs(o["val_loss"][-1])
    n_widths = len(set(SINKHORN_MIX))
    want = {"mhc_block": 0, "mhc_block_unfolded": KERNEL_SITES * TP_VAL_BATCHES,
            "sinkhorn_forward": (3 * TP_STEPS + TP_VAL_BATCHES) * n_widths,
            "sinkhorn_backward": 2 * n_widths * TP_STEPS}
    row = {"phase": "tp", "mesh": r0["mesh"], "backend": r0["backend"],
           "devices": [r["device"] for r in ranks["tp"]], "image": TRAIN_IMAGE,
           "batch": TRAIN_BATCH, "classes": TRAIN_CLASSES, "steps": TP_STEPS,
           "projection_steps": TP_STEPS // TP_PROJECT_EVERY, "bf16": agree["tp"],
           "fp32": agree["tp32"], "val_loss_tp": r0["val_loss"], "val_loss_one": o["val_loss"],
           "val_loss_rel_diff": val_rel,
           "sharded_fraction": r0["held"], "sharded_params": r0["sharded_params"],
           "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in ranks["tp"]],
           "peak_mem_gb_one": o["peak_mem_gb"],
           "launches_per_rank": [r["launches"] for r in ranks["tp"]], "launches_one": o["launches"],
           "ms_per_step_median": {f"{name}_{side}": float(np.median(run["step_ms"]))
                                  for name, _, _ in runs
                                  for side, run in (("sharded", ranks[name][0]),
                                                    ("one", one[name]))},
           "step_ms_tp": r0["step_ms"], "step_ms_one": o["step_ms"],
           "wall_s": {"tp": r0["wall_s"], "one": o["wall_s"]},
           "timing_note": f"{TP_MODEL} processes sharing one card over host-staged gloo "
                          "collectives: not a tensor-parallel speed",
           "spawn_s": spawn_s, "checkpoint_equals_gathered": saved_equal,
           "reloaded_bit_exact": reloaded_equal, "card": card}
    print(json.dumps(row), flush=True)
    if not (agree["tp"]["ok"] and agree["tp32"]["ok"]
            and val_rel <= TRAIN_PARITY["bfloat16"]["loss_rtol"]
            and np.isfinite(r0["val_loss"]).all()):
        fail(f"tp: the sharded runs disagree with one process: {row}")
    if any(r["launches"] != want for r in ranks["tp"]) or o["launches"] != want:
        fail(f"tp: launches per rank {row['launches_per_rank']}, one process "
             f"{o['launches']}, expected {want}")
    if not (r0["backend"] == "gloo" and r0["mesh"] == {"data": 1, "model": TP_MODEL}
            and all(r["device"] == "cuda:0" for r in ranks["tp"]) and r0["sharded_params"] > 0
            and all(r["held"] == r0["held"] for r in ranks["tp"])
            and r0["held"]["held_bytes"] == r0["held"]["replicated_bytes"]
            + r0["held"]["sharded_bytes"] // TP_MODEL):
        fail(f"tp: the mesh or the held blocks are not as set up: {row}")
    if not (saved_equal and reloaded_equal):
        fail("tp: the checkpoint is not the gathered state or does not reload bit-exact")
    served = tp_serve(ckpt["params"], card)
    return {k: r0["launches"][k] + served[k] for k in served}


@torch.no_grad()
def tp_serve(params: dict, card: str) -> dict:
    """The tp phase's checkpoint served by ``Detector`` at 640² batch 1:
    B once per matrix at load, A at its 18 sites, each held against its
    plain version on the site's inputs and weights, gated on an fp64
    evaluation (the weights are near their init, where the GELUs are
    ill-conditioned; ``GELU_FP64_MARGIN``). Returns the launches of the
    load and the forward."""
    from hvs_tpu_torch.inference import Detector
    from hvs_tpu_torch.models import ProductionHybridVision

    model = ProductionHybridVision(num_classes=TRAIN_CLASSES, seed=0)
    for k, p in model.named_parameters():
        p.copy_(params[k])
    zero_counts()
    det = Detector(model)
    torch.cuda.synchronize()
    load_counts = kernel_counts()
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand((1, IMAGE, IMAGE, 3), generator=gen, device="cuda")
    (boxes, scores, _), serve_counts, sites = tp_serve_sites(det, images)
    site_rows = []
    for d, x, args in sites:
        out, ref = mhc_mod.mhc_block(x, *args), mhc_mod.mhc_block_plain(x, *args)
        torch.cuda.synchronize()
        exact = mhc_chain64(x, *args).flatten().cpu().numpy()
        a, b = out.float().flatten().cpu().numpy(), ref.float().flatten().cpu().numpy()
        site_rows.append({
            "n": x.shape[0], "d": d, "corr": float(np.corrcoef(a, b)[0, 1]),
            "mean_abs_err": float(np.mean(np.abs(a - b))),
            "kernel_vs_fp64_corr": float(np.corrcoef(a, exact)[0, 1]),
            "plain_vs_fp64_corr": float(np.corrcoef(b, exact)[0, 1]),
            "finite": bool(np.isfinite(a).all())})
    row = {"phase": "tp_serve", "image": IMAGE, "batch": 1, "load_launches": load_counts,
           "launches": serve_counts, "detections": int((scores > 0).sum()),
           "sites": site_rows, "card": card}
    print(json.dumps(row), flush=True)
    if serve_counts["mhc_block"] != KERNEL_SITES or len(site_rows) != KERNEL_SITES \
            or load_counts["sinkhorn_forward"] != len(SINKHORN_MIX) \
            or not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        fail(f"tp: serving the checkpoint: A {serve_counts}, B at load {load_counts}")
    for s in site_rows:
        if not (s["finite"] and s["kernel_vs_fp64_corr"]
                >= s["plain_vs_fp64_corr"] - GELU_FP64_MARGIN):
            fail(f"tp: kernel A at a served site lies farther from the fp64 chain than its "
                 f"plain version: {s}")
    return {k: serve_counts[k] + load_counts[k] for k in serve_counts}


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


def phase_data(card: str, workdir: str = None) -> dict:
    """The data and evaluation layer, through the entry points, at full width,
    in ``workdir`` (kept for a later phase when given, else a temp directory
    removed at the end):
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
         ``--synthetic`` self-check at 1.0; the report written to
         ``evaluation.json``.
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
    keep = workdir is not None
    workdir = workdir or tempfile.mkdtemp(prefix="hvs_data_smoke_")
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
        with open(f"{workdir}/evaluation.json", "w") as f:
            json.dump(report, f, indent=2, default=float)
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
        if not keep:
            shutil.rmtree(workdir, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# int8 serving

INT8_CALIB_IMAGES, INT8_CALIB_BATCH = 16, 8
INT8_BUCKETS = (1, SERVE_BATCH)
# (quantize_fpn, quantize_mhc, quantize_vit) of each int8 variant, and kernel
# A's sites per replay: the FPN and head-tower mHC layers stay bf16 under
# every flag, the backbone's 11 take the int8 chain under quantize_mhc and the
# ViT fusion's under quantize_vit (the ViT blocks' FFNs are not A's sites).
INT8_VARIANTS = {"int8": ((False, False, False), 18), "int8_fpn": ((True, False, False), 18),
                 "int8_mhc": ((False, True, False), 7), "int8_vit": ((False, False, True), 17),
                 "int8_all": ((True, True, True), 6)}
# int8 against bf16 raw head outputs of the same seeded weights (a b16 eager
# forward; random init, so no detection-level comparison): per scale, the
# correlation and mean |diff| over mean |bf16|. At random init the full-width
# network amplifies any rounding: the bf16 model itself reads only corr
# ~0.8 against the fp32 one (printed beside, as "bf16_vs_fp32"). Measured
# first on the card (PERF.md: corr 0.27-0.53, rel 0.96-1.22 over the five
# variants), the limits leave room around those readings; accuracy is
# judged on trained weights (python -m hvs_tpu_torch.quantize).
INT8_RAW_MIN_CORR, INT8_RAW_MAX_REL = 0.2, 1.5
INT8_RELOAD_FACTOR = 1.5  # the scales a reload swaps in: every site's times this


def int8_configs(scales_path=None, fpn: bool = False, mhc: bool = False, vit: bool = False):
    """The flagship's model config (int8 when ``scales_path`` is given, with
    the variant's flags) and an inference config at 640², buckets (1, 16)."""
    from hvs_tpu_torch.config import InferenceConfig, ModelConfig

    mcfg = ModelConfig()
    if scales_path is not None:
        q = mcfg.quantization
        q.enabled, q.scales_path = True, scales_path
        q.quantize_fpn, q.quantize_mhc, q.quantize_vit = fpn, mhc, vit
    icfg = InferenceConfig()
    icfg.preprocessing.image_size = IMAGE
    icfg.performance.batch_buckets = INT8_BUCKETS
    return mcfg, icfg


def replay_ms(engine, entry, reps: int = 10, trials: int = 3):
    """Device ms per replay of a captured serve graph (CUDA events on the
    engine's stream, median of ``trials``); None where nothing is captured."""
    if entry.graph is None:
        return None
    times = []
    with engine._serve_lock, torch.cuda.stream(engine._stream):
        for _ in range(trials):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record(engine._stream)
            for _ in range(reps):
                entry.graph.replay()
            z.record(engine._stream)
            z.synchronize()
            times.append(a.elapsed_time(z) / reps)
    entry.replays += reps * trials
    return float(np.median(times))


def serve_bucket(engine, batch: int, frames: np.ndarray):
    """Replay the engine's letterboxed graph of ``batch`` on ``frames`` (RGB,
    640²) and run its serve function eagerly on the same input; returns the
    two packed outputs (host)."""
    entry = engine._serve_fn(batch)
    with engine._serve_lock, engine._on(engine._stream):
        entry.static_in.copy_(torch.from_numpy(frames[:batch]))
        out, _ = entry.run(engine._stream)
        eager = entry.serve_eager(entry.static_in)
    torch.cuda.synchronize()
    return out.numpy().copy(), eager.cpu().numpy()


def raw_diff(ref: dict, got: dict) -> dict:
    """Per scale: correlation and mean |diff| / mean |ref| of raw head outputs."""
    out = {}
    for key, r in ref.items():
        a, b = r.float().flatten(), got[key].float().flatten()
        corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
        out[key] = {"corr": corr, "rel_mean_abs": float((a - b).abs().mean() / a.abs().mean())}
    return out


def phase_int8(card: str) -> dict:
    """int8 serving of the flagship at its published widths (640², 80
    classes, seeded conditioned weights):
      1. calibration (``models.quantize.calibrate_quant_scales``) of the
         bf16 engine's model on 16 640² frames of the shapes generator, made
         here, in batches of 8; the scales written to a sidecar;
      2. per variant (int8, int8_fpn, int8_mhc, int8_vit, int8_all): an
         engine with ``quantization.enabled`` reading the sidecar, graphs at
         buckets 1 and 16; kernel A's launches per replay (its sites) and
         ``_int_mm``'s, counted at capture; each replay bitwise equal to its
         eager serve function; device ms per replay beside bf16's; raw head
         outputs against bf16's (``INT8_RAW_*``);
      3. ``_int_mm``'s int32 accumulators on the card equal to the plain
         (CPU) product, exactly, at every product shape of a b16 forward of
         int8_all, and at ragged shapes (its zero padding);
      4. a ``reload`` with every scale times ``INT8_RELOAD_FACTOR`` changes
         the replay's output (and equals the eager forward after it); a
         reload back restores it bitwise.
    Returns kernel A's launches over the variants' replays."""
    import gc
    import shutil
    import tempfile

    from hvs_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
    from hvs_tpu_torch.data import generate_shapes_image
    from hvs_tpu_torch.inference import InferenceEngine
    from hvs_tpu_torch.inference.engine import WARMUP_CALLS
    from hvs_tpu_torch.models import compute_constraints, load_constraints, param_tree
    from hvs_tpu_torch.models.quantize import calibrate_quant_scales
    from hvs_tpu_torch.ops import quant as quant_mod

    workdir = tempfile.mkdtemp(prefix="hvs_int8_smoke_")
    launches = {"mhc_block": 0}
    try:
        rng = np.random.default_rng(0)
        frames = np.stack([generate_shapes_image(rng, size=IMAGE, num_classes=80)[0]
                           for _ in range(INT8_CALIB_IMAGES)])
        params = int8_params()
        float_engine = InferenceEngine(*int8_configs(), variables={"params": params})
        device = float_engine.device
        mean = torch.tensor(IMAGENET_MEAN, device=device)
        std = torch.tensor(IMAGENET_STD, device=device)
        normalized = (torch.from_numpy(frames).to(device).float() / 255.0 - mean) / std
        batches = list(normalized.split(INT8_CALIB_BATCH))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scales = calibrate_quant_scales(float_engine.model, batches)
        calib_s = time.perf_counter() - t0
        sidecar = f"{workdir}/quant_scales.pt"
        torch.save(scales, sidecar)
        print(json.dumps({"phase": "int8_calibrate", "images": INT8_CALIB_IMAGES,
                          "batch": INT8_CALIB_BATCH, "seconds": calib_s, "sites": len(scales),
                          "min_scale": float(min(scales.values())),
                          "max_scale": float(max(scales.values())), "card": card}), flush=True)
        if not all(np.isfinite(float(v)) and float(v) > 0 for v in scales.values()):
            fail(f"int8: calibration gave non-finite or zero scales: {scales}")

        with torch.inference_mode():
            ref_raw = float_engine.model(normalized)["detection"]["raw"]
            fp32 = int8_configs()[0]
            fp32.precision = "fp32"
            fp32_model = fp32.build_model(production=True).eval()
            for name, p in fp32_model.named_parameters():
                p.copy_(params[name])
            load_constraints(fp32_model, compute_constraints(param_tree(fp32_model)))
            floor = raw_diff(ref_raw, fp32_model(normalized)["detection"]["raw"])
            del fp32_model
        print(json.dumps({"phase": "int8_noise_floor", "bf16_vs_fp32": floor, "card": card}),
              flush=True)
        bf16_ms = {}
        for b in INT8_BUCKETS:
            serve_bucket(float_engine, b, frames)
            bf16_ms[b] = replay_ms(float_engine, float_engine._serve_fn(b))
        del float_engine
        gc.collect()
        torch.cuda.empty_cache()

        rows, shapes_seen = {}, {}
        for label, ((fpn, mhc, vit), sites) in INT8_VARIANTS.items():
            zero_counts()
            engine = InferenceEngine(*int8_configs(sidecar, fpn, mhc, vit),
                                     variables={"params": params})
            row = {"phase": "int8_variant", "variant": label, "kernel_sites": engine.kernel_sites,
                   "buckets": {}}
            for b in INT8_BUCKETS:
                a0, m0 = mhc_mod.launches, quant_mod.launches
                engine._serve_fn(b)  # capture: WARMUP_CALLS eager calls and the capture
                calls = WARMUP_CALLS + 1
                a_per, mm_per = ((mhc_mod.launches - a0) / calls,
                                 (quant_mod.launches - m0) / calls)
                graph, eager = serve_bucket(engine, b, frames)
                row["buckets"][b] = {
                    "a_per_replay": a_per, "int_mm_per_replay": mm_per,
                    "bitwise_equal_eager": bool(np.array_equal(graph, eager)),
                    "max_abs_diff_eager": packed_max_diff(graph, eager),
                    "detections": int(graph[:, 0, 6].sum()),
                    "ms": replay_ms(engine, engine._serve_fn(b)), "bf16_ms": bf16_ms[b]}
            with torch.inference_mode():
                row["raw_vs_bf16"] = raw_diff(ref_raw, engine.model(normalized)["detection"]["raw"])
            if label == "int8_all":
                with recorded_products(quant_mod) as seen, torch.inference_mode():
                    engine.model(normalized)
                shapes_seen = seen
            if label == "int8":
                row["reload"] = int8_reload_check(engine, scales, frames)
            replays = sum(engine.replays.values())
            launches["mhc_block"] += replays * engine.kernel_sites
            row.update(replays=replays, card=card)
            print(json.dumps(row), flush=True)
            rows[label] = row
            del engine
            gc.collect()
            torch.cuda.empty_cache()

        products = int_mm_check(quant_mod, shapes_seen)
        print(json.dumps({"phase": "int8_int_mm", **products, "card": card}), flush=True)
        print(json.dumps({"phase": "int8_summary", "device_ms": {
            label: {str(b): r["buckets"][b]["ms"] for b in INT8_BUCKETS}
            for label, r in rows.items()}, "bf16_ms": {str(b): bf16_ms[b] for b in INT8_BUCKETS},
            "a_per_replay": {label: r["kernel_sites"] for label, r in rows.items()},
            "int_mm_per_replay": {label: r["buckets"][SERVE_BATCH]["int_mm_per_replay"]
                                  for label, r in rows.items()},
            "card": card}), flush=True)

        for label, row in rows.items():
            sites = INT8_VARIANTS[label][1]
            for b, r in row["buckets"].items():
                if row["kernel_sites"] != sites or r["a_per_replay"] != sites:
                    fail(f"int8 {label}: kernel A launched {r['a_per_replay']} times per call "
                         f"at bucket {b} over {row['kernel_sites']} sites; expected {sites}")
                if r["int_mm_per_replay"] <= 0:
                    fail(f"int8 {label}: no _int_mm launch at bucket {b}: {row}")
                if not r["bitwise_equal_eager"] or r["detections"] == 0:
                    fail(f"int8 {label}: bucket {b} replay against eager: {r}")
            for key, d in row["raw_vs_bf16"].items():
                if not (d["corr"] >= INT8_RAW_MIN_CORR and d["rel_mean_abs"] <= INT8_RAW_MAX_REL):
                    fail(f"int8 {label}: raw {key} against bf16 {d}; limits corr >= "
                         f"{INT8_RAW_MIN_CORR}, rel <= {INT8_RAW_MAX_REL}")
        reload = rows["int8"]["reload"]
        if not (reload["changed"] and reload["equals_eager_after"] and reload["restored"]):
            fail(f"int8: reload of scales: {reload}")
        if not products["all_equal"] or products["shapes"] == 0:
            fail(f"int8: _int_mm against the plain product: {products}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches


def int8_params() -> dict:
    """The int8 phase's weights: the engine phase's conditioned seed-0 ones."""
    return conditioned_params(0)


@contextlib.contextmanager
def recorded_products(quant_mod):
    """Every ``int_mm`` call's operands, one pair per (M, K, N)."""
    seen, orig = {}, quant_mod.int_mm

    def spy(a, b_t):
        seen.setdefault((a.shape[0], a.shape[1], b_t.shape[0]), (a, b_t))
        return orig(a, b_t)

    quant_mod.int_mm = spy
    try:
        yield seen
    finally:
        quant_mod.int_mm = orig


def int_mm_check(quant_mod, seen: dict) -> dict:
    """``int_mm`` on the card against ``int_mm_plain`` (CPU), exactly, on the
    recorded operands and on ragged shapes that take the zero padding."""
    g = torch.Generator(device="cpu").manual_seed(0)
    ragged = {}
    for m, k, n in ((5, 20, 12), (17, 8, 8), (300, 36, 3)):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        device = next(iter(seen.values()))[0].device if seen else "cpu"
        ragged[(m, k, n)] = (a.to(device), b.to(device))
    before = quant_mod.launches
    rows, all_equal = [], True
    for (m, k, n), (a, b_t) in {**seen, **ragged}.items():
        got = quant_mod.int_mm(a, b_t)
        want = quant_mod.int_mm_plain(a, b_t)
        equal = bool(torch.equal(got.cpu(), want))
        all_equal &= equal
        rows.append({"m": m, "k": k, "n": n, "equal": equal, "ragged": (m, k, n) in ragged})
    quant_mod.launches = before  # comparison launches are not the path's
    return {"shapes": len(rows), "site_shapes": len(seen), "all_equal": all_equal,
            "rows": rows}


def int8_reload_check(engine, scales: dict, frames: np.ndarray) -> dict:
    """Reload with every scale times ``INT8_RELOAD_FACTOR``: the b16 replay
    changes and equals the eager forward; a reload back restores it."""
    params = {k: v.detach().clone() for k, v in engine.model.named_parameters()}
    return reload_check(engine, {"params": params, "quant": {k: v * INT8_RELOAD_FACTOR
                                                             for k, v in scales.items()}},
                        {"params": params, "quant": scales}, frames)


# ---------------------------------------------------------------------------
# The retrieval-augmented model

# The rag phase: the flagship with rag.enabled and the shapes benchmark's 8
# classes (its knowledge base 8 + 5 facts), seeded conditioned weights with
# the gate at RAG_GATE (at its init value 0 the blend changes nothing). Its
# knowledge module's mHC layer (rag/mhc_fuse, d = 256 on the stride-8 map) is
# a 19th kernel-A site and a 26th mHC matrix. Training: train_device's
# captured step at 416² batch 16 on 64 seeded 640² images, 2 chunks of 5
# steps, a validation pass at 416² batch 4.
RAG_CLASSES, RAG_GATE = 8, 0.5
RAG_SITES, RAG_MATRICES = KERNEL_SITES + 1, 26
RAG_BUCKETS = (1, SERVE_BATCH)
RAG_TRAIN_IMAGES, RAG_TRAIN_IMAGE, RAG_CHUNKS, RAG_CHUNK_STEPS = 64, 416, 2, 5
RAG_EXPORT_CALLS = 3


def rag_model_config():
    from hvs_tpu_torch.config import ModelConfig
    from hvs_tpu_torch.data.shapes import class_names_for

    mcfg = ModelConfig()
    mcfg.detection.num_classes = RAG_CLASSES
    mcfg.rag.enabled, mcfg.rag.class_names = True, class_names_for(RAG_CLASSES)
    return mcfg


def rag_params(seed: int) -> dict:
    params = conditioned_params(seed, rag_model_config())
    params["rag_gate"].fill_(RAG_GATE)
    return params


def rag_production_model(seed: int):
    """The rag phase's serve model with its seeded init and the gate set (for
    ``phase_parity``)."""
    model = rag_model_config().build_model(production=True, seed=seed)
    with torch.no_grad():
        model.rag_gate.fill_(RAG_GATE)
    return model


def phase_rag(card: str) -> dict:
    """The retrieval model at full width, through the entry points:
      1. ``InferenceEngine`` at 640² with graphs at buckets 1 and 16: B at
         26 matrices at load, A at 19 launches per replay (counted at
         capture), each replay bitwise its eager serve function, device ms
         per replay; kernel A at rag/mhc_fuse (102,400 tokens at b16) on the
         tokens the site receives in a b16 forward, against its plain
         version, with its time and bound;
      2. ``reload`` of seed-1 weights and back (B at 26 per reload; the
         replay changes, equals the eager forward, and comes back bitwise)
         and ``rebuild_serve_fns`` (the recaptured graph gives the same
         output);
      3. ``ModelExporter``: the ``.pt2`` program of the b1 serve function,
         19 ``hvs::mhc_block`` nodes and 19 launches per call, consistent
         with the serve function;
      4. the card's raw head outputs against the CPU's (``phase_parity``
         with the rag model, the gate nonzero);
      5. ``train_device --use-rag``: captured steps at 416² batch 16 (B 15 +
         10 per step) and a validation pass (C at 19 per batch).
    Returns the kernels' launches over the phase's main-path runs."""
    import gc
    import shutil
    import tempfile

    from hvs_tpu_torch import train_device
    from hvs_tpu_torch.config import InferenceConfig
    from hvs_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
    from hvs_tpu_torch.data import generate_shapes_image
    from hvs_tpu_torch.deployment import ModelExporter
    from hvs_tpu_torch.inference import InferenceEngine
    from hvs_tpu_torch.inference.engine import WARMUP_CALLS

    launches = {"mhc_block": 0, "mhc_block_unfolded": 0, "sinkhorn_forward": 0,
                "sinkhorn_backward": 0}
    workdir = tempfile.mkdtemp(prefix="hvs_rag_smoke_")
    try:
        # 1. The engine.
        icfg = InferenceConfig()
        icfg.preprocessing.image_size = IMAGE
        icfg.performance.batch_buckets = RAG_BUCKETS
        params, other = rag_params(0), rag_params(1)
        zero_counts()
        t0 = time.perf_counter()
        engine = InferenceEngine(rag_model_config(), icfg, variables={"params": params})
        load_s = time.perf_counter() - t0
        at_load = kernel_counts()["sinkhorn_forward"]
        rng = np.random.default_rng(0)
        frames = np.stack([generate_shapes_image(rng, size=IMAGE, num_classes=RAG_CLASSES)[0]
                           for _ in range(SERVE_BATCH)])
        buckets = {}
        for b in RAG_BUCKETS:
            a0 = mhc_mod.launches
            engine._serve_fn(b)  # capture: WARMUP_CALLS eager calls and the capture
            a_per = (mhc_mod.launches - a0) / (WARMUP_CALLS + 1)
            graph, eager = serve_bucket(engine, b, frames)
            buckets[b] = {"a_per_replay": a_per,
                          "bitwise_equal_eager": bool(np.array_equal(graph, eager)),
                          "detections": int(graph[:, 0, 6].sum()),
                          "ms": replay_ms(engine, engine._serve_fn(b))}
        row = {"phase": "rag_engine", "image": IMAGE, "classes": RAG_CLASSES, "gate": RAG_GATE,
               "kernel_sites": engine.kernel_sites, "sinkhorn_at_load": at_load,
               "knowledge_rows": int(engine.model.rag.kb.shape[0]), "load_s": load_s,
               "buckets": buckets, "card": card}
        print(json.dumps(row), flush=True)
        if engine.kernel_sites != RAG_SITES or at_load != RAG_MATRICES \
                or row["knowledge_rows"] != RAG_CLASSES + 5:
            fail(f"rag engine: {row}; expected {RAG_SITES} kernel-A sites, {RAG_MATRICES} "
                 f"kernel-B launches at load")
        for b, r in buckets.items():
            if r["a_per_replay"] != RAG_SITES or not r["bitwise_equal_eager"] \
                    or r["detections"] == 0:
                fail(f"rag engine bucket {b}: {r}")

        # Kernel A at the knowledge module's site, on the tokens it receives.
        fuse = engine.model.rag.mhc_fuse
        seen = {}

        def keep_input(module, args):
            seen["x"] = args[0].reshape(-1, module.dim).contiguous().clone()

        hook = fuse.register_forward_pre_hook(keep_input)
        mean = torch.tensor(IMAGENET_MEAN, device=engine.device)
        std = torch.tensor(IMAGENET_STD, device=engine.device)
        with torch.inference_mode():
            engine.model((torch.from_numpy(frames).to(engine.device).float() / 255.0 - mean)
                         / std)
        hook.remove()
        x = seen["x"]
        n, d = x.shape
        # The site's own weights at their init are ill-conditioned in their
        # GELUs (H_post near 1; GELU_FP64_MARGIN's comment): the check holds
        # the kernel on this site's tokens with the kernel phase's weights.
        _, args = mhc_inputs(1, d, seed=d)
        out, ref = mhc_mod.mhc_block(x, *args), mhc_mod.mhc_block_plain(x, *args)
        torch.cuda.synchronize()
        a_, b_ = out.float().flatten().cpu().numpy(), ref.float().flatten().cpu().numpy()
        corr, mean_abs = float(np.corrcoef(a_, b_)[0, 1]), float(np.mean(np.abs(a_ - b_)))
        bound, bound_by = mhc_bound_ms(n, d)
        site = {"phase": "rag_kernel_site", "site": "rag.mhc_fuse", "n": n, "d": d,
                "corr": corr, "mean_abs_err": mean_abs,
                "max_abs_err": float(np.max(np.abs(a_ - b_))),
                "ms": time_ms(lambda: mhc_mod.mhc_block(x, *args)),
                "plain_ms": time_ms(lambda: mhc_mod.mhc_block_plain(x, *args)),
                "bound_ms": bound, "bound_by": bound_by, "card": card}
        print(json.dumps(site), flush=True)
        if n != SERVE_BATCH * (IMAGE // 8) ** 2 or not np.isfinite(a_).all() \
                or not (corr > KERNEL_MIN_CORR and mean_abs < KERNEL_MAX_MEAN_ABS):
            fail(f"rag: kernel A at rag.mhc_fuse disagrees with its plain version: {site}")

        # 2. Hot swap and recapture.
        zero_counts()
        swap = reload_check(engine, {"params": other}, {"params": params}, frames)
        swap["sinkhorn_per_reload"] = kernel_counts()["sinkhorn_forward"] / 2
        before, _ = serve_bucket(engine, 1, frames)
        engine.rebuild_serve_fns()
        after, _ = serve_bucket(engine, 1, frames)
        swap["recaptured_equal"] = bool(np.array_equal(before, after))
        print(json.dumps({"phase": "rag_reload", **swap, "card": card}), flush=True)
        if not (swap["changed"] and swap["equals_eager_after"] and swap["restored"]
                and swap["recaptured_equal"]) or swap["sinkhorn_per_reload"] != RAG_MATRICES:
            fail(f"rag: reload and rebuild_serve_fns: {swap}")
        launches["mhc_block"] += sum(engine.replays.values()) * RAG_SITES

        # 3. The exported program.
        exporter = ModelExporter(engine.model, IMAGE)
        path = os.path.join(workdir, "rag.pt2")
        t0 = time.perf_counter()
        exporter.export_program(path, batch=1)
        export_s = time.perf_counter() - t0
        program = exporter.load_program(path)
        xin = exporter.example_input(1)
        zero_counts()
        with torch.no_grad():
            for _ in range(RAG_EXPORT_CALLS):
                program(xin)
        torch.cuda.synchronize()
        program_launches = mhc_mod.launches
        report = exporter.consistency_check(path, rtol=EXPORT_RTOL, batch=1)
        row = {"phase": "rag_export", "export_s": export_s, "calls": RAG_EXPORT_CALLS,
               "mhc_block_launches": program_launches,
               "mhc_block_nodes": sum("hvs.mhc_block" in str(nd.target)
                                      for nd in program.graph.nodes), **report, "card": card}
        print(json.dumps(row), flush=True)
        if program_launches != RAG_SITES * RAG_EXPORT_CALLS or row["mhc_block_nodes"] != RAG_SITES \
                or not report["consistent"]:
            fail(f"rag: exported program: {row}")
        launches["mhc_block"] += program_launches
        del engine, program, exporter
        gc.collect()
        torch.cuda.empty_cache()

        # 4. Card against CPU with the gate open.
        phase_parity(card, build=rag_production_model, name="rag_parity")

        # 5. Training with --use-rag: captured steps and a validation pass.
        n_widths = len(set(SINKHORN_MIX))
        want_step = {"mhc_block": 0, "mhc_block_unfolded": 0, "sinkhorn_forward": 3 * n_widths,
                     "sinkhorn_backward": 2 * n_widths}
        want_val = {"mhc_block": 0, "mhc_block_unfolded": RAG_SITES,
                    "sinkhorn_forward": n_widths, "sinkhorn_backward": 0}
        steps = RAG_CHUNKS * RAG_CHUNK_STEPS
        zero_counts()
        t0 = time.perf_counter()
        trainer, summary = train_device.run(train_device.parse_args([
            "--synthetic", str(RAG_TRAIN_IMAGES), "--use-rag", "--num-classes",
            str(RAG_CLASSES), "--train-sizes", str(RAG_TRAIN_IMAGE), "--total-steps",
            str(steps), "--chunk-steps", str(RAG_CHUNK_STEPS), "--val-every-chunks",
            str(RAG_CHUNKS), "--eig-every-chunks", str(RAG_CHUNKS), "--run-dir",
            f"{workdir}/run"]))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        (size, chunk), = trainer.chunks.items()
        val = trainer.val_chunk
        with open(f"{workdir}/run/steps.jsonl") as f:
            log = [json.loads(line) for line in f]
        row = {"phase": "rag_train", "image": size, "batch": chunk.batch_size,
               "steps": summary["steps"], "wall_s": wall_s,
               "ms_per_step": [t["wall_ms"] / RAG_CHUNK_STEPS for t in chunk.timings],
               "capture_s": chunk.capture_s, "loss_first": log[0]["loss"],
               "loss_last": log[-1]["loss"], "best_val_loss": summary["best_val_loss"],
               "rag_gate": float(trainer.model.rag_gate.detach()),
               "launches_per_step": chunk.launches, "replays": chunk.replays,
               "launches_per_val_batch": val.launches, "val_batches": val.n_batches,
               "val_replays": val.replays, "card": card}
        print(json.dumps(row), flush=True)
        if (chunk.launches, chunk.replays, summary["steps"]) != (want_step, steps, steps) \
                or (val.launches, val.replays) != (want_val, val.n_batches):
            fail(f"rag: train_device --use-rag launched {row}; expected {want_step} per step "
                 f"over {steps} replays and {want_val} per validation batch")
        values = [r[k] for r in log for k in ("loss", "grad_norm", "ds_error_max")]
        if len(log) != steps or not np.isfinite(values + [summary["best_val_loss"]]).all() \
                or row["rag_gate"] == 0.0:
            fail(f"rag: train_device --use-rag: non-finite metrics or a gate that never moved "
                 f"{row}")
        add_replayed(launches, chunk, val)
        del trainer, chunk, val
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches


def manifold_encoder(seed: int, device, **kw):
    """The manifold-attention encoder at the flagship's ViT widths, seeded."""
    from hvs_tpu_torch.models import HybridVisionEncoder
    from hvs_tpu_torch.models.layers import init_weights

    enc = HybridVisionEncoder(MA_CHANNELS, MA_DIM, MA_DEPTH, MA_HEADS, dtype=torch.bfloat16,
                              use_manifold_attention=True, sk_iters=SK_ITERS, **kw)
    init_weights(enc, seed)
    return enc.to(device)


def phase_manifold_attention(card: str) -> dict:
    """The slice's path: ``HybridVisionEncoder(use_manifold_attention=True)``
    at the flagship's ViT widths in bf16 on a seeded [16, 20, 20, 512] map
    (the scale_large map of a 640² batch of 16; 401 tokens). 31 mHC layers:
    per block the attention's ``mhc_q``, ``mhc_k``, ``mhc_v``, ``mhc_out``
    ([256, 512] expansions, no fused block) and the FFN, then ``mhc_fuse``
    (d = 512, kernels A and C). The phase pins the matmul precision flags
    through ``device.pin_matmul_precision``, as the package's entry points do.
      1. 10 eager training steps (dropout 0.1): the forward (each layer
         projects its own H_res: B forward and backward per layer), the
         manifold regulariser (one grouped projection per width), the
         backward and ``ManifoldAwareOptimizer`` (its projection, one launch
         per width every step; applied every ``MA_PROJECT_EVERY``): ms per
         step, peak memory, B's launches per step against that count;
      2. the serve encoder (dropout 0, constraints at load): B's launches at
         load (31), A's per forward (1, at mhc_fuse, 6,400 rows), ms per
         forward, and at batch 2 against the same encoder on the CPU (H_res
         near identity, as ``phase_parity`` conditions the flagship) at
         ``E2E_MIN_CORR`` / ``E2E_MAX_MEAN_ABS``;
      3. a deterministic forward of the training encoder without autograd:
         C at mhc_fuse (1) and B per layer (31); ms per forward.
    Returns the kernels' launches over the three runs."""
    import copy

    from hvs_tpu_torch.device import pin_matmul_precision
    from hvs_tpu_torch.models import compute_constraints, load_constraints, param_tree
    from hvs_tpu_torch.models.layers import ManifoldHyperConnection
    from hvs_tpu_torch.training import ManifoldAwareOptimizer, manifold_regularization_loss

    pin_matmul_precision()
    dev = torch.device("cuda")
    r = np.random.default_rng(0)
    shape = (MA_BATCH, MA_GRID, MA_GRID, MA_CHANNELS)
    feat = torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    target = torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(dev)
    launches = {"mhc_block": 0, "mhc_block_unfolded": 0, "sinkhorn_forward": 0,
                "sinkhorn_backward": 0}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # 1. Training.
    enc = manifold_encoder(0, dev, dropout_rate=0.1).train()
    layers = [m for m in enc.modules() if isinstance(m, ManifoldHyperConnection)]
    widths = sorted({m.dim for m in layers})
    params = dict(enc.named_parameters())
    tx = ManifoldAwareOptimizer(params, MA_LR, project_every=MA_PROJECT_EVERY,
                                sk_iters=SK_ITERS)

    def step():
        loss = (enc(feat).float() - target).square().mean()
        reg, _ = manifold_regularization_loss(params, sk_iters=SK_ITERS)
        total = loss + 0.01 * reg
        grads = torch.autograd.grad(total, list(params.values()))
        tx.step(dict(zip(params, grads)))
        return total.detach()

    for _ in range(MA_WARMUP):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    a_ev, b_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a_ev.record()
    losses = [step() for _ in range(MA_STEPS)]
    b_ev.record()
    b_ev.synchronize()
    counts = kernel_counts()
    add(counts)
    losses = [float(v) for v in losses]
    per_step = {k: v / MA_STEPS for k, v in counts.items()}
    want = {"sinkhorn_forward": len(layers) + 2 * len(widths),
            "sinkhorn_backward": len(layers) + len(widths)}
    train = {"phase": "manifold_attention_train", "batch": MA_BATCH, "tokens": 1 + MA_GRID ** 2,
             "mhc_layers": len(layers), "widths": widths, "steps": MA_STEPS,
             "ms_per_step": a_ev.elapsed_time(b_ev) / MA_STEPS,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
             "loss_first": losses[0], "loss_last": losses[-1], "launches_per_step": per_step,
             "expected_per_step": want, "card": card}
    print(json.dumps(train), flush=True)
    if len(layers) != 5 * MA_DEPTH + 1 or not np.isfinite(losses).all() \
            or any(per_step[k] != v for k, v in want.items()) \
            or per_step["mhc_block"] or per_step["mhc_block_unfolded"]:
        fail(f"manifold_attention: training steps {train}")

    # 3. A deterministic forward of the training encoder, no autograd.
    enc.eval()
    zero_counts()
    with torch.no_grad():
        det = enc(feat)
    torch.cuda.synchronize()
    counts = kernel_counts()
    add(counts)
    with torch.no_grad():
        det_ms = time_ms_eager(lambda: enc(feat))
    deterministic = {"phase": "manifold_attention_eval", "launches": counts, "ms": det_ms,
                     "card": card}
    print(json.dumps(deterministic), flush=True)
    if counts["mhc_block_unfolded"] != 1 or counts["sinkhorn_forward"] != len(layers) \
            or counts["mhc_block"] or not bool(torch.isfinite(det.float()).all()):
        fail(f"manifold_attention: deterministic forward {deterministic}")
    del enc, tx, params, det

    # 2. The serve encoder, against the CPU.
    serve = manifold_encoder(1, dev, dropout_rate=0.0, precomputed_constraints=True).eval()
    with torch.no_grad():
        for m in serve.modules():
            if isinstance(m, ManifoldHyperConnection):
                d = m.dim
                m.H_res_raw.copy_(torch.from_numpy(
                    (6.0 * np.eye(d) + r.standard_normal((d, d))).astype(np.float32)))
    cpu = copy.deepcopy(serve).to("cpu")
    zero_counts()
    set_count = load_constraints(serve, compute_constraints(param_tree(serve), SK_ITERS))
    torch.cuda.synchronize()
    at_load = kernel_counts()
    add(at_load)
    zero_counts()
    with torch.inference_mode():
        out = serve(feat)
    torch.cuda.synchronize()
    per_forward = kernel_counts()
    add(per_forward)
    with torch.inference_mode():
        serve_ms = time_ms_eager(lambda: serve(feat))
        load_constraints(cpu, compute_constraints(param_tree(cpu), SK_ITERS))
        small = serve(feat[:MA_CPU_BATCH]).float().cpu().flatten().numpy()
        ref = cpu(feat[:MA_CPU_BATCH].cpu()).float().flatten().numpy()
    corr = float(np.corrcoef(small, ref)[0, 1])
    mean_abs = float(np.mean(np.abs(small - ref)))
    row = {"phase": "manifold_attention_serve", "layers_set": set_count,
           "sinkhorn_at_load": at_load["sinkhorn_forward"], "launches_per_forward": per_forward,
           "ms_per_forward": serve_ms, "cpu_batch": MA_CPU_BATCH, "cpu_corr": corr,
           "cpu_mean_abs_err": mean_abs, "cpu_max_abs_err": float(np.max(np.abs(small - ref))),
           "card": card}
    print(json.dumps(row), flush=True)
    if set_count != len(layers) or at_load["sinkhorn_forward"] != len(layers) \
            or per_forward["mhc_block"] != 1 or per_forward["sinkhorn_forward"] \
            or per_forward["mhc_block_unfolded"] or not bool(torch.isfinite(out.float()).all()) \
            or not (corr > E2E_MIN_CORR and mean_abs < E2E_MAX_MEAN_ABS):
        fail(f"manifold_attention: serve encoder {row} (corr need > {E2E_MIN_CORR}, mean "
             f"|diff| < {E2E_MAX_MEAN_ABS})")
    return launches


# ---------------------------------------------------------------------------
# The measurement and accuracy entry points, run as a user runs them

BENCH_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "batch1_frame_ms"}  # bench.py
BENCH_QUANT = "1"
BENCHMARK_BATCHES = (1, SERVE_BATCH)
BENCHMARK_FILES = ("benchmark.json", "throughput.csv", "benchmark.md")
BENCHMARK_LINE_KEYS = {"best_throughput_fps", "e2e_p50_ms", "output_dir"}
SERVE_BENCH_SECONDS = 5
SERVE_BENCH_BUCKET = 1  # where the engine, not the client's JPEG decode, is the bottleneck
SERVE_BENCH_REPORT_KEYS = {  # scripts/serve_bench.py's report
    "mode", "sustained_fps_host_inclusive", "offered_rate_fps", "seconds", "frames",
    "submitted", "shed_or_rejected", "image_size", "p50_ms", "p95_ms", "p99_ms", "mean_ms",
    "meets_latency_target", "sla", "overload_policy", "host_letterbox", "path", "engine_stats"}
SWEEP_RESOLUTIONS = (320, DATA_IMAGE)
SWEEP_REPORT_KEYS = {"benchmark", "checkpoint", "trained_steps", "headline",
                     "resolution_sweep", "criteria", "reference"}
STABILITY_KEYS = {  # scripts/summarize_run.py's output with --chunks and --report
    "steps", "all_finite", "loss_first_1pct_mean", "loss_last_1pct_mean", "loss_min",
    "loss_window_means", "grad_norm", "ds_error_max_overall", "lr_scale_final",
    "lr_scale_min", "steps_per_sec_median", "wall_hours", "diverged",
    "eigenvalue_telemetry", "ds_error_proj_max_overall", "monitor"}
ENTRY_TIMEOUT_S = 300


def run_entry_point(module: str, args, workdir: str, env: dict = None):
    """Run ``python -m hvs_tpu_torch.<module> ...`` in a subprocess from
    ``workdir`` with the checkout on ``PYTHONPATH``; fail unless it exits 0.
    Returns its stdout, its stderr's last ``kernel_launches`` line (or
    None) and its wall seconds."""
    full = dict(os.environ, **(env or {}))
    full["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", f"hvs_tpu_torch.{module}",
                             *map(str, args)], cwd=workdir, env=full, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(timeout=ENTRY_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"bench: python -m hvs_tpu_torch.{module} ran past {ENTRY_TIMEOUT_S} s")
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"bench: python -m hvs_tpu_torch.{module} exited {proc.returncode}: {err[-3000:]}")
    reports = [json.loads(line) for line in err.splitlines()
               if line.startswith("{") and '"kernel_launches"' in line]
    return out, reports[-1] if reports else None, wall_s


def engine_launches(module: str, report: dict, launches: dict) -> None:
    """Add an engine entry point's launches: A at its sites per replay, B
    as counted (at each load and stability report). Fail unless its engines
    served A at the flagship's 18 sites and A's counter in that process
    saw each of those sites in every graph it captured: WARMUP_CALLS eager
    calls and the capture per graph, and no other call of A or C."""
    from hvs_tpu_torch.inference.engine import WARMUP_CALLS

    counted = report["kernel_launches"]
    want = KERNEL_SITES * (WARMUP_CALLS + 1) * report["graphs"]
    if report["kernel_sites"] != KERNEL_SITES or report["graphs"] < 1 \
            or counted["mhc_block"] != want or counted["mhc_block_unfolded"] != 0:
        fail(f"bench: python -m hvs_tpu_torch.{module} launched {report}; expected "
             f"{KERNEL_SITES} kernel-A sites and A counted {want} times over "
             f"{report['graphs']} graphs")
    launches["mhc_block"] += report["replays"] * KERNEL_SITES
    launches["sinkhorn_forward"] += report["kernel_launches"]["sinkhorn_forward"]


def phase_bench(card: str, data_dir: str) -> dict:
    """The JAX package's measurement and accuracy entry points in the port,
    each run as ``python -m hvs_tpu_torch.<module>`` in a subprocess:
      1. ``bench`` at its defaults (the flagship at 640², random init), then
         with ``HVS_BENCH_QUANT=1`` on a checkpoint of ``conditioned_params``
         (``HVS_BENCH_CHECKPOINT``): one line with ``bench.py``'s keys and a
         value above 0, the captured replay equal to an eager call (on
         detections in the int8 run), kernel A at 18 launches per forward
         and B at 25 at the load;
      2. ``benchmark --batches 1 16 --iters 10 --sustained-s 3``: its three
         files, a row per batch with the card's memory above 0;
      3. ``accuracy_sweep`` of phase ``data``'s ``train_device`` checkpoint
         on its 640² val split (``data_dir``) at 320² and 640²: the report
         with ``scripts/accuracy_sweep.py``'s keys, the 640² entry equal to
         that phase's ``evaluate`` (the same weights and images), and
         ``summarize_run`` on that run's logs: ``scripts/summarize_run.py``'s
         keys, and the numbers ``scripts/torch_run_summary.py`` gives;
      4. ``serve_bench --seconds 5 --bucket 1`` closed, then rated at half
         the closed run's frames/s (nothing shed or rejected), then overload
         at three times it with ``--policy shed_oldest`` (some shed, every
         accepted request completed); the reports with
         ``scripts/serve_bench.py``'s keys. At its default bucket (16) the
         one thread that decodes and submits the JPEGs is slower than the
         engine, so no rate it offers overloads it; at bucket 1 the engine
         is the bottleneck.
    The entry points run one after another, so each has the card alone.
    Returns the kernels' launches over the entry points: A per forward times
    the eager calls and replays of ``bench``, each engine's replays times
    its 18 sites (once A's counter in that process agrees with the graphs it
    captured), and B as each process counted it."""
    import gc
    import importlib.util
    import shutil
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()  # this process's cached blocks, for the subprocesses
    t_phase = time.perf_counter()
    launches = {"mhc_block": 0, "sinkhorn_forward": 0, "sinkhorn_backward": 0,
                "mhc_block_unfolded": 0}
    walls = {}
    workdir = tempfile.mkdtemp(prefix="hvs_bench_smoke_")
    try:
        # 1. bench, at the defaults and int8 on conditioned weights.
        checkpoint = f"{workdir}/conditioned.pt"
        torch.save({"params": {k: v.cpu() for k, v in conditioned_params(0).items()}},
                   checkpoint)
        for name, env in (("default", {}), ("int8", {"HVS_BENCH_QUANT": BENCH_QUANT,
                                                     "HVS_BENCH_CHECKPOINT": checkpoint})):
            out, report, walls[f"bench_{name}"] = run_entry_point("bench", [], workdir, env)
            lines = out.strip().splitlines()
            line = json.loads(lines[-1])
            want_keys = BENCH_LINE_KEYS | ({"checkpoint"} if name == "int8" else set())
            row = {"phase": "bench_headline", "run": name, "line": line, "lines": len(lines),
                   **report, "wall_s": walls[f"bench_{name}"], "card": card}
            print(json.dumps(row), flush=True)
            if len(lines) != 1 or set(line) != want_keys or not line["value"] > 0 \
                    or not report["replay_equals_eager"] \
                    or report["mhc_block_per_forward"] != KERNEL_SITES \
                    or report["graphs"] != 2 or report["mhc_block_counted"] \
                    != KERNEL_SITES * (report["eager_forwards"] + report["graphs"]) \
                    or report["sinkhorn_at_load"] != len(SINKHORN_MIX) \
                    or (name == "int8" and report["detections_compared"] == 0):
                fail(f"bench: python -m hvs_tpu_torch.bench ({name}): {row}")
            for k in launches:
                launches[k] += report["kernel_launches"][k]

        # 2. benchmark.
        out_dir = f"{workdir}/benchmark_results"
        out, report, walls["benchmark"] = run_entry_point("benchmark", [
            "--batches", *BENCHMARK_BATCHES, "--iters", 10, "--sustained-s", 3,
            "--output", out_dir], workdir)
        line = json.loads(out.strip().splitlines()[-1])
        with open(f"{out_dir}/benchmark.json") as f:
            results = json.load(f)
        sweep = results.get("throughput", {})
        row = {"phase": "bench_benchmark", "line": line, "throughput": sweep,
               "end_to_end": results.get("end_to_end"),
               "sustained_fps": results.get("sustained", {}).get("fps"),
               "files": sorted(os.listdir(out_dir)), "replays": report["replays"],
               "graphs": report["graphs"],
               "mhc_block_counted": report["kernel_launches"]["mhc_block"],
               "wall_s": walls["benchmark"], "card": card}
        print(json.dumps(row), flush=True)
        if set(line) != BENCHMARK_LINE_KEYS or not set(BENCHMARK_FILES) <= set(row["files"]) \
                or set(sweep) != {str(b) for b in BENCHMARK_BATCHES} \
                or not all(r["device_mem_mb"] > 0 and r["throughput_fps"] > 0
                           for r in sweep.values()) or not row["sustained_fps"]:
            fail(f"bench: python -m hvs_tpu_torch.benchmark: {row}")
        engine_launches("benchmark", report, launches)

        # 3. The sweep against phase data's evaluate; the run summary.
        root, run_dir = f"{data_dir}/shapes640", f"{data_dir}/run"
        sweep_out, stability_out = f"{workdir}/accuracy_sweep.json", f"{workdir}/stability.json"
        _, report, walls["accuracy_sweep"] = run_entry_point("accuracy_sweep", [
            "--checkpoint", f"{run_dir}/checkpoints/final", "--data-root", root,
            "--resolutions", ",".join(map(str, SWEEP_RESOLUTIONS)), "--output", sweep_out],
            workdir)
        with open(f"{data_dir}/evaluation.json") as f:
            evaluated = json.load(f)["accuracy"]
        with open(sweep_out) as f:
            got = json.load(f)
        at = got["resolution_sweep"].get(str(DATA_IMAGE), {})
        same = {k: at.get(k) == round(v, 4) for k, v in evaluated.items()}
        row = {"phase": "bench_accuracy_sweep", "resolutions": list(got["resolution_sweep"]),
               "trained_steps": got["trained_steps"],
               "sweep": {r: {k: v for k, v in e.items() if k != "per_class_AP@0.5"}
                         for r, e in got["resolution_sweep"].items()},
               "evaluate": evaluated, "equal_to_evaluate": same, "replays": report["replays"],
               "graphs": report["graphs"],
               "mhc_block_counted": report["kernel_launches"]["mhc_block"],
               "wall_s": walls["accuracy_sweep"], "card": card}
        print(json.dumps(row), flush=True)
        if set(got) != SWEEP_REPORT_KEYS or not all(same.values()) \
                or row["resolutions"] != [str(r) for r in SWEEP_RESOLUTIONS] \
                or got["trained_steps"] != DATA_CHUNKS * DATA_CHUNK_STEPS:
            fail(f"bench: python -m hvs_tpu_torch.accuracy_sweep: {row}")
        engine_launches("accuracy_sweep", report, launches)

        _, _, walls["summarize_run"] = run_entry_point("summarize_run", [
            "--steps", f"{run_dir}/steps.jsonl", "--chunks", f"{run_dir}/chunks.jsonl",
            "--report", f"{run_dir}/stability_report.json", "--output", stability_out], workdir)
        with open(stability_out) as f:
            got = json.load(f)
        spec = importlib.util.spec_from_file_location(
            "torch_run_summary", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                              "scripts", "torch_run_summary.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        other = tool.summarize(run_dir)
        agree = {"grad_norm_p50": got["grad_norm"]["p50"] == other["grad_norm_p50"],
                 "grad_norm_max": got["grad_norm"]["max"] == other["grad_norm_max"],
                 "ds_error_max_overall":
                     got["ds_error_max_overall"] == other["ds_error_max_overall"]}
        row = {"phase": "bench_summarize_run", "summary": got, "agrees_with_run_summary": agree,
               "wall_s": walls["summarize_run"], "card": card}
        print(json.dumps(row), flush=True)
        if set(got) != STABILITY_KEYS or got["steps"] != DATA_CHUNKS * DATA_CHUNK_STEPS \
                or not got["all_finite"] or not all(agree.values()):
            fail(f"bench: python -m hvs_tpu_torch.summarize_run: {row}")

        # 4. serve_bench: closed, rated at half of it, overload at three times.
        serve = {}
        for mode in ("closed", "rated", "overload"):
            extra = []
            if mode == "rated":
                extra = ["--rate", serve["closed"]["sustained_fps_host_inclusive"] / 2]
            elif mode == "overload":
                extra = ["--rate", serve["closed"]["sustained_fps_host_inclusive"] * 3,
                         "--policy", "shed_oldest"]
            output = f"{workdir}/serve_{mode}.json"
            _, report, walls[f"serve_{mode}"] = run_entry_point("serve_bench", [
                "--seconds", SERVE_BENCH_SECONDS, "--bucket", SERVE_BENCH_BUCKET, "--mode", mode,
                *extra, "--output", output], workdir)
            with open(output) as f:
                got = json.load(f)
            serve[mode] = got
            row = {"phase": "bench_serve", **{k: v for k, v in got.items()
                                              if k != "engine_stats"},
                   "batcher": {k: v for k, v in got["engine_stats"].items()
                               if k.startswith(("batcher_", "service_ms"))},
                   "replays": report["replays"], "graphs": report["graphs"],
                   "mhc_block_counted": report["kernel_launches"]["mhc_block"],
                   "wall_s": walls[f"serve_{mode}"], "card": card}
            print(json.dumps(row), flush=True)
            ok = set(got) == SERVE_BENCH_REPORT_KEYS and got["frames"] > 0
            if mode == "rated":
                ok &= got["shed_or_rejected"] == 0
            if mode == "overload":
                ok &= got["shed_or_rejected"] > 0 \
                    and got["frames"] + got["shed_or_rejected"] == got["submitted"]
            if not ok:
                fail(f"bench: python -m hvs_tpu_torch.serve_bench --mode {mode}: {row}")
            engine_launches("serve_bench", report, launches)

        print(json.dumps({"phase": "bench", "seconds": time.perf_counter() - t_phase,
                          "wall_s": walls, "launches": launches, "card": card}), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# The operation count and the roofline tools

ROOFLINE_BUCKETS = "8,16"
ROOFLINE_ITERS = 10  # timed replays per program of the tools
ROOFLINE_TRAIN_ARGS = ["--resolutions", "416", "--iters", "5", "--chunk-warmup", "10",
                       "--chunked-steps", "20"]
ROOFLINE_AB_STEPS = 10
ROOFLINE_IMAGES = 64  # 80-class 640² train images, made in the phase
ROOFLINE_UTIL_MAX = 1.05  # mfu and hbm_utilization must lie in (0, this]
COUNT_KEYS = ("flops", "transcendentals", "bytes accessed")


def count_pair(build, run) -> dict:
    """``run(*build(device))``'s ``cost_analysis`` on the card and on the
    CPU, each after one warm call (device constants and anchor grids are
    copied to the card on a first call only). ``build`` returns the
    arguments with its inputs already on the device: a copy to the card
    would count, the same ``.to`` on the CPU would not."""
    from hvs_tpu_torch.utils.profiler import ModelProfiler

    out = {}
    for dev in ("cuda", "cpu"):
        args = build(torch.device(dev))
        run(*args)
        t0 = time.perf_counter()
        out[dev] = ModelProfiler(lambda: run(*args)).cost_analysis()
        out[f"{dev}_s"] = time.perf_counter() - t0
        del args
    return out


def phase_roofline(card: str) -> dict:
    """The repaired operation count and the tools built on it
    (``python -m hvs_tpu_torch.<tool>``, each called in this process):
      1. counts: a 320² b2 serve forward of the flagship, a 416² b2
         validation forward and a 416² b2 train step of the training model,
         each on the card and on the CPU: flops, transcendentals and bytes
         equal; kernel C's operator counted at its 18 sites of the
         validation forward at 10·N·d² each (``FlopCounterMode``'s count of
         ``hvs::mhc_block_unfolded``);
      2. ``roofline`` at buckets 8 and 16, ``bytes_attribution`` at b16:
         every ``mfu`` and ``hbm_utilization`` in (0, ``ROOFLINE_UTIL_MAX``],
         the stages' flops and bytes summing to the serve call's;
      3. ``train_roofline`` at 416² b16 (5 replays per program, 10 + 20
         chunked steps) on 64 generated 80-class 640² images;
      4. ``gn_fusion_ceiling`` and ``head_fusion_ceiling`` at 10 replays;
      5. ``cls_loss_ab`` at 2 x 10 steps;
      6. the flagship's detection path without mHC (``use_mhc=False`` on the
         backbone, the FPN and the head at their full widths; the ViT blocks
         and the global-feature head, which carry mHC in every JAX
         configuration, left out): no kernel B at its load, no kernel A in
         its 640² b16 forward, finite outputs.
    Returns the kernels' launches over the phase (each tool's own count of
    eager calls, captures and replays; the counts' calls)."""
    import shutil
    import tempfile

    from torch.utils.flop_counter import FlopCounterMode

    from hvs_tpu_torch import (bytes_attribution, cls_loss_ab, gn_fusion_ceiling,
                               head_fusion_ceiling, make_shapes_dataset, roofline,
                               train_roofline)
    from hvs_tpu_torch.inference import Detector
    from hvs_tpu_torch.models import HybridVisionSystem, ProductionHybridVision
    from hvs_tpu_torch.models.backbone import HybridVisionBackbone
    from hvs_tpu_torch.models.constraints import compute_constraints, load_constraints, \
        param_tree
    from hvs_tpu_torch.models.fpn import OUT_CHANNELS, FeaturePyramidNetwork
    from hvs_tpu_torch.models.layers import init_weights
    from hvs_tpu_torch.models.yolo_head import YOLODetectionHead
    from hvs_tpu_torch.train import make_synthetic_loader
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig, train_step
    from hvs_tpu_torch.training.trainer import batch_to, eval_step

    t_phase = time.perf_counter()
    launches = {"mhc_block": 0, "sinkhorn_forward": 0, "sinkhorn_backward": 0,
                "mhc_block_unfolded": 0}

    def add(counts: dict) -> None:
        for k in launches:
            launches[k] += counts[k]

    # 1. The count on the card against the CPU.
    zero_counts()
    r = np.random.default_rng(4)
    image = torch.from_numpy(r.uniform(size=(2, 320, 320, 3)).astype(np.float32))

    @torch.inference_mode()
    def serve_forward(det, images):
        return det.model(images)

    forward = count_pair(
        lambda dev: (Detector(ProductionHybridVision(seed=1, device=dev), device=dev),
                     image.to(dev)), serve_forward)
    host = next(make_synthetic_loader(2, TRAIN_IMAGE, 1, TRAIN_CLASSES, TRAIN_BOXES, seed=5)())
    config = TrainerConfig(num_classes=TRAIN_CLASSES)

    def trainer_on(dev):
        model = HybridVisionSystem(num_classes=TRAIN_CLASSES, monitor=True, seed=1, device=dev)
        trainer = ManifoldConstrainedTrainer(model, config, device=dev)
        trainer.init_state()
        return trainer, batch_to(host, dev)

    def val(t, batch):
        return eval_step(t.model, config, batch)

    def step(t, batch):
        return train_step(t.model, t.tx, config, t.state, batch)

    validation = count_pair(trainer_on, val)
    train = count_pair(trainer_on, step)
    equal = {name: all(c["cuda"][k] == c["cpu"][k] for k in COUNT_KEYS)
             for name, c in (("forward", forward), ("validation", validation),
                             ("train_step", train))}
    t = trainer_on(torch.device("cuda"))
    val(*t)
    before = mhc_mod.launches_unfolded
    counter = FlopCounterMode(display=False)
    with counter:
        val(*t)
    c_sites = mhc_mod.launches_unfolded - before
    c_flops = counter.get_flop_counts()["Global"][torch.ops.hvs.mhc_block_unfolded]
    c_want = sum(10 * n * d * d for n, d in mhc_sites(2, TRAIN_IMAGE))
    del t
    add(kernel_counts())
    row = {"phase": "roofline_count", "equal": equal,
           **{f"{name}_{dev}": {k: c[dev][k] for k in COUNT_KEYS}
              for name, c in (("forward", forward), ("validation", validation),
                              ("train_step", train)) for dev in ("cuda", "cpu")},
           "count_s": {name: {dev: c[f"{dev}_s"] for dev in ("cuda", "cpu")}
                       for name, c in (("forward", forward), ("validation", validation),
                                       ("train_step", train))},
           "c_sites": c_sites, "c_flops": c_flops, "c_flops_formula": c_want, "card": card}
    print(json.dumps(row), flush=True)
    if not all(equal.values()) or c_sites != KERNEL_SITES or c_flops != c_want \
            or train["cuda"]["transcendentals"] <= 0:
        fail(f"roofline: the card's count differs from the CPU's, or C is not counted at "
             f"10·N·d² at its {KERNEL_SITES} sites: {row}")

    workdir = tempfile.mkdtemp(prefix="hvs_roofline_smoke_")
    walls = {}
    try:
        # 2. roofline and bytes_attribution.
        iters = ["--iters", str(ROOFLINE_ITERS)]
        t0 = time.perf_counter()
        rl, counts = roofline.main(["--buckets", ROOFLINE_BUCKETS, *iters,
                                    "--output", f"{workdir}/roofline.json"])
        walls["roofline"] = time.perf_counter() - t0
        add(counts)
        t0 = time.perf_counter()
        ba, counts = bytes_attribution.main([*iters, "--output", f"{workdir}/bytes.json"])
        walls["bytes_attribution"] = time.perf_counter() - t0
        add(counts)
        utils = [v for r_ in rl["buckets"].values() for v in (r_["mfu"], r_["hbm_utilization"])]
        row = {"phase": "roofline_serve", "buckets": rl["buckets"], "stages": ba["stages"],
               "serve": ba["serve"], "stage_sums_equal_serve": ba["stage_sums_equal_serve"],
               "peaks": rl["peaks"], "card": card}
        print(json.dumps(row), flush=True)
        if not all(0 < u <= ROOFLINE_UTIL_MAX for u in utils) \
                or not ba["stage_sums_equal_serve"]:
            fail(f"roofline: a utilization outside (0, {ROOFLINE_UTIL_MAX}] or stage sums "
                 f"unequal to the serve call: {row}")

        # 3. train_roofline on a generated 80-class set.
        root = f"{workdir}/shapes80"
        make_shapes_dataset.main(["--root", root, "--num-classes", "80", "--size", str(IMAGE),
                                  "--train", str(ROOFLINE_IMAGES), "--val", "1"])
        t0 = time.perf_counter()
        tr, counts = train_roofline.main(["--data-root", root, *ROOFLINE_TRAIN_ARGS,
                                          "--output", f"{workdir}/train.json"])
        walls["train_roofline"] = time.perf_counter() - t0
        add(counts)
        res = tr["resolutions"]["416"]
        utils = [res[k][u] for k in ("forward_loss", "forward_backward", "full_step")
                 for u in ("mfu", "hbm_utilization")]
        b_step = res["full_step"]["kernel_launches"]
        row = {"phase": "roofline_train", "resolution": res,
               "chunked_steps_per_sec": tr["chunked_steps_per_sec"], "card": card}
        print(json.dumps(row), flush=True)
        if not all(0 < u <= ROOFLINE_UTIL_MAX for u in utils) \
                or b_step["sinkhorn_forward"] != 15 or b_step["sinkhorn_backward"] != 10 \
                or res["full_step"]["transcendentals"] <= 0:
            fail(f"roofline: train_roofline {row}")

        # 4. The ceilings.
        t0 = time.perf_counter()
        gn, counts = gn_fusion_ceiling.main([*iters, "--output", f"{workdir}/gn.json"])
        walls["gn_fusion_ceiling"] = time.perf_counter() - t0
        add(counts)
        t0 = time.perf_counter()
        head, counts = head_fusion_ceiling.main([*iters, "--output", f"{workdir}/head.json"])
        walls["head_fusion_ceiling"] = time.perf_counter() - t0
        add(counts)
        row = {"phase": "roofline_ceilings", "gn": gn, "head": head, "card": card}
        print(json.dumps(row), flush=True)
        if not (gn["no_gn_se"]["bytes_accessed"] < gn["full"]["bytes_accessed"]
                and head["head_gn_identity"]["bytes_accessed"]
                < head["full"]["bytes_accessed"]):
            fail(f"roofline: an ablation did not remove bytes: {row}")

        # 5. cls_loss_ab.
        t0 = time.perf_counter()
        ab, counts = cls_loss_ab.main(["--data-root", root, "--steps", str(ROOFLINE_AB_STEPS),
                                       "--probe-every", "5", "--output", f"{workdir}/ab.json"])
        walls["cls_loss_ab"] = time.perf_counter() - t0
        add(counts)
        probes = [p for rows in ab["arms"].values() for p in rows]
        row = {"phase": "roofline_cls_loss_ab", "arms": ab["arms"], "winner": ab["winner"],
               "card": card}
        print(json.dumps(row), flush=True)
        if len(probes) != 2 * 3 or not all(np.isfinite([p["loss"], p["acc"], p["obj_p"]]).all()
                                           and p["npos"] > 0 for p in probes):
            fail(f"roofline: cls_loss_ab {row}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # 6. The detection path without mHC.
    dev = torch.device("cuda")
    mhc = dict(sk_iters=SK_ITERS, precomputed_constraints=True, use_mhc=False)
    parts = [HybridVisionBackbone(**mhc), FeaturePyramidNetwork(**mhc),
             YOLODetectionHead(OUT_CHANNELS, 80, **mhc)]
    zero_counts()
    for m in parts:
        init_weights(m, 1)
        m.to(dev).eval()
        load_constraints(m, compute_constraints(param_tree(m), SK_ITERS))
    torch.cuda.synchronize()
    at_load = kernel_counts()
    images = torch.rand((SERVE_BATCH, IMAGE, IMAGE, 3), device=dev)
    with torch.inference_mode():
        out = parts[2](parts[1](parts[0](images)))
    torch.cuda.synchronize()
    after = kernel_counts()
    add(after)
    finite = all(bool(torch.isfinite(out[k].float()).all()) for k in ("boxes", "scores"))
    row = {"phase": "roofline_no_mhc", "params": sum(p.numel() for m in parts
                                                     for p in m.parameters()),
           "mhc_params": sum(p.numel() for m in parts for n, p in m.named_parameters()
                             if "mhc" in n),
           "at_load": at_load, "after_forward": after, "finite": finite, "card": card}
    print(json.dumps(row), flush=True)
    if any(after.values()) or row["mhc_params"] or not finite:
        fail(f"roofline: the detection path without mHC launched a kernel or holds mHC "
             f"parameters: {row}")
    print(json.dumps({"phase": "roofline", "seconds": time.perf_counter() - t_phase,
                      "wall_s": walls, "launches": launches, "card": card}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# The runnable tours (examples/torch_*.py), run as a user runs them

TOURS = {  # name -> the tour's file in examples/
    "quickstart": "torch_quickstart.py",
    "nb_01": "torch_nb_01_data_exploration.py",
    "nb_02": "torch_nb_02_model_analysis.py",
    "nb_03": "torch_nb_03_training_analysis.py",
    "nb_04": "torch_nb_04_inference_demo.py",
    "nb_05": "torch_nb_05_deployment_test.py",
}
TOUR_TIMEOUT_S = 300
TOUR_ENGINES = ("quickstart", "nb_04", "nb_05")  # serve through InferenceEngine: A > 0
TOUR_FLAGSHIP = ("quickstart", "nb_02", "nb_04", "nb_05")  # load the flagship: B > 0
TOUR_DS_ERROR_MAX = 1e-3  # tests/test_torch_tours.py's limit
TOUR_NB01_IMAGES = {"train": 200, "val": 50}
TOUR_NB03_STEPS = 60
TOUR_NB04_BURST, TOUR_NB04_CONCURRENT = 32, 8
TOUR_NB02_SIZE = 320


def _floats(value, where: str = ""):
    """Every float in a JSON value, with its path."""
    if isinstance(value, float):
        yield where, value
    elif isinstance(value, dict):
        for k, v in value.items():
            yield from _floats(v, f"{where}/{k}")
    elif isinstance(value, list):
        for i, v in enumerate(value):
            yield from _floats(v, f"{where}/{i}")


def tour_expectations(device: str = "cuda") -> dict:
    """What the tours must report, computed in this process: the flagship
    config's parameter estimate and output shapes, and the nb_02 model's
    parameters by subsystem, output shapes and count (one warm forward, then
    ``ModelProfiler.cost_analysis`` of the next, as the tour counts it)."""
    from hvs_tpu_torch.config import ModelConfig
    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.utils import ModelProfiler

    mcfg = ModelConfig(device=device)
    model = HybridVisionSystem(device=device, seed=0).eval()
    by_top: dict = {}
    for name, p in model.named_parameters():
        by_top[name.split(".")[0]] = by_top.get(name.split(".")[0], 0) + p.numel()
    images = torch.zeros((1, TOUR_NB02_SIZE, TOUR_NB02_SIZE, 3), device=device)

    def forward(x):
        with torch.no_grad():
            return model(x)

    out = forward(images)
    shapes = {f"raw/{k}": list(v.shape) for k, v in out["detection"]["raw"].items()}
    shapes["boxes"] = list(out["detection"]["boxes"].shape)
    shapes["features"] = list(out["features"].shape)
    count = ModelProfiler(forward, images).cost_analysis()
    return {"params_estimate": mcfg.estimate_parameters(),
            "output_shapes": {k: list(v) for k, v in mcfg.output_shapes().items()},
            "params_by_subsystem": by_top, "nb02_output_shapes": shapes, "count": count}


def tour_checks(name: str, s: dict, launches: dict, want: dict) -> list:
    """The limits of ``tests/test_torch_tours.py`` on one tour's summary at
    its full size on the card; returns what failed."""
    from hvs_tpu_torch.data import SHAPE_CLASSES, COCODataset

    bad = []
    if s.get("tour") != name or not str(s.get("device", "")).startswith("cuda"):
        bad.append(f"tour {s.get('tour')} on {s.get('device')}")
    bad += [f"{where} = {v}" for where, v in _floats(s) if not math.isfinite(v)]
    if "ds_error_max" in s and not 0.0 <= s["ds_error_max"] <= TOUR_DS_ERROR_MAX:
        bad.append(f"ds_error_max {s['ds_error_max']}")
    if name in TOUR_ENGINES and launches["mhc_block"] <= 0:
        bad.append("kernel A never launched")
    if name in TOUR_FLAGSHIP and launches["sinkhorn_forward"] <= 0:
        bad.append("kernel B never launched")
    if name == "quickstart":
        if s["params_estimate"] != want["params_estimate"] \
                or s["output_shapes"] != want["output_shapes"]:
            bad.append("the config's estimate or output shapes")
        if len(s["losses"]) != 3 or s["image_size"] != IMAGE or not os.path.exists(s["annotated"]):
            bad.append("the three steps, the 640² engine or the annotated image")
    elif name == "nb_01":
        root = s["root"]
        counts = {split: len(COCODataset(root=os.path.join(root, split), annotation_file=ann,
                                         image_size=256))
                  for split, ann in s["annotations"].items()}
        ds = COCODataset(root=os.path.join(root, "train"),
                         annotation_file=s["annotations"]["train"], image_size=256, max_boxes=16)
        hist = {ds.class_names[c]: n for c, n in sorted(ds.class_distribution().items())}
        if s["images"] != counts or counts != TOUR_NB01_IMAGES \
                or s["class_names"] != list(SHAPE_CLASSES) or s["class_histogram"] != hist \
                or s["sample0_boxes"] != int(np.asarray(ds[0]["box_mask"]).sum()):
            bad.append("the dataset's counts, classes, histogram or sample 0")
    elif name == "nb_02":
        count = want["count"]
        if s["params_by_subsystem"] != want["params_by_subsystem"] \
                or s["output_shapes"] != want["nb02_output_shapes"]:
            bad.append("parameters by subsystem or output shapes")
        if (s["flops"], s["transcendentals"], s["bytes_accessed"]) != \
                (count["flops"], count["transcendentals"], count["bytes accessed"]):
            bad.append(f"the count {s['flops']}, {s['transcendentals']}, {s['bytes_accessed']} "
                       f"against this process's {count}")
        if s["num_layers"] <= 0 or s["ds_error_64"] > TOUR_DS_ERROR_MAX:
            bad.append("the monitored layers or the 64x64 projection")
    elif name == "nb_03":
        if s["records"] != TOUR_NB03_STEPS or not s["all_finite"] \
                or s["round_trip_bitwise"] is not True or s["moved_by_step"] <= 0:
            bad.append("the step records or the checkpoint round trip")
    elif name == "nb_04":
        if s["concurrent_served"] != TOUR_NB04_CONCURRENT or s["burst"] != TOUR_NB04_BURST \
                or s["served"] + s["rejected"] != TOUR_NB04_BURST or s["served"] <= 0:
            bad.append("the batcher's requests or the burst")
    elif name == "nb_05":
        if not s["endpoints"] or any(code != 200 for code in s["endpoints"].values()) \
                or s["health"] != "healthy":
            bad.append(f"endpoints {s['endpoints']}, health {s['health']}")
        if s["export"]["consistent"] is not True:  # rtol 1e-3, atol 1e-4
            bad.append(f"the export {s['export']}")
        if s["gate"] != {"good": True, "bad": False} or s["repository"] != {
                "v1_admitted": True, "v2_admitted": False, "latest_admitted": 1}:
            bad.append(f"the gate {s['gate']} or the repository {s['repository']}")
    return bad


def phase_tours(card: str) -> dict:
    """The port's six runnable tours (``examples/torch_*.py``) at their
    default, full-width sizes on the card, each a process of its own started
    from a temp directory with the checkout on ``PYTHONPATH`` (as a user
    runs them), all six at once: a tour is mostly host work and process
    start, which the card's host runs side by side. Fails on an exit other
    than 0, a run past ``TOUR_TIMEOUT_S``, or a summary outside the limits of
    ``tests/test_torch_tours.py`` (``tour_checks``); nb_02's count must equal
    the count of the same forward in this process. Kernel A must launch in
    the tours that serve through ``InferenceEngine``, B in those that load
    the flagship. Returns the kernels' launches summed over the tours, as
    each process's counters saw them (captures and eager calls; a captured
    graph's replays are not counted)."""
    import gc
    import shutil
    import tempfile

    want = tour_expectations()
    # The tours' processes share the card with this one: hand back what
    # this process's allocator holds from the earlier phases.
    gc.collect()
    torch.cuda.empty_cache()
    repo = os.path.dirname(os.path.abspath(__file__))
    workdir = tempfile.mkdtemp(prefix="hvs_tours_smoke_")
    procs, started, walls = {}, {}, {}
    try:
        for name, script in TOURS.items():
            out = os.path.join(workdir, name)
            os.makedirs(out)
            env = dict(os.environ, PYTHONPATH=repo, HVS_NB_OUT=out)
            started[name] = time.perf_counter()
            # Files, not pipes: a tour never waits on a pipe this process is
            # not reading yet.
            with open(f"{out}.stdout", "w") as so, open(f"{out}.stderr", "w") as se:
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.join(repo, "examples", script)], cwd=out,
                    env=env, stdout=so, stderr=se)
        while len(walls) < len(procs):
            for name, proc in procs.items():
                if name not in walls and proc.poll() is not None:
                    walls[name] = time.perf_counter() - started[name]
            late = [TOURS[n] for n in procs
                    if n not in walls and time.perf_counter() - started[n] > TOUR_TIMEOUT_S]
            if late:
                fail(f"tours: {late} ran past {TOUR_TIMEOUT_S} s")
            time.sleep(0.1)
        results = {}
        for name, proc in procs.items():
            out_path = os.path.join(workdir, name)
            with open(f"{out_path}.stdout") as so, open(f"{out_path}.stderr") as se:
                out, err = so.read(), se.read()
            if proc.returncode != 0:
                fail(f"tours: {TOURS[name]} exited {proc.returncode}: {err[-3000:]}")
            reports = [json.loads(line) for line in err.splitlines()
                       if line.startswith("{") and '"kernel_launches"' in line]
            if not reports or not out.strip():
                fail(f"tours: {TOURS[name]} printed no summary or no kernel_launches line")
            results[name] = (json.loads(out.strip().splitlines()[-1]),
                             reports[-1]["kernel_launches"])
        launches = {k: 0 for k in kernel_counts()}
        for name, (summary, counted) in results.items():
            bad = tour_checks(name, summary, counted, want)
            print(json.dumps({"phase": "tours", "tour": name, "wall_s": walls[name],
                              "launches": counted, "summary": summary, "card": card}),
                  flush=True)
            if bad:
                fail(f"tours: {TOURS[name]} outside its limits: {bad}")
            for k in launches:
                launches[k] += counted[k]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"phase": "tours_total", "wall_s": walls, "launches": launches,
                      "nb02_count": want["count"], "card": card}), flush=True)
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
    per_shape = timed(phase_kernels, card)
    sink_rows, sink_mix = timed(phase_sinkhorn, card, sm_clock_hz)
    unfolded_rows = timed(phase_unfolded, card)
    serve_launches = entry_point_phase(phase_serve, defaults, card)
    entry_point_phase(phase_parity, defaults, card)
    entry_point_phase(phase_engine, defaults, card)
    deployment = entry_point_phase(phase_deployment, defaults, card)
    bundle = entry_point_phase(phase_bundle, defaults, card)
    infer = entry_point_phase(phase_infer, defaults, card)
    train_launches = entry_point_phase(phase_train, defaults, card)
    chunked_launches = entry_point_phase(phase_train_chunked, defaults, card)
    entry_point_phase(phase_train_parity, defaults, card)
    trajectory_launches = entry_point_phase(phase_train_trajectory, defaults, card)
    ddp_launches = entry_point_phase(phase_ddp, defaults, card)
    tp_launches = entry_point_phase(phase_tp, defaults, card)
    multitask_launches = entry_point_phase(phase_multitask, defaults, card)
    light = entry_point_phase(phase_lightweight, defaults, card, sm_clock_hz)
    import shutil
    import tempfile

    data_dir = tempfile.mkdtemp(prefix="hvs_data_smoke_")
    try:
        data = entry_point_phase(phase_data, defaults, card, data_dir)
        # Its entry points run in processes of their own, each starting from
        # torch's own flags: this process's flags say nothing of them.
        set_flags(defaults)
        bench = timed(phase_bench, card, data_dir)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    roofline = entry_point_phase(phase_roofline, defaults, card)
    int8 = entry_point_phase(phase_int8, defaults, card)
    rag = entry_point_phase(phase_rag, defaults, card)
    set_flags(defaults)
    manifold_attention = timed(phase_manifold_attention, card)
    # Each tour runs in a process of its own, starting from torch's own flags.
    set_flags(defaults)
    tours = timed(phase_tours, card)

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
    kernels[0]["launches_int8"] = int8["mhc_block"]
    for k in kernels:
        k["launches_rag"] = rag[k["name"]]
        k["launches_infer"] = infer.get(k["name"], 0)
        k["launches_trajectory"] = trajectory_launches[k["name"]]
        k["launches_ddp"] = ddp_launches[k["name"]]
        k["launches_tp"] = tp_launches[k["name"]]
        k["launches_manifold_attention"] = manifold_attention[k["name"]]
        k["launches_bundle"] = bundle[k["name"]]
        k["launches_bench"] = bench[k["name"]]
        k["launches_roofline"] = roofline[k["name"]]
        k["launches_tours"] = tours[k["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
