"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. device: the card's name and power limit (nvidia-smi), and the build of
     every kernel from the sources in the checkout (one nvcc per source, all
     started together);
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the token counts of the 640² serve path (batch 1 and 16) and at a ragged
     count, with times (CUDA events) beside the least time the card could take;
  3. serve: the full-width flagship ``ProductionHybridVision`` (seeded random
     weights, bf16) served by ``Detector`` at 640², batch 16 and batch 1; the
     launch counters are zeroed just before and read just after;
  4. parity: the same weights with a well-conditioned H_res, one 320² image,
     the port on the card (kernels) against the port on the CPU (plain
     versions).
The last line is ``{"ok": true, "device": {...}}``; the line before it lists
every kernel of the port with its measurements.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

import hvs_tpu_torch
from hvs_tpu_torch import build
from hvs_tpu_torch.ops import mhc_block as mhc_mod
from hvs_tpu_torch.ops.sinkhorn import sinkhorn_log

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
IMAGE = 640
SERVE_BATCH = 16

# Kernel-vs-plain criteria (as in tests/test_pallas.py): the two compute the
# same roundings; they differ only where fp32 accumulation order flips a bf16
# rounding, and the final LayerNorm can amplify such a flip.
KERNEL_MIN_CORR = 0.999
KERNEL_MAX_MEAN_ABS = 0.05

# End-to-end CUDA-vs-CPU criteria: both run bf16 through ~60 layers; cuDNN
# and the CPU's convolutions sum in different orders, so bf16 roundings flip
# and propagate. Statistical agreement on the raw head outputs, as for the
# kernel. A class score is sigmoid(obj)*sigmoid(cls), whose slope is at most
# 0.25 per logit, so logits that differ by a few bf16 ulps of their magnitude
# (~4: ulp 2^-6) move it by up to ~0.01; 0.02 allows two such logits.
E2E_MIN_CORR = 0.999
E2E_MAX_MEAN_ABS = 0.05
E2E_SCORE_ATOL = 0.02


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


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


def phase_kernels(card: str):
    """Kernel A against its plain version at every main-path shape."""
    shapes = sorted(set(mhc_sites(1)) | set(mhc_sites(SERVE_BATCH))
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
        row = {"phase": "kernel", "kernel": "mhc_block", "n": n, "d": d, "corr": corr,
               "mean_abs_err": mean_abs, "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
               "library_ms": None, "card": card}
        print(json.dumps(row), flush=True)
        if not (corr > KERNEL_MIN_CORR and mean_abs < KERNEL_MAX_MEAN_ABS):
            fail(f"mhc_block n={n} d={d} disagrees with its plain version: "
                 f"corr {corr} (need > {KERNEL_MIN_CORR}), mean |diff| {mean_abs} "
                 f"(need < {KERNEL_MAX_MEAN_ABS})")
        per_shape[(n, d)] = row
    return per_shape


def kernel_summary(per_shape, launches: int):
    """Kernel A over the 18 launches of one batch-16 forward, from phase 2."""
    sites = mhc_sites(SERVE_BATCH)
    t_ops = sum(8.0 * n * d * d / PEAK_BF16_FLOPS * 1e3 for n, d in sites)
    t_bytes = sum((4.0 * n * d + 8.0 * d * d + 24.0 * d) / PEAK_BYTES * 1e3 for n, d in sites)
    return {
        "name": "mhc_block",
        "route": "cuda",
        "source": "hvs_tpu_torch/csrc/mhc_block.cu",
        "replaces": "hvs_tpu/ops/pallas/mhc_pallas.py:208",
        "launches": launches,
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


def phase_serve(card: str) -> int:
    """The flagship served at 640², batch 16 and batch 1. Returns the kernel
    launches counted over this phase's forwards (18 per forward)."""
    from hvs_tpu_torch.inference import Detector
    from hvs_tpu_torch.models import ProductionHybridVision

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    det = Detector(ProductionHybridVision(seed=0))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch16 = torch.rand((SERVE_BATCH, IMAGE, IMAGE, 3), generator=gen, device="cuda")
    batch1 = batch16[:1].contiguous()
    iters16, iters1 = 20, 50

    mhc_mod.launches = 0
    forwards = 0
    for images in (batch16, batch1):
        boxes, scores, classes = det(images)
        torch.cuda.synchronize()
        forwards += 1
        b = images.shape[0]
        if (tuple(boxes.shape), tuple(scores.shape), tuple(classes.shape)) != \
                ((b, 100, 4), (b, 100), (b, 100)):
            fail(f"serve output shapes {boxes.shape}, {scores.shape}, {classes.shape}")
        if classes.dtype != torch.int32 or not (torch.isfinite(boxes).all()
                                                and torch.isfinite(scores).all()):
            fail("serve outputs are not finite or classes are not int32")
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
    if launches != 18 * forwards:
        fail(f"mhc_block launched {launches} times over {forwards} forwards, expected 18 each")
    print(json.dumps({"phase": "serve", "image": IMAGE, "fps_batch16": fps,
                      "batch1_frame_ms": frame_ms, "forwards": forwards,
                      "mhc_block_launches": launches, "load_s": load_s,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "card": card}), flush=True)
    return launches


def phase_parity(card: str) -> None:
    """Port on the card (kernels) against the port on the CPU (plain
    versions), same weights, one 320² image, bf16 on both."""
    import copy

    from hvs_tpu_torch.inference import Detector
    from hvs_tpu_torch.models import ProductionHybridVision
    from hvs_tpu_torch.models.layers import ManifoldHyperConnection

    model = ProductionHybridVision(seed=1)
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
    print(json.dumps({"phase": "parity", "image": 320, "raw_corr": corr,
                      "raw_mean_abs_err": mean_abs, "raw_max_abs_err": float(np.max(np.abs(a - b))),
                      "raw_abs_mean": float(np.mean(np.abs(raw_c.numpy()))),
                      "class_scores_corr": score_corr, "class_scores_max_abs_err": score_diff,
                      "class_scores_max": float(sc.max()), "card": card}), flush=True)
    if not (finite and corr > E2E_MIN_CORR and mean_abs < E2E_MAX_MEAN_ABS
            and score_diff < E2E_SCORE_ATOL):
        fail(f"CUDA and CPU serve outputs disagree: raw corr {corr} (need > {E2E_MIN_CORR}), "
             f"mean |diff| {mean_abs} (need < {E2E_MAX_MEAN_ABS}); class_scores max |diff| "
             f"{score_diff} (need < {E2E_SCORE_ATOL})")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke run needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(json.dumps({"phase": "device", "card": card, "kind": kind,
                      "count": torch.cuda.device_count(), "torch": torch.__version__,
                      "cuda": torch.version.cuda, "port": hvs_tpu_torch.__name__}), flush=True)
    t0 = time.perf_counter()
    build.build(["mhc_block"])
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "per_source_s": build.build_seconds}), flush=True)

    per_shape = phase_kernels(card)
    launches = phase_serve(card)
    phase_parity(card)

    print(card)
    print(json.dumps({"kernels": [kernel_summary(per_shape, launches)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
