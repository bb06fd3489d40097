"""Where the time of the port's 640² serve path goes, on one CUDA card.

    python3 scripts/torch_serve_profile.py [--batch 16] [--iters 3] [--trace out.json]

Builds the full-width flagship (seeded random weights, bf16), serves it with
``hvs_tpu_torch.inference.Detector``, and runs ``torch.profiler`` over
``--iters`` forwards after a warm-up. Prints JSON lines: wall time per
forward, summed device time per forward, the device's idle share, device time
by kernel category, and the top kernels by device time, each beside the card's
name and power limit. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

IMAGE = 640
CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("mhc_block (kernel A)", ("mhc_block_kernel",)),
    ("convolution", ("conv", "xmma", "implicit", "cudnn", "winograd", "fprop")),
    ("matmul", ("gemm", "cutlass", "cublas", "matmul", "splitk")),
    ("reduction", ("reduce", "norm", "mean", "sum")),
    ("sort / top-k", ("sort", "radix", "topk")),
    ("copy / layout", ("copy", "memcpy", "memset", "cat", "pad", "index", "gather")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        raise SystemExit(1)

    from hvs_tpu_torch.inference import Detector
    from hvs_tpu_torch.models import ProductionHybridVision

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    det = Detector(ProductionHybridVision(seed=0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand((args.batch, IMAGE, IMAGE, 3), generator=gen, device="cuda")
    for _ in range(3):
        det(images)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            det(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.iters * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_name = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        dev_us = getattr(ev, "device_time", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us:
            by_name[ev.name][0] += dev_us
            by_name[ev.name][1] += 1
    device_ms = sum(v[0] for v in by_name.values()) / 1e3 / args.iters
    cats = defaultdict(float)
    for name, (us, _) in by_name.items():
        cats[category(name)] += us / 1e3 / args.iters
    print(json.dumps({"batch": args.batch, "image": IMAGE, "wall_ms_per_forward": wall_ms,
                      "device_ms_per_forward": device_ms,
                      "idle_share": (1.0 - device_ms / wall_ms) if wall_ms else None,
                      "kernels_per_forward": sum(v[1] for v in by_name.values()) / args.iters,
                      "card": card}))
    print(json.dumps({"device_ms_by_category": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
                      "card": card}))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    for name, (us, count) in top:
        print(json.dumps({"kernel": name[:120], "ms_per_forward": us / 1e3 / args.iters,
                          "launches_per_forward": count / args.iters}))


if __name__ == "__main__":
    main()
