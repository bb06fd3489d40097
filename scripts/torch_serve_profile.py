"""Where the time of the port's 640² serve path goes, on one CUDA card.

    python3 scripts/torch_serve_profile.py [--batch 16] [--iters 3] [--trace out.json]
        [--model flagship|lightweight] [--int8 int8|int8_fpn|int8_mhc|int8_vit|int8_all]

Builds the full-width flagship, or ``LightweightHybridVision`` with the
serving flags (seeded random weights, bf16), or with ``--int8`` the
flagship's int8 twin (that variant's flags; scales calibrated on two seeded
batches of 8 by its float twin), serves it with
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
    ("mhc_block (kernel A or C)", ("mhc_block_kernel",)),
    ("int8 matmul (_int_mm)", ("s8s8", "i8i8", "imma", "_s8_", "int8")),
    ("sinkhorn forward (kernel B)", ("sinkhorn_forward_cluster", "sinkhorn_forward_streamed")),
    ("sinkhorn backward (kernel B)", ("sinkhorn_backward_cluster", "sinkhorn_backward_streamed")),
    ("group_norm (gn_stats, gn_apply)", ("gn_stats_kernel", "gn_apply_kernel")),
    ("convolution", ("conv", "xmma", "implicit", "cudnn", "winograd", "fprop")),
    ("matmul", ("gemm", "cutlass", "cublas", "matmul", "splitk")),
    ("reduction", ("reduce", "norm", "mean", "sum")),
    ("sort / top-k", ("sort", "radix", "topk")),
    ("copy / layout", ("copy", "memcpy", "memset", "cat", "pad", "index", "gather")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


# The int8 variants' flags beside act_quant (models/hybrid.py).
INT8_FLAGS = {"int8": {}, "int8_fpn": {"act_quant_fpn": True},
              "int8_mhc": {"act_quant_mhc": True}, "int8_vit": {"act_quant_vit": True},
              "int8_all": {"act_quant_fpn": True, "act_quant_mhc": True, "act_quant_vit": True}}


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
    ap.add_argument("--model", default="flagship", choices=["flagship", "lightweight"])
    ap.add_argument("--int8", default=None, choices=sorted(INT8_FLAGS),
                    help="the flagship's int8 twin with this variant's flags")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        raise SystemExit(1)

    from hvs_tpu_torch.inference import Detector
    from hvs_tpu_torch.models import LightweightHybridVision, ProductionHybridVision

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.rand((args.batch, IMAGE, IMAGE, 3), generator=gen, device="cuda")
    if args.int8:
        from hvs_tpu_torch.models.quantize import calibrate_quant_scales, load_quant_scales

        calib = Detector(ProductionHybridVision(seed=0))
        scales = calibrate_quant_scales(calib.model, [
            torch.rand((8, IMAGE, IMAGE, 3), generator=gen, device="cuda") for _ in range(2)])
        del calib
        det = Detector(ProductionHybridVision(seed=0, act_quant=True, **INT8_FLAGS[args.int8]))
        load_quant_scales(det.model, scales)
    else:
        det = Detector(ProductionHybridVision(seed=0) if args.model == "flagship" else
                       LightweightHybridVision(precomputed_constraints=True, dropout_rate=0.0,
                                               seed=0))
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

    summarize(prof, args.iters, wall_ms, card,
              {"model": args.int8 or args.model, "batch": args.batch, "image": IMAGE}, "forward")


def summarize(prof, iters: int, wall_ms: float, card: str, head: dict, unit: str) -> None:
    """Prints the profile of ``iters`` repetitions of one ``unit`` (a forward,
    a train step): wall and summed device ms per unit, the idle share, device
    ms by category and the top 20 kernels."""
    by_name = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        dev_us = getattr(ev, "device_time", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us:
            by_name[ev.name][0] += dev_us
            by_name[ev.name][1] += 1
    device_ms = sum(v[0] for v in by_name.values()) / 1e3 / iters
    cats = defaultdict(float)
    for name, (us, _) in by_name.items():
        cats[category(name)] += us / 1e3 / iters
    print(json.dumps({**head, f"wall_ms_per_{unit}": wall_ms,
                      f"device_ms_per_{unit}": device_ms,
                      "idle_share": (1.0 - device_ms / wall_ms) if wall_ms else None,
                      f"kernels_per_{unit}": sum(v[1] for v in by_name.values()) / iters,
                      "card": card}))
    print(json.dumps({**head, "device_ms_by_category":
                      dict(sorted(cats.items(), key=lambda kv: -kv[1])), "card": card}))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    for name, (us, count) in top:
        print(json.dumps({"kernel": name[:120], f"ms_per_{unit}": us / 1e3 / iters,
                          f"launches_per_{unit}": count / iters}))

if __name__ == "__main__":
    main()
