#!/usr/bin/env python
"""Host cost of kernel A's registered operator (``hvs::mhc_block``) on the card.

Kernel A is launched through ``torch.library.custom_op`` so that
``torch.export`` can record it; before, the wrapper called the kernel's C
entry point through ``ctypes`` directly. This script times both routes in
one process, interleaved:

  * per call, at a small shape where the host sets the pace (N = 64 rows,
    d = 32) and at the flagship's largest b1 site (N = 25600, d = 32):
    host µs per call over many calls, one synchronize at the end;
  * the eager ``Detector`` forward of the flagship at 640², batch 1 and 16
    (ms per forward, host clock), with every fused site going through the
    operator or, patched in, through the direct launch.

    python3 scripts/torch_mhc_op_overhead.py [--trials 5]

Prints one JSON line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hvs_tpu_torch.models import layers  # noqa: E402
from hvs_tpu_torch.ops import mhc_block as mhc_mod  # noqa: E402


def direct(x, *args):
    """The route before the operator: the C entry point through ctypes."""
    out = mhc_mod._launch("hvs_mhc_block", x, mhc_mod.SERVE_OPERANDS, args)
    mhc_mod.launches += 1
    return out


def inputs(n, d, seed=0):
    r = np.random.default_rng(seed)
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dtype)

    x = t(r.standard_normal((n, d)), bf)
    mats = [t(r.standard_normal((d, d)) / np.sqrt(d), bf) for _ in range(4)]
    vecs = [t(0.01 * r.standard_normal(d)) for _ in range(2)]
    ln = [t(np.ones(d)), t(np.zeros(d)), t(np.ones(d)), t(np.zeros(d))]
    return x, [mats[0], vecs[0], mats[1], vecs[1], mats[2], mats[3]] + ln


def host_us_per_call(fn, x, args, calls):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(x, *args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def forward_ms(det, images, reps):
    det(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        det(images)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trials", type=int, default=5)
    args = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    routes = {"operator": mhc_mod.mhc_block, "direct": direct}
    for n, d, calls in ((64, 32, 2000), (25600, 32, 500)):
        x, a = inputs(n, d)
        for fn in routes.values():
            host_us_per_call(fn, x, a, 50)
        times = {name: [] for name in routes}
        for _ in range(args.trials):
            for name, fn in routes.items():
                times[name].append(host_us_per_call(fn, x, a, calls))
        print(json.dumps({"measure": "host_us_per_call", "n": n, "d": d, "calls": calls,
                          **{name: float(np.median(v)) for name, v in times.items()},
                          "trials": times, "card": card}), flush=True)

    from hvs_tpu_torch.inference import Detector
    from hvs_tpu_torch.models import ProductionHybridVision

    det = Detector(ProductionHybridVision(seed=0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch16 = torch.rand((16, 640, 640, 3), generator=gen, device="cuda")
    batch1 = batch16[:1].contiguous()
    for batch, images, reps in ((1, batch1, 30), (16, batch16, 10)):
        times = {name: [] for name in routes}
        for _ in range(args.trials):
            for name, fn in routes.items():
                layers.mhc_block = fn
                times[name].append(forward_ms(det, images, reps))
        layers.mhc_block = mhc_mod.mhc_block
        print(json.dumps({"measure": "detector_ms_per_forward", "batch": batch, "reps": reps,
                          **{name: float(np.median(v)) for name, v in times.items()},
                          "trials": times, "card": card}), flush=True)
    print(card)


if __name__ == "__main__":
    main()
