"""Ceiling of what fusing the detection head's norms can save, on the card.

Counterpart of ``scripts/head_fusion_ceiling.py``. The full serve program
(``roofline``'s: the flagship served by ``Detector``, forward, decode and
NMS) at batch 16, 640², against the same program with only the detection
head's ``GroupNorm`` modules replaced by ``nn.Identity``
(``utils/perf.py::identity_norms`` on ``model.detection_head``; the
backbone's and the FPN's norms stay), each captured as one CUDA graph and
timed by replay (``utils/perf.py``), with its bytes counted
(``ModelProfiler.cost_analysis``). ``delta_ms``, ``delta_fps`` and
``delta_bytes_frac`` bound what any fusion of the head's norms can save.

Keys as the JAX script's, ``xla_bytes`` renamed ``bytes_accessed`` (the
table in ``utils/perf.py``). Runs on the card unless ``--device cpu``;
raises without one::

    python -m hvs_tpu_torch.head_fusion_ceiling
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch

from .utils import perf


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Detection-head norm-fusion ceiling "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--image-size", type=int, default=640)
    p.add_argument("--iters", type=int, default=30, help="timed calls per variant")
    p.add_argument("--output", default=f"{perf.OUTPUT_DIR}/head_fusion_ceiling.json")
    perf.add_args(p)
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> Tuple[Dict, Dict[str, int]]:
    from .bench import serve_fn
    from .device import resolve_device
    from .roofline import detector

    device = resolve_device(args.device)
    pk = perf.peaks(args, device)
    launches = perf.Launches()
    b, s = args.batch, args.image_size
    x = torch.rand((b, s, s, 3), generator=torch.Generator(device=device).manual_seed(0),
                   device=device)
    results = {}
    for variant in ("full", "head_gn_identity"):
        det = detector(device, args.tiny)
        if variant == "head_gn_identity":
            perf.identity_norms(det.model.detection_head)
        serve = serve_fn(det)
        counted = perf.cost(lambda: serve(x))
        prog = perf.Program(lambda: serve(x), device)
        ms = prog.seconds(args.iters) * 1e3
        launches.add(prog)
        results[variant] = {"ms_per_batch": ms, "bytes_accessed": counted["bytes accessed"],
                            "flops": counted["flops"]}
        print(variant, results[variant], flush=True)
        del prog, det
    full, abl = results["full"], results["head_gn_identity"]
    report = {
        "batch": b,
        "image_size": s,
        "peaks": pk,
        "full": full,
        "head_gn_identity": abl,
        "delta_ms": full["ms_per_batch"] - abl["ms_per_batch"],
        "delta_fps": b * 1e3 / abl["ms_per_batch"] - b * 1e3 / full["ms_per_batch"],
        "delta_bytes_frac": 1 - abl["bytes_accessed"] / full["bytes_accessed"],
        "note": ("delta = upper bound on what fusing the detection head's norms can reclaim "
                 "from the serve program on this card"),
    }
    print(json.dumps({k: v for k, v in report.items() if k != "peaks"}))
    return report, launches.total()


def main(argv: Optional[Sequence[str]] = None) -> Tuple[Dict, Dict[str, int]]:
    args = parse_args(argv)
    report, launches = run(args)
    perf.write(report, args.output)
    print(json.dumps({"kernel_launches": launches}), file=sys.stderr, flush=True)
    return report, launches


if __name__ == "__main__":
    main()
