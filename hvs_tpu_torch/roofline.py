"""Roofline of the serve path on the card.

Counterpart of ``scripts/roofline.py``. For each batch bucket: the flagship's
serve program (``ProductionHybridVision`` with 20 Sinkhorn iterations served
by ``Detector``: forward, decode, class-aware NMS; ``bench.py``'s program) and
a forward-only program that reduces each head output to a sum (decode and
NMS out of it, as the JAX script's), each captured as one CUDA graph and
timed by replay (``utils/perf.py``). From the serve program's counted flops
and bytes (``ModelProfiler.cost_analysis``) and its time: achieved TFLOP/s
against the card's dense bf16 peak (``mfu``), GB/s against its memory rate
(``hbm_utilization``), the intensity against the ridge, and which bound is
nearer. The decode and NMS tail is the serve time less the forward-only time.

Keys as the JAX script's, renamed by the table in ``utils/perf.py``
(``xla_flops_per_batch`` → ``flops_per_batch``,
``xla_bytes_accessed_per_batch`` → ``bytes_accessed_per_batch``,
``mxu_utilization`` → ``mfu``, bound "compute (MXU)" → "compute (tensor
cores)"); ``transcendentals_per_batch`` is new. The peaks are read by the
card's name. Runs on the card unless ``--device cpu``; raises without one.
One JSON line on stderr gives the kernel launches::

    python -m hvs_tpu_torch.roofline
    python -m hvs_tpu_torch.roofline --device cpu --tiny --image-size 64 --buckets 1,2 \\
        --peak-tflops-bf16 1 --peak-hbm-gbps 50
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_leaves

from .utils import perf


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Roofline of the serve path (PyTorch/CUDA port)")
    p.add_argument("--image-size", type=int, default=640)
    p.add_argument("--buckets", default="8,16,32")
    p.add_argument("--iters", type=int, default=30, help="timed calls per program")
    p.add_argument("--output", default=f"{perf.OUTPUT_DIR}/roofline.json")
    perf.add_args(p)
    return p.parse_args(argv)


def detector(device: torch.device, tiny: bool):
    """The flagship served by ``Detector`` (80 classes, seed 0; kernel B at
    load), as ``bench.py`` serves it."""
    from .inference import Detector
    from .models import ProductionHybridVision

    model = ProductionHybridVision(device=device, seed=0, num_classes=80,
                                   **perf.model_kwargs(tiny))
    return Detector(model, device=device)


def forward_only_fn(det):
    """The forward with each head output reduced to a sum, so that nothing
    large is kept and decode + NMS stay out of the program."""

    @torch.inference_mode()
    def forward_only(images: torch.Tensor):
        return [t.sum() for t in tree_leaves(det.model(images)["detection"])]

    return forward_only


def run(args: argparse.Namespace) -> Tuple[Dict, Dict[str, int]]:
    from .bench import serve_fn
    from .device import resolve_device

    device = resolve_device(args.device)
    pk = perf.peaks(args, device)
    launches = perf.Launches()
    det = detector(device, args.tiny)
    serve, forward_only = serve_fn(det), forward_only_fn(det)
    s = args.image_size
    report = {"image_size": s, "peaks": pk, "buckets": {}}
    gen = torch.Generator(device=device).manual_seed(0)
    for b in (int(x) for x in args.buckets.split(",")):
        images = torch.rand((b, s, s, 3), generator=gen, device=device)
        counted = perf.cost(lambda: serve(images))
        flops, nbytes = counted["flops"], counted["bytes accessed"]
        serve_prog = perf.Program(lambda: serve(images), device)
        t_serve = serve_prog.seconds(args.iters)
        fwd_prog = perf.Program(lambda: forward_only(images), device)
        t_fwd = fwd_prog.seconds(args.iters)
        launches.add(serve_prog)
        launches.add(fwd_prog)
        u = perf.utilization(flops, nbytes, t_serve, pk)
        row = {
            "fps": b / t_serve,
            "batch_ms": t_serve * 1e3,
            "forward_only_ms": t_fwd * 1e3,
            "decode_nms_tail_ms": (t_serve - t_fwd) * 1e3,
            "flops_per_batch": flops,
            "bytes_accessed_per_batch": nbytes,
            "transcendentals_per_batch": counted["transcendentals"],
            "achieved_tflops": u["tflops"],
            "mfu": u["mfu"],
            "achieved_hbm_GBps": u["gbps"],
            "hbm_utilization": u["hbm_utilization"],
            "arithmetic_intensity_flops_per_byte": u["intensity"],
            "ridge_intensity": perf.ridge(pk),
        }
        row["bound"] = (perf.COMPUTE_BOUND if row["mfu"] > row["hbm_utilization"]
                        else perf.HBM_BOUND)
        report["buckets"][b] = row
        print(f"bucket {b}: {row['fps']:.1f} FPS  mfu={row['mfu']:.1%} "
              f"hbm={row['hbm_utilization']:.1%}  tail={row['decode_nms_tail_ms']:.3f}ms "
              f"-> {row['bound']}", flush=True)
        del serve_prog, fwd_prog
    return report, launches.total()


def main(argv: Optional[Sequence[str]] = None) -> Tuple[Dict, Dict[str, int]]:
    args = parse_args(argv)
    report, launches = run(args)
    perf.write(report, args.output)
    print(json.dumps({"kernel_launches": launches}), file=sys.stderr, flush=True)
    print(f"wrote {args.output}")
    return report, launches


if __name__ == "__main__":
    main()
