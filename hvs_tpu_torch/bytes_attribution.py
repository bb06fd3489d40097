"""The serve path's flops and bytes by stage, on the card.

Counterpart of ``scripts/bytes_attribution.py``. At batch 16, 640², the
flagship served as ``roofline`` serves it, split into the port's own
submodules of ``models/hybrid.py`` on the served weights, each stage
captured as one CUDA graph on the previous stage's output and timed by
replay (``utils/perf.py``):

    backbone -> vit_encoder (+ the 0.5 blend into scale_large) -> fpn
    -> detection_head (towers and decode) -> features -> decode_nms

``features`` is the global-feature head (``HybridVisionSystem.
global_features``), which the port's forward runs on every call; the JAX
script has no such stage because XLA drops it from the serve program as
dead code. Per stage: ms, flops, transcendentals, bytes
(``ModelProfiler.cost_analysis``), GB/s and ``bytes_frac``.

The stages call the modules the serve call calls, in its order, so they
launch exactly the kernels of the whole serve call and their counts sum to
its own: the report holds the serve call's flops and bytes beside the sums
(``stage_sums_equal_serve``). Keys as the JAX script's (no key there names
XLA or the MXU), plus the peaks' record and ``serve``. Runs on the card
unless ``--device cpu``; raises without one::

    python -m hvs_tpu_torch.bytes_attribution
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .utils import perf

SCORE_THRESHOLD, MAX_DETECTIONS, PRE_NMS_TOP_K = 0.25, 100, 512


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Serve bytes by stage (PyTorch/CUDA port)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--image-size", type=int, default=640)
    p.add_argument("--iters", type=int, default=20, help="timed calls per stage")
    p.add_argument("--output", default=f"{perf.OUTPUT_DIR}/bytes_attribution.json")
    perf.add_args(p)
    return p.parse_args(argv)


def stages(model) -> Dict[str, Callable]:
    """The serve call's stages, in order, each a function of the previous
    stage's output (the first of the images)."""
    from .models.yolo_head import postprocess_detections

    def vit(scales):
        out = dict(scales)
        enhanced = model.vit_encoder(scales["scale_large"])
        out["scale_large"] = 0.5 * scales["scale_large"] + 0.5 * enhanced
        return out

    def features(det_out):
        fused, head = det_out
        model.global_features(fused)
        return head

    def head(fused):
        return fused, model.detection_head(fused)

    out = {"backbone": model.backbone}
    if model.vit_encoder is not None:
        out["vit_encoder"] = vit
    out.update({
        "fpn": model.fpn,
        "detection_head": head,
        "features": features,
        "decode_nms": lambda d: postprocess_detections(
            d, score_threshold=SCORE_THRESHOLD, max_detections=MAX_DETECTIONS,
            pre_nms_top_k=PRE_NMS_TOP_K),
    })
    return out


def run(args: argparse.Namespace) -> Tuple[Dict, Dict[str, int]]:
    from .bench import serve_fn
    from .device import resolve_device
    from .roofline import detector

    device = resolve_device(args.device)
    pk = perf.peaks(args, device)
    launches = perf.Launches()
    det = detector(device, args.tiny)
    b, s = args.batch, args.image_size
    images = torch.rand((b, s, s, 3), generator=torch.Generator(device=device).manual_seed(0),
                        device=device)
    report = {"batch": b, "image_size": s, "peaks": pk, "stages": {}}
    x = images
    programs = []  # kept alive: each stage's graph reads the one before's output
    with torch.inference_mode():
        for name, fn in stages(det.model).items():
            counted = perf.cost(lambda: fn(x))
            prog = perf.Program(lambda: fn(x), device)
            t = prog.seconds(args.iters)
            launches.add(prog)
            report["stages"][name] = dict(
                ms=t * 1e3, flops=counted["flops"], transcendentals=counted["transcendentals"],
                bytes=counted["bytes accessed"], GBps=counted["bytes accessed"] / t / 1e9)
            print(name, report["stages"][name], flush=True)
            programs.append(prog)
            x = prog.out
        serve = perf.cost(lambda: serve_fn(det)(images))
    total_b = sum(v["bytes"] for v in report["stages"].values())
    for v in report["stages"].values():
        v["bytes_frac"] = v["bytes"] / total_b
    report["total_bytes"] = total_b
    report["serve"] = {"flops": serve["flops"], "bytes": serve["bytes accessed"],
                       "transcendentals": serve["transcendentals"]}
    report["stage_sums_equal_serve"] = (
        sum(v["flops"] for v in report["stages"].values()) == serve["flops"]
        and total_b == serve["bytes accessed"])
    report["note"] = (
        "the stages are the served model's own submodules, called as the serve call calls "
        "them, so they launch exactly its kernels: their flops and bytes sum to the serve "
        "call's (stage_sums_equal_serve); the bytes count every operator's inputs and "
        "outputs unfused, views excluded")
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
