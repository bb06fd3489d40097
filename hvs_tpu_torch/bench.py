"""Headline benchmark of the port: frames/s at 640² detection, end to end on the card.

Counterpart of the JAX package's ``bench.py``: the flagship's serve program
(``ProductionHybridVision``, bf16, 20 Sinkhorn iterations, the constrained
mHC matrices computed once at load by ``Detector``: kernel B, one launch per
matrix) followed by on-device decode and class-aware NMS (score 0.25, 100
detections, 512 candidates before NMS), fed normalized 640² images already
on the card. Where JAX compiles the program once with ``jax.jit``, this
module captures it as one CUDA graph per batch after an eager warm-up, and
holds the first replay against an eager call (boxes, scores and classes
equal exactly). Times as ``bench.py``: one warm call, then 30 batch-16
calls and one synchronize (frames/s), then 60 pipelined batch-1 calls and
one synchronize (ms per frame). Prints ONE JSON line with ``bench.py``'s
keys. The baseline is the reference's 35 FPS at 640² on an RTX 3090
(BASELINE.md).

Kernel A runs at every batch. The JAX package keeps batches 1 and 2 off its
fused mHC kernel on the TPU (a batch-aware gate); the port has no such gate,
so the batch-1 latency here includes kernel A at all 18 sites.

Environment variables, as ``bench.py`` reads them:
  * ``HVS_BENCH_BATCH``: the throughput batch (default 16);
  * ``HVS_BENCH_QUANT``: 1-4 serve the int8 model, cumulatively as
    ``bench.py`` maps them: 1 the backbone's residual stream and the head
    towers (``act_quant``), 2 also the FPN (``act_quant_fpn``), 3 also the
    backbone's mHC chains (``act_quant_mhc``), 4 also the ViT
    (``act_quant_vit``); the port's ``quantization.quantize_fpn``,
    ``quantize_mhc`` and ``quantize_vit`` flags and ``chip_smoke.py``'s
    ``int8`` variants are the same switches. Every int8 site reads scale 1
    (identity scales, as JAX takes the ``quant`` collection from init):
    the time does not depend on the scale values;
  * ``HVS_BENCH_CHECKPOINT``: a checkpoint of the port's trainer (``<path>``
    or ``<path>.pt``), its EMA weights when it has them, served with its
    own class count (``bench.py`` serves 80 classes). A checkpoint of
    the JAX package (an orbax directory) is refused: convert it first with
    ``scripts/torch_import_checkpoint.py``. Unset or empty: the seeded
    random init.

Runs on the card. Without CUDA it prints the line with ``"value": 0``,
``"error": "cuda_unavailable"`` and a ``"detail"``, and exits 1; nothing runs
on the CPU unless ``--device cpu`` asks for it. On stderr, one JSON line
gives the kernel launches (``kernel_launches``)::

    python -m hvs_tpu_torch.bench
    HVS_BENCH_QUANT=1 python -m hvs_tpu_torch.bench
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .models import ProductionHybridVision

METRIC = "fps_per_chip_640_detect_e2e"
UNIT = "frames/sec/chip"
BASELINE_FPS = 35.0  # the reference on an RTX 3090 at 640x640 (BASELINE.md)
IMAGE = 640
ITERS = 30  # batch-16 calls timed
ITERS_B1 = 60  # pipelined batch-1 calls timed
WARMUP_CALLS = 3  # eager calls before a capture
SK_ITERS = 20
SCORE_THRESHOLD, MAX_DETECTIONS, PRE_NMS_TOP_K = 0.25, 100, 512


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Headline serve benchmark (PyTorch/CUDA port)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def quant_flags(mode: int) -> Dict[str, bool]:
    """``HVS_BENCH_QUANT``'s int8 flags, cumulative as in ``bench.py``."""
    return {"act_quant": mode >= 1, "act_quant_fpn": mode >= 2,
            "act_quant_mhc": mode >= 3, "act_quant_vit": mode >= 4}


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The EMA weights (else the weights) of a checkpoint of the port's
    trainer, as {parameter name: tensor}, read by the engine's loader once
    a directory (a JAX checkpoint) is refused."""
    from .inference.engine import checkpoint_params

    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: a checkpoint of the JAX package (orbax). Convert it "
            "with scripts/torch_import_checkpoint.py and pass the .pt file it writes")
    return checkpoint_params(path)


def checkpoint_classes(weights: Dict[str, torch.Tensor]) -> int:
    """The class count of the port's named weights, from the detection
    head's prediction conv: out channels = 3 anchors x (5 + C)."""
    for name, leaf in weights.items():
        if "detection_head" in name and "predict" in name and name.endswith("kernel"):
            out_ch = leaf.shape[0]  # OIHW
            if out_ch % 3 or out_ch // 3 <= 5:
                raise ValueError(f"{name}: {out_ch} out channels are not 3 x (5 + C)")
            return out_ch // 3 - 5
    raise ValueError("no detection-head prediction kernel in the weights")


def build_detector(quant_mode: int, checkpoint: str, device):
    """The flagship served by ``Detector`` with ``bench.py``'s settings (the
    checkpoint's class count when one is given, else 80)."""
    from .inference import Detector
    from .models.quantize import load_quant_scales, quant_site_names

    weights = read_checkpoint(checkpoint) if checkpoint else None
    classes = checkpoint_classes(weights) if weights is not None else 80
    model = ProductionHybridVision(sk_iters=SK_ITERS, device=device, seed=0,
                                   num_classes=classes, **quant_flags(quant_mode))
    if weights is not None:
        named = dict(model.named_parameters())
        if set(weights) != set(named):
            raise KeyError(f"{checkpoint} does not match the flagship: missing "
                           f"{sorted(set(named) - set(weights))[:8]}, unexpected "
                           f"{sorted(set(weights) - set(named))[:8]}")
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(weights[name].to(p.dtype))
    det = Detector(model, device=device)  # the constraints: kernel B at load
    if quant_mode:
        load_quant_scales(det.model, {s: 1.0 for s in quant_site_names(det.model)})
    return det


def serve_fn(det) -> Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """``bench.py``'s ``serve``: forward, decode and NMS; (boxes, scores, classes)."""
    from .models.hybrid import detect

    @torch.inference_mode()
    def serve(images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        out, _ = detect(det.model, images, SCORE_THRESHOLD, det.iou_threshold,
                        MAX_DETECTIONS, PRE_NMS_TOP_K)
        return out.boxes, out.scores, out.classes

    return serve


class CapturedServe:
    """``serve`` on a fixed input, captured once as a CUDA graph after
    ``WARMUP_CALLS`` eager calls on a side stream; on the CPU, eager.
    Calling it replays the graph (or calls ``serve``) and returns the
    outputs, which the next call overwrites."""

    def __init__(self, serve: Callable, images: torch.Tensor):
        self.serve = serve
        self.images = images
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.eager_calls = 0
        self.replays = 0
        self.eager_out: Optional[Tuple[torch.Tensor, ...]] = None
        if images.device.type != "cuda":
            return
        side = torch.cuda.Stream(images.device)
        side.wait_stream(torch.cuda.current_stream(images.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                serve(images)
                self.eager_calls += 1
        torch.cuda.current_stream(images.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = serve(images)

    def __call__(self) -> Tuple[torch.Tensor, ...]:
        if self.graph is None:
            self.eager_calls += 1
            return self.serve(self.images)
        self.graph.replay()
        self.replays += 1
        return self.out

    def replay_equals_eager(self) -> bool:
        """One replay against one eager call on the same input: every
        output equal exactly."""
        got = [t.clone() for t in self()]
        want = self.eager_out = self.serve(self.images)
        self.eager_calls += 1
        return all(torch.equal(g, w) for g, w in zip(got, want))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device, quant_mode: int = 0, checkpoint: str = "", batch: int = 16
        ) -> Tuple[Dict, Dict]:
    """Build, capture, check and time. Returns the JSON line (as a dict) and
    the kernel launches: A per forward times every eager call and replay,
    B at load."""
    from .device import resolve_device
    from .ops import mhc_block as mhc_mod
    from .ops import sinkhorn as sink_mod
    from .training.chunk import kernel_counts

    device = resolve_device(device)
    mhc_mod.launches = mhc_mod.launches_unfolded = 0
    sink_mod.launches_forward = sink_mod.launches_backward = 0
    det = build_detector(quant_mode, checkpoint, device)
    _sync(device)
    at_load = kernel_counts()
    serve = serve_fn(det)
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.rand((batch, IMAGE, IMAGE, 3), generator=gen, device=device)

    # One eager forward: kernel A's launches per forward.
    a0 = mhc_mod.launches
    serve(images)
    _sync(device)
    a_per_forward = mhc_mod.launches - a0
    eager = 1

    graph = CapturedServe(serve, images)
    equal = graph.replay_equals_eager()
    graph()  # the warm call
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        graph()
    _sync(device)
    fps = batch * ITERS / (time.perf_counter() - t0)

    one = CapturedServe(serve, images[:1].contiguous())
    equal &= one.replay_equals_eager()
    one()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(ITERS_B1):
        one()
    _sync(device)
    frame_ms = (time.perf_counter() - t0) / ITERS_B1 * 1e3
    if not equal:
        raise RuntimeError("a CUDA graph replay of the serve program differs from its eager call")

    row = {
        "metric": METRIC,
        "value": round(fps, 2),
        "unit": UNIT,
        "vs_baseline": round(fps / BASELINE_FPS, 2),
        "batch1_frame_ms": round(frame_ms, 2),
    }
    if checkpoint:
        row["checkpoint"] = checkpoint
    if batch != 16:
        row["batch"] = batch
    eager += graph.eager_calls + one.eager_calls
    replays = graph.replays + one.replays
    graphs = sum(g.graph is not None for g in (graph, one))
    launches = {
        "kernel_launches": {"mhc_block": a_per_forward * (eager + replays),
                            "sinkhorn_forward": at_load["sinkhorn_forward"],
                            "sinkhorn_backward": 0, "mhc_block_unfolded": 0},
        "mhc_block_per_forward": a_per_forward,
        # A's counter over the run: each eager forward and each capture.
        "mhc_block_counted": mhc_mod.launches,
        "sinkhorn_at_load": at_load["sinkhorn_forward"],
        "eager_forwards": eager, "graphs": graphs, "replays": replays,
        "replay_equals_eager": bool(equal),
        "detections_compared": int((graph.eager_out[1] >= 0).sum())}
    return row, launches


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    if (args.device is None or torch.device(args.device).type == "cuda") \
            and not torch.cuda.is_available():
        # bench.py's tpu_unavailable line, for the card.
        print(json.dumps({"metric": METRIC, "value": 0, "unit": UNIT, "vs_baseline": 0,
                          "error": "cuda_unavailable",
                          "detail": "torch.cuda.is_available() is false; pass --device cpu "
                                    "to run on the CPU"}))
        raise SystemExit(1)
    quant_mode = int(os.environ.get("HVS_BENCH_QUANT", "0") or 0)
    batch = int(os.environ.get("HVS_BENCH_BATCH", "16") or 16)
    checkpoint = os.environ.get("HVS_BENCH_CHECKPOINT") or ""
    row, launches = run(args.device, quant_mode, checkpoint, batch)
    print(json.dumps(launches), file=sys.stderr, flush=True)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
