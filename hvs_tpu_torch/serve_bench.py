"""Sustained host-inclusive serving benchmark: JPEG bytes to boxes.

Counterpart of ``scripts/serve_bench.py``, with its flags, defaults, modes
and report keys plus ``--device``. It drives the whole serve path

    JPEG bytes -> cv2 decode -> (optional host letterbox) -> micro-batcher ->
    the engine's captured raw-frame graph (letterbox, normalize, forward,
    decode, NMS on the card) -> boxes on the host

for ``--seconds`` seconds, and reports completed frames/s and the p50, p95
and p99 latency per request:
  * ``closed``: a closed loop at most ``--inflight`` requests deep (at
    least three times the bucket), decoding on the submitting thread;
  * ``rated``: open-loop arrivals at ``--rate`` per second, submitted on
    schedule whether or not earlier requests finished;
  * ``overload``: the same far above capacity; the bounded queue sheds
    (``--policy shed_oldest``) or rejects (``reject``), and shed requests
    count in ``shed_or_rejected``, not as errors.
Admission: ``--queue-depth`` (0: ``--inflight`` plus the bucket in
``closed`` mode, else sized from the measured service time),
``--policy`` and ``--deadline-ms`` go to ``InferenceConfig.performance``.
Buckets are (``--bucket`` / 4, ``--bucket``); the source frame shape is
registered (its raw-frame graphs captured) and each bucket's service time
measured before the run, and the metrics window is reset after a warm-up
through the batcher. ``--checkpoint`` reads a checkpoint of the port's
trainer; without ``--num-classes`` the class count comes from its
detection head (80 without a checkpoint). ``--tiny`` takes the tiny model
at 64² and does not change the device; ``--device cpu`` does. On stderr,
one JSON line gives the graphs' replays, the graphs captured and the
kernel counters (``kernel_launches``)::

    python -m hvs_tpu_torch.serve_bench --seconds 30 --image-size 640 \\
        --jpeg-dir data/shapes/val --output serve_sustained.json
    python -m hvs_tpu_torch.serve_bench --mode overload --rate 2000 --policy shed_oldest
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Sustained JPEG->boxes benchmark (PyTorch/CUDA port)")
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--image-size", type=int, default=640)
    p.add_argument("--jpeg-dir", default="data/shapes/val",
                   help="directory of .jpg frames (synthetic fallback)")
    p.add_argument("--frames", type=int, default=64, help="distinct frames cycled")
    p.add_argument("--inflight", type=int, default=64,
                   help="max in-flight requests (backpressure)")
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of the port's trainer (<path> or <path>.pt)")
    p.add_argument("--num-classes", type=int, default=None,
                   help="default: inferred from the checkpoint's detection head shape "
                        "(80 without a checkpoint)")
    p.add_argument("--output", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--bucket", type=int, default=16, help="max batch bucket")
    p.add_argument("--mode", choices=["closed", "rated", "overload"], default="closed",
                   help="closed: max-throughput closed loop; rated: open-loop arrivals at "
                        "--rate FPS with SLA accounting; overload: arrivals far above "
                        "capacity, where the bounded queue sheds instead of queueing")
    p.add_argument("--rate", type=float, default=30.0,
                   help="open-loop arrival rate (rated/overload modes)")
    p.add_argument("--policy", choices=["reject", "shed_oldest"], default="reject")
    p.add_argument("--queue-depth", type=int, default=0,
                   help="admission-control queue depth (0 = 2x max bucket)")
    p.add_argument("--deadline-ms", type=float, default=8.0,
                   help="micro-batch flush deadline")
    p.add_argument("--host-letterbox", action="store_true",
                   help="letterbox on the host before submit (the frame crossing to the "
                        "card is then image-size² instead of the raw frame)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_jpegs(args: argparse.Namespace) -> List[bytes]:
    """Distinct JPEG byte strings; generated if no directory is available."""
    import cv2

    paths = sorted(glob.glob(os.path.join(args.jpeg_dir, "*.jpg")))[: args.frames]
    if paths:
        blobs = []
        for p in paths:
            with open(p, "rb") as f:
                blobs.append(f.read())
        return blobs
    rng = np.random.default_rng(0)
    blobs = []
    for _ in range(args.frames):
        img = rng.integers(0, 255, (480, 640, 3), np.uint8)
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        blobs.append(enc.tobytes())
    return blobs


def infer_num_classes(checkpoint: str) -> int:
    """The class count of a checkpoint of the port's trainer, from its
    detection head's prediction conv: out channels = 3 anchors x (5 + C)."""
    from .bench import checkpoint_classes, read_checkpoint

    return checkpoint_classes(read_checkpoint(checkpoint))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    # Keep enough requests in flight to form full batches at the big bucket.
    args.inflight = max(args.inflight, args.bucket * 3)

    import cv2

    from .benchmark import launch_report
    from .config import InferenceConfig, ModelConfig
    from .data.dataset import letterbox_cv2
    from .export_model import tiny_configs
    from .inference import EngineOverloaded, InferenceEngine

    if args.num_classes is None:
        args.num_classes = infer_num_classes(args.checkpoint) if args.checkpoint else 80
        print(f"num_classes={args.num_classes} (from checkpoint)" if args.checkpoint
              else "num_classes=80 (default)", file=sys.stderr, flush=True)
    device = args.device or "auto"
    mcfg = ModelConfig(device=device)
    mcfg.detection.num_classes = args.num_classes
    icfg = InferenceConfig(device=device)
    icfg.preprocessing.image_size = args.image_size
    # Two buckets: under sustained closed-loop load the batcher forms full
    # batches; the small one covers the ramp and the tail.
    icfg.performance.batch_buckets = (max(args.bucket // 4, 1), args.bucket)
    icfg.performance.max_queue_delay_ms = args.deadline_ms
    # The closed loop uses semaphore backpressure, not admission control:
    # the queue is sized above the in-flight cap so it never rejects.
    icfg.performance.max_queue_depth = (
        args.queue_depth or (args.inflight + args.bucket if args.mode == "closed" else 0))
    icfg.performance.overload_policy = args.policy
    if args.checkpoint:
        icfg.checkpoint_path = args.checkpoint
    if args.tiny:
        tiny_configs(mcfg, icfg, 64)

    engine = InferenceEngine(mcfg, icfg)
    blobs = load_jpegs(args)

    def decode(blob: bytes) -> np.ndarray:
        img = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
        if args.host_letterbox:
            img = letterbox_cv2(img, icfg.preprocessing.image_size)[0]
        return img

    # The source frame shape goes to the raw path (its graphs captured at
    # every bucket), and each bucket's service time feeds the batcher's
    # latency-sized queue, so no capture lands in the measured window.
    warm = decode(blobs[0])
    engine.register_raw_shape(warm.shape[:2])
    for b in icfg.performance.batch_buckets:
        print(f"warming bucket {b}...", file=sys.stderr, flush=True)
        engine.infer_batch([warm] * b)
        t0 = time.perf_counter()
        engine.infer_batch([warm] * b)
        engine._service_time_s[b] = time.perf_counter() - t0
    print(f"service times: { {k: round(v * 1e3, 1) for k, v in engine._service_time_s.items()} }"
          " ms", file=sys.stderr, flush=True)
    engine.start_batcher()
    # Warm through the micro-batcher too, with backpressure: a small
    # latency-sized queue rightly rejects a blind burst (and, under
    # shed_oldest, sheds an earlier warm-up request, which is no error).
    print("warming through batcher...", file=sys.stderr, flush=True)

    def settle(fut) -> None:
        try:
            fut.result(timeout=300)
        except EngineOverloaded:
            pass

    warm_pending = []
    for _ in range(max(args.bucket, 4)):
        while True:
            try:
                warm_pending.append(engine.submit(warm))
                break
            except EngineOverloaded:
                if warm_pending:
                    settle(warm_pending.pop(0))
                else:
                    time.sleep(0.05)
    for fut in warm_pending:
        settle(fut)
    # A fresh metrics window: warm-up latencies stay out of the stats.
    engine.metrics.reset()
    print("measurement window open", file=sys.stderr, flush=True)
    n_blobs = len(blobs)
    latencies: List[float] = []
    lat_lock = threading.Lock()
    sem = threading.Semaphore(args.inflight)
    errors: List[BaseException] = []
    shed_or_rejected = 0

    def collect(fut, t_submit):
        try:
            fut.result(timeout=120)
            with lat_lock:
                latencies.append(time.perf_counter() - t_submit)
        except Exception as e:
            errors.append(e)
        finally:
            sem.release()

    def collect_open(fut, t_submit):
        """Open-loop completion: shed requests count separately, not as errors."""
        nonlocal shed_or_rejected
        try:
            fut.result(timeout=120)
            with lat_lock:
                latencies.append(time.perf_counter() - t_submit)
        except EngineOverloaded:
            with lat_lock:
                shed_or_rejected += 1
        except Exception as e:
            errors.append(e)

    from concurrent.futures import ThreadPoolExecutor

    collector = ThreadPoolExecutor(max_workers=2)
    t0 = time.perf_counter()
    i = 0
    submitted = 0
    if args.mode == "closed":
        while time.perf_counter() - t0 < args.seconds:
            sem.acquire()
            blob = blobs[i % n_blobs]
            i += 1
            t_submit = time.perf_counter()
            fut = engine.submit(decode(blob))
            submitted += 1
            collector.submit(collect, fut, t_submit)
        for _ in range(args.inflight):
            sem.acquire()
    else:
        # Open-loop arrivals at a fixed rate: closed loops throttle
        # themselves and hide queue growth.
        interval = 1.0 / args.rate
        next_t = t0
        while time.perf_counter() - t0 < args.seconds:
            now = time.perf_counter()
            if now < next_t:
                time.sleep(min(next_t - now, 0.01))
                continue
            next_t += interval
            blob = blobs[i % n_blobs]
            i += 1
            # Shed before the decode: an overloaded host must not decode a
            # frame it is about to reject.
            if not engine.accepting():
                shed_or_rejected += 1
                submitted += 1
                continue
            t_submit = time.perf_counter()
            img = decode(blob)
            try:
                fut = engine.submit(img)
            except EngineOverloaded:
                shed_or_rejected += 1
                continue
            finally:
                submitted += 1
            collector.submit(collect_open, fut, t_submit)
        time.sleep(2.0)  # drain the tail
    elapsed = time.perf_counter() - t0
    engine.stop_batcher()
    collector.shutdown(wait=True)

    if errors:
        raise RuntimeError(f"{len(errors)} requests failed: {errors[:3]}")
    lat = np.asarray(sorted(latencies)) * 1e3
    completed = len(lat)
    latency_target = icfg.performance.latency_target_ms
    report = {
        "mode": args.mode,
        "sustained_fps_host_inclusive": round(completed / elapsed, 2),
        "offered_rate_fps": (None if args.mode == "closed" else args.rate),
        "seconds": round(elapsed, 2),
        "frames": completed,
        "submitted": submitted,
        "shed_or_rejected": shed_or_rejected,
        "image_size": args.image_size,
        "p50_ms": round(float(np.percentile(lat, 50)), 2),
        "p95_ms": round(float(np.percentile(lat, 95)), 2),
        "p99_ms": round(float(np.percentile(lat, 99)), 2),
        "mean_ms": round(float(np.mean(lat)), 2),
        # The reference's CI SLA: mean < 50 ms, p95 < 100 ms.
        "meets_latency_target": round(float(np.mean(lat <= 2 * latency_target)), 4),
        "sla": {"mean_ms_lt": latency_target, "p95_ms_lt": 2 * latency_target,
                "mean_ok": bool(np.mean(lat) < latency_target),
                "p95_ok": bool(np.percentile(lat, 95) < 2 * latency_target)},
        "overload_policy": args.policy,
        "host_letterbox": args.host_letterbox,
        "path": "jpeg->decode->letterbox->microbatch->device(fwd+decode+nms)->boxes",
        "engine_stats": engine.get_performance_stats(),
    }
    print(json.dumps(launch_report(engine)), file=sys.stderr, flush=True)
    print(json.dumps({k: v for k, v in report.items() if k != "engine_stats"}, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2, default=float)
    return report


if __name__ == "__main__":
    main()
