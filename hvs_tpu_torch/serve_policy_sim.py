"""Micro-batcher policy comparison on a simulated device.

Counterpart of ``scripts/serve_policy_sim.py``, with its flags and report
keys. It drives the port's real ``_MicroBatcher``
(``inference/engine.py``) against a stub engine whose dispatch and finalize
follow a service-time model,

    service(batch) = fixed_overhead + per_item * n

(defaults: 40 ms fixed and 1.3 ms per frame, the JAX script's), and holds
its adaptive flush (wait for stragglers only while a batch is in flight)
against a fixed-deadline flush (always wait ``max_queue_delay_ms`` before a
dispatch; ``LegacyBatcher``) at open-loop arrival rates. It isolates the
part of the latency the batcher owns. Like the JAX script it has no device
by nature: nothing runs on a card or in a kernel. The default ``--output``
is ``serve_policy_sim.json``::

    python -m hvs_tpu_torch.serve_policy_sim --seconds 20 --rates 4,8,16
"""

from __future__ import annotations

import argparse
import json
import os
import queue as queue_mod
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence

import numpy as np

from .inference.engine import _MicroBatcher
from .utils.tracing import SpanRecorder


class StubEngine:
    """The service-time model of a device that runs one batch at a time;
    thread-safe."""

    def __init__(self, fixed_ms: float, per_item_ms: float, buckets=(1, 2, 4, 8, 16),
                 deadline_ms: float = 10.0, depth: int = 64):
        self.config = SimpleNamespace(performance=SimpleNamespace(
            batch_buckets=buckets, max_queue_depth=depth, overload_policy="reject",
            max_queue_delay_ms=deadline_ms))
        self.metrics = SimpleNamespace(record_error=lambda: None)
        self.spans = SpanRecorder()
        self.fixed_s = fixed_ms / 1e3
        self.per_item_s = per_item_ms / 1e3
        self._lock = threading.Lock()
        self._device_free_at = 0.0  # the device is busy until then

    def dispatch_batch(self, images, requests=None):
        n = len(images)
        with self._lock:
            now = time.perf_counter()
            start = max(now, self._device_free_at)
            done = start + self.fixed_s + self.per_item_s * n
            self._device_free_at = done
        return {"n": n, "done_at": done}

    def finalize_batch(self, handle):
        wait = handle["done_at"] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        return list(range(handle["n"]))


class LegacyBatcher(_MicroBatcher):
    """The fixed-deadline policy: always wait the flush deadline for
    stragglers before a dispatch, whether a batch is in flight or not."""

    def start(self) -> None:
        def finalize(pending):
            items, handle = pending
            try:
                results = self.engine.finalize_batch(handle)
                for (_, fut, _, _), det in zip(items, results):
                    fut.set_result(det)
            except Exception as e:
                for _, fut, _, _ in items:
                    if not fut.done():
                        fut.set_exception(e)

        def loop():
            pending = None
            while not self._stop.is_set():
                try:
                    first = self.queue.get(timeout=0.02 if pending else 0.1)
                except queue_mod.Empty:
                    if pending is not None:
                        finalize(pending)
                        pending = None
                    continue
                items = [first]
                deadline = time.perf_counter() + self.max_delay_s
                while len(items) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        items.append(self.queue.get(timeout=remaining))
                    except queue_mod.Empty:
                        break
                handle = self.engine.dispatch_batch([item[0] for item in items])
                if pending is not None:
                    finalize(pending)
                pending = (items, handle)
            if pending is not None:
                finalize(pending)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()


def run_one(policy_cls, rate_fps: float, seconds: float, fixed_ms: float,
            per_item_ms: float, deadline_ms: float) -> Dict[str, Any]:
    """Open-loop arrivals at ``rate_fps`` for ``seconds`` through one policy."""
    from concurrent.futures import ThreadPoolExecutor

    eng = StubEngine(fixed_ms, per_item_ms, deadline_ms=deadline_ms)
    b = policy_cls(eng)
    b.start()
    lat, lock = [], threading.Lock()
    pool = ThreadPoolExecutor(max_workers=4)

    def collect(fut, t0):
        try:
            fut.result(timeout=60)
            with lock:
                lat.append(time.perf_counter() - t0)
        except Exception:  # a rejected or failed request has no latency
            pass

    interval = 1.0 / rate_fps
    t_start = time.perf_counter()
    next_t = t_start
    img = np.zeros((4, 4, 3), np.uint8)
    while time.perf_counter() - t_start < seconds:
        now = time.perf_counter()
        if now < next_t:
            time.sleep(min(next_t - now, 0.005))
            continue
        next_t += interval
        try:
            fut = b.submit(img)
        except Exception:  # rejected at admission
            continue
        pool.submit(collect, fut, now)
    time.sleep(1.0)
    b.stop()
    pool.shutdown(wait=True)
    arr = np.asarray(sorted(lat)) * 1e3
    if not len(arr):
        return {"completed": 0}
    return {
        "completed": len(arr),
        "p50_ms": round(float(np.percentile(arr, 50)), 1),
        "p95_ms": round(float(np.percentile(arr, 95)), 1),
        "p99_ms": round(float(np.percentile(arr, 99)), 1),
        "mean_ms": round(float(arr.mean()), 1),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description="Micro-batcher policies on a simulated device")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--fixed-ms", type=float, default=40.0)
    p.add_argument("--per-item-ms", type=float, default=1.3)
    p.add_argument("--deadline-ms", type=float, default=33.0, help="flush deadline")
    p.add_argument("--rates", default="4,8,16")
    p.add_argument("--output", default="serve_policy_sim.json")
    args = p.parse_args(argv)

    floor_ms = args.fixed_ms + args.per_item_ms
    report: Dict[str, Any] = {
        "what": ("the port's _MicroBatcher against a fixed-deadline policy on a simulated "
                 "device (service = fixed + per_item*n); the batcher's own latency, "
                 "without a device"),
        "service_model": {
            "fixed_ms": args.fixed_ms, "per_item_ms": args.per_item_ms,
            "single_request_floor_ms": round(floor_ms, 1),
            "flush_deadline_ms": args.deadline_ms,
        },
        "rates": {},
    }
    for rate in [float(r) for r in args.rates.split(",")]:
        adaptive = run_one(_MicroBatcher, rate, args.seconds, args.fixed_ms,
                           args.per_item_ms, args.deadline_ms)
        legacy = run_one(LegacyBatcher, rate, args.seconds, args.fixed_ms,
                         args.per_item_ms, args.deadline_ms)
        report["rates"][str(rate)] = {
            "adaptive_flush_r4": adaptive,
            "fixed_deadline_r3": legacy,
            "p95_improvement_ms": round(legacy.get("p95_ms", 0) - adaptive.get("p95_ms", 0), 1),
        }
        print(f"rate {rate}: adaptive p50/p95 = {adaptive.get('p50_ms')}/"
              f"{adaptive.get('p95_ms')}  fixed = {legacy.get('p50_ms')}/"
              f"{legacy.get('p95_ms')}", flush=True)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.output}")
    return report


if __name__ == "__main__":
    main()
