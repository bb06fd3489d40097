"""Benchmark suite: throughput against batch size, device memory, a sustained
run, and JPEG to boxes end to end.

Counterpart of ``scripts/benchmark.py``, with its flags, defaults and
output files plus ``--device``: the serving engine's captured graph of each
batch in ``--batches`` (``engine._serve_fn(b)``: uint8 frames in, the packed
detections copied to the host) replayed ``--iters`` times with one
synchronize after the loop (ms per batch, frames/s, and the card's
allocated memory, ``torch.cuda.memory_allocated``, the counterpart of XLA's
``bytes_in_use``); the largest batch replayed for ``--sustained-s`` seconds
under ``utils.ResourceMonitor``; a 480x640 JPEG decoded with cv2 and served
by ``engine.infer``, ``--iters`` times (mean, p50, p95, p99 ms). Writes
``benchmark.json``, ``throughput.csv`` and ``benchmark.md`` into
``--output`` and prints the script's last line. ``--checkpoint`` reads a
checkpoint of the port's trainer, served with its own class count. On
stderr, one JSON line gives the graphs' replays, the graphs captured and
the kernel counters (``kernel_launches``). Runs on the card unless
``--device cpu`` is given::

    python -m hvs_tpu_torch.benchmark --image-size 640 --batches 1 2 4 8
    python -m hvs_tpu_torch.benchmark --tiny --device cpu --batches 1 2 --sustained-s 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Benchmark the detection stack (PyTorch/CUDA port)")
    p.add_argument("--image-size", type=int, default=640)
    p.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--sustained-s", type=float, default=10.0)
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of the port's trainer (<path> or <path>.pt)")
    p.add_argument("--output", default="benchmark_results")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def stage(engine, entry, images_u8: np.ndarray) -> None:
    """Copy a uint8 NHWC batch into a bucket graph's fixed input."""
    with engine._serve_lock, engine._on(engine._stream):
        entry.static_in.copy_(torch.from_numpy(np.ascontiguousarray(images_u8)))


def replay(engine, entry, iters: int) -> None:
    """``iters`` replays of a bucket graph (eager calls on the CPU), each
    with its copy-out, enqueued on the engine's serve stream; no wait."""
    with engine._serve_lock, engine._on(engine._stream):
        for _ in range(iters):
            entry.run(engine._stream)


def launch_report(engine) -> Dict[str, Any]:
    """What an engine-based entry point reports on stderr: its graphs'
    replays, the graphs captured, kernel A's sites per replay, and the
    kernel counters (which count eager calls and captures, not replays)."""
    from .training.chunk import kernel_counts

    return {"kernel_launches": kernel_counts(), "replays": sum(engine.replays.values()),
            "graphs": len(engine.replays), "kernel_sites": engine.kernel_sites}


class BenchmarkRunner:
    """The benchmark suite over one ``InferenceEngine``."""

    def __init__(self, args: argparse.Namespace):
        from .config import InferenceConfig, ModelConfig
        from .inference import InferenceEngine

        device = args.device or "auto"
        mcfg = ModelConfig(device=device)
        icfg = InferenceConfig(device=device)
        icfg.preprocessing.image_size = args.image_size
        icfg.performance.batch_buckets = tuple(sorted(args.batches))
        if args.checkpoint:
            from .bench import checkpoint_classes, read_checkpoint

            icfg.checkpoint_path = args.checkpoint
            mcfg.detection.num_classes = checkpoint_classes(read_checkpoint(args.checkpoint))
        if args.tiny:
            from .export_model import tiny_configs

            tiny_configs(mcfg, icfg, args.image_size)
        self.engine = InferenceEngine(mcfg, icfg)
        self.args = args
        self.image_size = icfg.preprocessing.image_size
        self.results: Dict[str, Any] = {}

    def _device_mem_mb(self) -> float:
        """The card's memory held by tensors (0 on the CPU)."""
        if self.engine.device.type != "cuda":
            return 0.0
        return torch.cuda.memory_allocated(self.engine.device) / 2**20

    def _bucket(self, b: int, seed: int):
        entry = self.engine._serve_fn(b)
        x = np.random.default_rng(seed).integers(
            0, 255, (b, self.image_size, self.image_size, 3), np.uint8)
        stage(self.engine, entry, x)
        return entry

    # ------------------------------------------------------------------
    def throughput_sweep(self) -> Dict[int, Dict[str, float]]:
        """Pipelined replays per batch: ms per batch, frames/s, memory."""
        sweep = {}
        for b in self.args.batches:
            entry = self._bucket(b, 0)
            replay(self.engine, entry, 1)
            self.engine._synchronize()
            mem_before = self._device_mem_mb()
            t0 = time.perf_counter()
            replay(self.engine, entry, self.args.iters)
            self.engine._synchronize()
            dt = (time.perf_counter() - t0) / self.args.iters
            sweep[b] = {
                "latency_ms": dt * 1e3,
                "throughput_fps": b / dt,
                "device_mem_mb": self._device_mem_mb(),
                "mem_delta_mb": self._device_mem_mb() - mem_before,
            }
        self.results["throughput"] = sweep
        return sweep

    def sustained_run(self) -> Dict[str, float]:
        """The largest batch replayed for ``--sustained-s`` seconds while
        ``ResourceMonitor`` samples the host and the card."""
        from .utils import ResourceMonitor

        b = max(self.args.batches)
        entry = self._bucket(b, 1)
        replay(self.engine, entry, 1)
        self.engine._synchronize()
        monitor = ResourceMonitor(interval_s=0.25)
        monitor.start()
        frames = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.args.sustained_s:
            replay(self.engine, entry, 1)
            frames += b
        self.engine._synchronize()
        elapsed = time.perf_counter() - t0
        resources = monitor.stop()
        self.results["sustained"] = {"duration_s": elapsed, "frames": frames,
                                     "fps": frames / elapsed, **resources}
        return self.results["sustained"]

    def end_to_end(self) -> Dict[str, float]:
        """A 480x640 JPEG decoded and served by ``engine.infer``."""
        import cv2

        rng = np.random.default_rng(2)
        img = rng.integers(0, 255, (480, 640, 3), np.uint8)
        ok, buf = cv2.imencode(".jpg", img)
        assert ok
        jpeg = buf.tobytes()
        self.engine.infer(cv2.imdecode(np.frombuffer(jpeg, np.uint8), 1))  # warm
        lats = []
        for _ in range(self.args.iters):
            t0 = time.perf_counter()
            frame = cv2.imdecode(np.frombuffer(jpeg, np.uint8), 1)
            self.engine.infer(frame)
            lats.append(time.perf_counter() - t0)
        lats_ms = np.asarray(lats) * 1e3
        self.results["end_to_end"] = {
            "mean_ms": float(lats_ms.mean()),
            "p50_ms": float(np.percentile(lats_ms, 50)),
            "p95_ms": float(np.percentile(lats_ms, 95)),
            "p99_ms": float(np.percentile(lats_ms, 99)),
        }
        return self.results["end_to_end"]

    # ------------------------------------------------------------------
    def save(self, out_dir: str) -> None:
        """``benchmark.json``, ``throughput.csv`` and ``benchmark.md``."""
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "benchmark.json"), "w") as f:
            json.dump(self.results, f, indent=2, default=float)
        lines = ["batch,latency_ms,throughput_fps,device_mem_mb"]
        for b, r in self.results.get("throughput", {}).items():
            lines.append(f"{b},{r['latency_ms']:.3f},{r['throughput_fps']:.1f},"
                         f"{r['device_mem_mb']:.0f}")
        with open(os.path.join(out_dir, "throughput.csv"), "w") as f:
            f.write("\n".join(lines))
        md = ["# Benchmark results", "", "| batch | latency (ms) | fps | HBM (MB) |",
              "|---|---|---|---|"]
        for b, r in self.results.get("throughput", {}).items():
            md.append(f"| {b} | {r['latency_ms']:.2f} | {r['throughput_fps']:.1f} | "
                      f"{r['device_mem_mb']:.0f} |")
        if "end_to_end" in self.results:
            e = self.results["end_to_end"]
            md += ["", f"End-to-end (JPEG decode + letterbox + infer): "
                       f"p50 {e['p50_ms']:.1f} ms, p95 {e['p95_ms']:.1f} ms"]
        if "sustained" in self.results:
            s = self.results["sustained"]
            md += ["", f"Sustained {s['duration_s']:.0f}s: {s['fps']:.1f} fps"]
        with open(os.path.join(out_dir, "benchmark.md"), "w") as f:
            f.write("\n".join(md))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    runner = BenchmarkRunner(args)
    sweep = runner.throughput_sweep()
    e2e = runner.end_to_end()
    if args.sustained_s > 0:
        runner.sustained_run()
    runner.save(args.output)
    print(json.dumps(launch_report(runner.engine)), file=sys.stderr, flush=True)
    best = max(sweep.values(), key=lambda r: r["throughput_fps"])
    line = {"best_throughput_fps": round(best["throughput_fps"], 1),
            "e2e_p50_ms": round(e2e["p50_ms"], 2), "output_dir": args.output}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
