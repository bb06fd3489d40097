"""Profiling: operation counts, timed calls, batch-size sweeps, a resource
monitor.

Counterpart of ``hvs_tpu/utils/profiler.py`` in PyTorch's idiom:

  * :class:`ModelProfiler` — ``cost_analysis`` counts the product flops,
    the transcendentals and the bytes of one call (the convention is in its
    docstring); wall time from CUDA events on the card (the host clock on
    the CPU); ``trace`` writes a ``torch.profiler`` Chrome trace into
    ``log_dir``; ``profile`` adds the achieved rate and the recommendations.
  * :class:`InferenceProfiler` — latency and throughput per batch size, the
    best batch within a latency budget, and scaling against batch 1.
  * :class:`ResourceMonitor` — a background thread sampling the host
    (psutil) and the card's memory.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@dataclass
class ProfileReport:
    flops: Optional[float]
    bytes_accessed: Optional[float]
    wall_time_ms: float
    achieved_tflops: Optional[float]
    memory_mb: Optional[float]
    recommendations: List[str] = field(default_factory=list)


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _wait(result) -> None:
    """Wait for the card where ``result`` holds tensors on it."""
    for t in _tensors(result):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


@functools.lru_cache(maxsize=None)
def _moves_no_bytes(func) -> bool:
    """Whether ``func`` is a view or aliasing operator: ``func.is_view``, or
    every return of its schema an alias that is not a write (``detach``,
    ``split``, ``alias``)."""
    if func.is_view:
        return True
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)


class _CostCounter(TorchDispatchMode):
    """The bytes of every operator's tensor inputs and outputs, views and
    aliases excluded, and the transcendentals of kernel B's operators."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from ..ops.sinkhorn import transcendentals

        out = func(*args, **(kwargs or {}))
        if not _moves_no_bytes(func):
            self.total += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs, out)))
        self.transcendentals += transcendentals(func, args)
        return out


class ModelProfiler:
    """Profile a function on its example arguments, on the device they are on."""

    # Dense bf16 tensor-core peak by card name (NVIDIA's data sheet, SXM
    # part, at its 700 W power limit), for the utilization estimate.
    PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.0}

    def __init__(self, fn: Callable, *example_args):
        self.fn = fn
        self.example_args = example_args
        tensors = _tensors(example_args)
        self.device = tensors[0].device if tensors else torch.device("cpu")

    def cost_analysis(self) -> Dict[str, float]:
        """What one call costs, counted over the operators PyTorch
        dispatches (each counted once, at the top of the dispatch; what an
        operator does below itself is not seen):

          * ``flops``: product flops, 2 per multiply-add of every matmul,
            convolution and attention (``FlopCounterMode``), the padded taps
            of a SAME convolution included; kernels A and C by their
            operators' formulas (8·N·d² and 10·N·d²). Elementwise work counts
            nothing;
          * ``transcendentals``: the exponentials of kernel B's operators
            (``hvs::sinkhorn_log``: (2·n_iters + 2)·n² per matrix,
            ``hvs::sinkhorn_log_backward``: 2·n_iters·n²); no other
            operator's;
          * ``bytes accessed``: the bytes of every operator's tensor inputs
            and outputs, as if nothing were fused; views and aliasing
            operators count none.

        Every kernel runs below a registered operator (its CPU version, the
        plain one, included), so a call counts the same on the CPU and on the
        card. XLA's ``cost_analysis`` counts differently: its flops add
        elementwise work and skip the out-of-bounds taps of a SAME
        convolution, and its bytes are those of its fused program, so the
        numbers are not comparable with an ``xla_*`` one."""
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter, _CostCounter() as cost:
            _wait(self.fn(*self.example_args))
        return {"flops": float(counter.get_total_flops()),
                "transcendentals": float(cost.transcendentals),
                "bytes accessed": float(cost.total)}

    def measure_wall_time(self, iters: int = 20) -> float:
        """Seconds per call: CUDA events around ``iters`` calls on the card,
        the host clock on the CPU; after one warm call."""
        _wait(self.fn(*self.example_args))
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                self.fn(*self.example_args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            self.fn(*self.example_args)
        return (time.perf_counter() - t0) / iters

    def profile(self, iters: int = 20) -> ProfileReport:
        costs = self.cost_analysis()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        wall = self.measure_wall_time(iters)
        flops, byts = costs.get("flops"), costs.get("bytes accessed")
        achieved = flops / wall / 1e12 if flops else None
        peak = self.PEAK_TFLOPS.get(torch.cuda.get_device_name(self.device)) if cuda else None
        mem_mb = torch.cuda.max_memory_allocated(self.device) / 2**20 if cuda else None

        recs: List[str] = []
        if achieved is not None and peak is not None and achieved < 0.1 * peak:
            recs.append(
                f"tensor-core utilization {achieved / peak:.1%}: the call is latency- or "
                "bandwidth-bound; increase the batch size or capture it in a CUDA graph.")
        if byts and flops and flops / max(byts, 1) < 10:
            recs.append(
                f"arithmetic intensity {flops / max(byts, 1):.1f} FLOP/byte: "
                "memory-bound; consider bf16 activations and fused kernels.")
        return ProfileReport(flops=flops, bytes_accessed=byts, wall_time_ms=wall * 1e3,
                             achieved_tflops=achieved, memory_mb=mem_mb, recommendations=recs)

    def trace(self, log_dir: str, iters: int = 5) -> str:
        """A ``torch.profiler`` trace of ``iters`` calls, written to
        ``log_dir/trace.json`` (Chrome trace format)."""
        from torch.profiler import ProfilerActivity, profile

        _wait(self.fn(*self.example_args))
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for _ in range(iters):
                r = self.fn(*self.example_args)
            _wait(r)
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        return log_dir


class InferenceProfiler:
    """Latency and throughput over batch sizes."""

    def __init__(self, make_fn: Callable[[int], Callable], batch_sizes=(1, 2, 4, 8)):
        """``make_fn(batch)`` returns a callable taking a [batch, ...] input."""
        self.make_fn = make_fn
        self.batch_sizes = batch_sizes
        self.results: Dict[int, Dict[str, float]] = {}

    def run(self, make_input: Callable[[int], Any], iters: int = 20) -> Dict[int, Dict]:
        """Host-clock seconds per call of each batch size, after one warm
        call; each timed run ends when the card has finished."""
        for b in self.batch_sizes:
            fn = self.make_fn(b)
            x = make_input(b)
            _wait(fn(x))
            t0 = time.perf_counter()
            for _ in range(iters):
                r = fn(x)
            _wait(r)
            dt = (time.perf_counter() - t0) / iters
            self.results[b] = {
                "latency_ms": dt * 1e3,
                "throughput_fps": b / dt,
                "latency_per_item_ms": dt * 1e3 / b,
            }
        return self.results

    def optimal_batch(self, latency_budget_ms: Optional[float] = None) -> int:
        """The highest-throughput batch within the latency budget."""
        candidates = {
            b: r for b, r in self.results.items()
            if latency_budget_ms is None or r["latency_ms"] <= latency_budget_ms
        } or self.results
        return max(candidates, key=lambda b: candidates[b]["throughput_fps"])

    def scaling_efficiency(self) -> Dict[int, float]:
        """Throughput against batch 1 times the batch size."""
        if 1 not in self.results:
            return {}
        base = self.results[1]["throughput_fps"]
        return {b: r["throughput_fps"] / (base * b) for b, r in self.results.items()}


class ResourceMonitor:
    """Background sampler of the host (psutil) and the card's memory."""

    def __init__(self, interval_s: float = 0.5, window: int = 1200):
        self.interval_s = interval_s
        self.samples: deque = deque(maxlen=window)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sample(self) -> Dict[str, float]:
        import psutil

        vm = psutil.virtual_memory()
        s = {
            "time": time.time(),
            "cpu_percent": psutil.cpu_percent(interval=None),
            "mem_percent": vm.percent,
            "mem_used_gb": vm.used / 2**30,
        }
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            s["device_mem_gb"] = torch.cuda.memory_allocated() / 2**30
            s["device_mem_limit_gb"] = torch.cuda.mem_get_info()[1] / 2**30
        return s

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.samples.append(self._sample())
                except Exception:  # a failed sample is skipped; the next one runs
                    pass
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> Dict[str, float]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        return self.summary()

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        keys = [k for k in self.samples[0] if k != "time"]
        out = {}
        for k in keys:
            arr = np.asarray([s[k] for s in self.samples if k in s])
            if len(arr):
                out[f"{k}_mean"] = float(arr.mean())
                out[f"{k}_max"] = float(arr.max())
        return out
