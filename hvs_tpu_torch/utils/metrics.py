"""Serving metrics: ``InferenceMetrics``, latency percentiles and frame rates.

Counterpart of ``hvs_tpu/utils/metrics.py::InferenceMetrics`` (numpy only,
copied; ``DetectionEvaluator`` waits for ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict

import numpy as np


class InferenceMetrics:
    """Serving latency/FPS tracker with percentiles."""

    def __init__(self, window: int = 1000, latency_target_ms: float = 50.0):
        self.latencies: deque = deque(maxlen=window)
        self.batch_sizes: deque = deque(maxlen=window)
        self.errors = 0
        self.total_requests = 0
        self.latency_target_ms = latency_target_ms
        self._start = time.time()

    def record(self, latency_s: float, batch_size: int = 1) -> None:
        self.latencies.append(latency_s)
        self.batch_sizes.append(batch_size)
        self.total_requests += batch_size

    def record_error(self) -> None:
        self.errors += 1

    def reset(self) -> None:
        """Open a fresh measurement window. Called after warmup so that
        capture latencies recorded during warm batches never leak into
        serving stats."""
        self.latencies.clear()
        self.batch_sizes.clear()
        self.errors = 0
        self.total_requests = 0
        self._start = time.time()

    def summary(self) -> Dict[str, float]:
        if not self.latencies:
            return {"count": 0}
        arr = np.asarray(self.latencies) * 1e3
        frames = float(np.sum(self.batch_sizes))
        elapsed = max(time.time() - self._start, 1e-9)
        return {
            "count": len(arr),
            "mean_latency_ms": float(arr.mean()),
            "p50_latency_ms": float(np.percentile(arr, 50)),
            "p95_latency_ms": float(np.percentile(arr, 95)),
            "p99_latency_ms": float(np.percentile(arr, 99)),
            "fps": frames / float(np.sum(self.latencies)),
            "throughput_rps": self.total_requests / elapsed,
            "error_rate": self.errors / max(self.total_requests + self.errors, 1),
            "meets_latency_target": float(
                np.percentile(arr, 50) <= self.latency_target_ms
            ),
        }
