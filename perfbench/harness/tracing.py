"""The benchmark's own spans around its calls into the program, and the
reading of a ``torch.profiler`` trace of the card: busy seconds (the union
of kernel, copy and set intervals), the traced window, the device
operations that took most time and the longest idle gaps."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch


class Spans:
    """Host-clock spans by name: [(start, end)] in seconds. ``active``
    off, a span costs one branch; on, it also enters a profiler range of
    the same name, so the trace shows it."""

    def __init__(self, active: bool = False):
        self.active = active
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.spans[name].append((t0, time.perf_counter()))


class Trace:
    """A profiler (host operations and the card's) over a whole window: it
    starts before the window opens, so its own start-up stalls nothing
    that is timed, and stops once the window has closed."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is not None and not self.t1:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.prof.__exit__(None, None, None)

    def read(self) -> Optional["TraceSummary"]:
        if self.prof is None:
            return None
        return TraceSummary(self.prof.profiler.kineto_results.events(), self.t1 - self.t0)


class TraceSummary:
    """What the per-layer metrics read from a trace: the card's operations
    (kernels, copies, sets; a span's range on the card's timeline is none),
    the busy and window seconds, device time by operation name, and the ten
    longest idle gaps, each named by the innermost host operation or span
    running at its middle."""

    def __init__(self, events, window_s: float):
        kernels: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str]] = []
        for ev in events:
            name, start = ev.name(), ev.start_ns()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if not ev.is_user_annotation() and not name.startswith("bench."):
                    kernels.append((start, start + ev.duration_ns(), name))
            else:
                host.append((start, start + ev.duration_ns(), name))
        kernels.sort()
        self.window_s = window_s
        self.launches = len(kernels)
        busy, gaps, end = 0, [], None
        self.by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for s, e, name in kernels:
            self.by_name[name][0] += (e - s) / 1e9
            self.by_name[name][1] += 1
            if end is None or s > end:
                if end is not None:
                    gaps.append((s - end, end, s))
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        self.busy_s = busy / 1e9
        gaps.sort(reverse=True)
        self.idle_gaps = [[self._host_at(host, (a + b) // 2), g / 1e9] for g, a, b in gaps[:10]]

    @staticmethod
    def _host_at(host, t: int) -> str:
        best = None
        for s, e, name in host:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "host: no operation"

    def kernel_time(self, substring: str) -> Tuple[float, int]:
        """Seconds and launches of the device operations whose name holds
        ``substring``."""
        t, n = 0.0, 0
        for name, (sec, count) in self.by_name.items():
            if substring in name:
                t += sec
                n += count
        return t, n

    def breakdown(self) -> Dict[str, list]:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[name[:160], sec] for name, (sec, _) in top],
                "idle_gaps": self.idle_gaps}
