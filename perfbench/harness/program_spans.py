"""What the program records of its own work, read after a traced window:
the serving engine's spans (``InferenceEngine.spans``, kept while a
profiler runs: name, start and end in ns on the profiler's clock, id,
parent id, thread) and its always-on counters (``get_performance_stats``),
and the card's busy intervals of the same trace. A program that keeps none
of them reads as None, and so does each metric built on them."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

Interval = Tuple[int, int]


def spans(run) -> Optional[list]:
    """The engine's spans, or None where it records none."""
    recorder = getattr(run.engine, "spans", None)
    got = recorder.spans() if recorder is not None else None
    return got or None


def named(run, name: str) -> Optional[list]:
    """The spans called ``name``, or None where there are none."""
    got = [s for s in spans(run) or () if s[0] == name]
    return got or None


def per_batch_ms(run, name: str) -> Optional[float]:
    """Milliseconds in spans called ``name``, over the batches dispatched
    (``engine.dispatch`` spans)."""
    batches, parts = named(run, "engine.dispatch"), named(run, name)
    if batches is None or parts is None:
        return None
    return sum(e - s for _, s, e, *_ in parts) / len(batches) / 1e6


def counter(run, key: str):
    """One of the engine's counters, or None where it keeps no such one."""
    if run.engine is None:
        return None
    return run.engine.get_performance_stats().get(key)


def window_ns(run) -> Optional[Interval]:
    """The traced window on the profiler's clock: from the trace's start,
    as long as the window the other trace metrics divide by."""
    if run.trace is None or run.trace.prof is None or run.summary is None:
        return None
    start = run.trace.prof.profiler.kineto_results.trace_start_ns()
    return start, start + int(run.summary.window_s * 1e9)


def device_busy(run) -> List[Interval]:
    """The union of the card's kernel, copy and set intervals in the trace,
    sorted (ranges of the benchmark's and the program's spans are none)."""
    events = run.trace.prof.profiler.kineto_results.events()
    ops = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in events
                 if ev.device_type() == torch.autograd.DeviceType.CUDA
                 and not ev.is_user_annotation()
                 and not ev.name().startswith(("bench.", "hvs.")))
    return union(ops)


def union(intervals) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: List[Interval], b: List[Interval]) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
