"""Spans of the port's own work, kept in memory while a ``torch.profiler``
runs anywhere in the process.

A span is a plain tuple ``(name, start_ns, end_ns, span_id, parent_id,
thread_id)``. Stamps are on the profiler's clock (``now_ns``), so a span
lines up with the host operations and the card's kernels of the same trace.
A span opened inside another on the same thread has it as its parent; a
caller may name another parent (a batch's finalize and its requests' queue
waits have the batch's ``engine.dispatch`` span as theirs).

The switch is the profiler itself: nothing is recorded unless one runs, and
without one a span costs one flag test. On a thread the profiler records (the
thread that started it), a span also enters
``torch.profiler.record_function("hvs.<name>")``, so the trace's own export
carries it; spans of other threads (the micro-batcher's) are only in memory.

Run ``torch.profiler.profile`` around a server to get both; read the spans
with :meth:`SpanRecorder.spans`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

Span = Tuple[str, int, int, int, Optional[int], int]

# What a span costs while no profiler runs: this shared, reusable context.
NO_SPAN = contextlib.nullcontext()
# Spans kept: a 30-s window of the camera fleet records ~18,000.
CAPACITY = 1 << 17


def now_ns() -> int:
    """The profiler's clock: kineto stamps host and device events in
    Unix-epoch nanoseconds (``tests/test_torch_tracing.py`` pins it)."""
    return time.time_ns()


def profiling() -> bool:
    """Whether a torch profiler runs in the process. The process-wide flag:
    the thread-local one (``torch._C._autograd._profiler_enabled``) reads
    False on every thread but the profiler's own."""
    return _autograd_profiler._is_profiler_enabled


class SpanRecorder:
    """Spans in a bounded buffer (the oldest go first), and the ids that
    spans and requests share."""

    def __init__(self):
        self._spans: deque = deque(maxlen=CAPACITY)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def new_id(self) -> int:
        return next(self._ids)

    def span(self, name: str, parent: Optional[int] = None):
        """A context manager that records ``name`` around its body while a
        profiler runs, and yields its id (None while none does)."""
        if not profiling():
            return NO_SPAN
        return _Open(self, name, parent)

    def record(self, name: str, start_ns: int, end_ns: int, span_id: int,
               parent: Optional[int] = None) -> None:
        """A span from two stamps, taken on any threads (a request's queue
        wait: its submit, its batch's dispatch)."""
        self._append((name, start_ns, end_ns, span_id, parent, threading.get_ident()))

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def _append(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Open:
    """One span being recorded. Its stamps are taken just inside the
    profiler's range at the start and just after it at the end, the least
    distance from the range's own stamps."""

    __slots__ = ("rec", "name", "parent", "id", "start", "range")

    def __init__(self, rec: SpanRecorder, name: str, parent: Optional[int]):
        self.rec, self.name, self.parent = rec, name, parent

    def __enter__(self) -> int:
        stack = self.rec._stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        self.id = self.rec.new_id()
        stack.append(self.id)
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(f"hvs.{self.name}")
            self.range.__enter__()
        self.start = now_ns()
        return self.id

    def __exit__(self, *exc) -> None:
        if self.range is not None:
            self.range.__exit__(*exc)
        end = now_ns()
        self.rec._stack().pop()
        self.rec._append((self.name, self.start, end, self.id, self.parent,
                          threading.get_ident()))
