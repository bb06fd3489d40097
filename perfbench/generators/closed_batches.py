"""Closed loop of full batches of raw camera frames through
``InferenceEngine.dispatch_batch`` / ``finalize_batch`` on the raw-frame
graph: batch i + 1 is dispatched before batch i is finalised, as the
engine's own batcher overlaps them. A fleet server's or a recorded-video
job's throughput.

Traffic file: ``frame_h``, ``frame_w`` (the camera), ``image_size`` (the
model's input), ``batch``, ``pool`` (seeded frames made at set-up and
cycled), ``sample`` (served frames judged after the window, a uniform
draw from the seed over all the window served); ``check`` and its
``limits`` and ``floors``."""

from __future__ import annotations

import time

import numpy as np

from perfbench.harness import program


def setup(run) -> None:
    t = run.traffic
    run.engine = program.build_engine(run.cfg, run.weights, t["image_size"], (t["batch"],),
                                      run.device)
    run.engine.register_raw_shape((t["frame_h"], t["frame_w"]), buckets=[t["batch"]])
    run.host_frames = [f for f in run.frames.cpu().numpy()]
    for _ in range(3):  # the pinned ring and the first copies, outside the window
        run.engine.finalize_batch(run.engine.dispatch_batch(_batch(run, 0)))


def _batch(run, start: int):
    pool, b = run.host_frames, run.traffic["batch"]
    return [pool[(start + k) % len(pool)] for k in range(b)]


def window(run, seconds: float) -> None:
    """Batches until ``seconds`` have passed, then the one in flight; every
    served frame kept with its pool index."""
    engine, b, spans = run.engine, run.traffic["batch"], run.spans
    keep = Reservoir(run.traffic["sample"], np.random.default_rng([run.seed, 3]))
    pool, pending, sent = len(run.host_frames), None, 0
    replays0 = sum(engine.replays.values())
    t0 = run.mark_window_start()
    while True:
        with spans.span("dispatch"):
            handle = engine.dispatch_batch(_batch(run, sent))
        if pending is not None:
            for k, det in enumerate(_finalize(run, pending[0])):
                keep.offer(((pending[1] + k) % pool, det))
        pending = (handle, sent)
        sent += b
        if time.perf_counter() - t0 >= seconds:
            break
    for k, det in enumerate(_finalize(run, pending[0])):
        keep.offer(((pending[1] + k) % pool, det))
    run.result.update(window_s=time.perf_counter() - t0, frames=keep.seen, attempted=sent,
                      failed=0, replays=sum(engine.replays.values()) - replays0)
    run.served = keep.items


def _finalize(run, handle):
    """``finalize_batch``, after a wait for the batch's copy-out in a span of
    its own, so the ``finalize`` span is the host's work alone."""
    done = handle.get("done") if isinstance(handle, dict) else None
    if done is not None:
        with run.spans.span("wait"):
            done.synchronize()
    with run.spans.span("finalize"):
        return run.engine.finalize_batch(handle)


def close(run) -> None:
    run.engine = None


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from
    ``rng`` as they come (reservoir sampling), so the window holds no more
    answers than it judges."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng = size, rng
        self.items, self.seen = [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.items[j] = item
