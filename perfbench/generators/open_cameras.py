"""Open loop of camera streams into the engine's micro-batcher
(``InferenceEngine.submit``: the batch buckets, the default queue delay and
overload policy). Each camera sends a raw frame every 1/``fps`` s from its
phase, each frame up to ``jitter_ms`` early or late (a camera's clock and
capture stack), whatever the engine does; a frame is timed from when its camera was
due to send it until its answer reached the host. A frame the engine
refuses counts as failed and as missing every limit (its latency is the
wait limit).

Traffic file: ``frame_h``, ``frame_w``, ``image_size``, ``buckets``,
``phases`` (one per camera, fractions of a frame period), ``fps``,
``jitter_ms``, ``pool``, ``sample``; ``check`` and its ``limits`` and
``floors``."""

from __future__ import annotations

import threading
import time

import numpy as np

from perfbench.harness import program

WAIT_S = 60.0  # how long past the window's close an answer is waited for


def setup(run) -> None:
    t = run.traffic
    run.engine = program.build_engine(run.cfg, run.weights, t["image_size"], t["buckets"],
                                      run.device)
    run.engine.register_raw_shape((t["frame_h"], t["frame_w"]))
    run.host_frames = [f for f in run.frames.cpu().numpy()]
    engine = run.engine
    # Each bucket's graph and the pinned ring, replayed outside the window.
    for b in t["buckets"]:
        for _ in range(2):
            engine.finalize_batch(engine.dispatch_batch(run.host_frames[:b]))
    engine.start_batcher()
    for f in [engine.submit(run.host_frames[0]) for _ in range(max(t["buckets"]))]:
        f.result(timeout=WAIT_S)
    # The same arrivals in every run: the traffic file's phases (fractions
    # of a frame period) with the same jitter, dealt to the cameras in an
    # order drawn from the seed, so seeds change what the cameras see and
    # not when frames arrive.
    run.camera_of_slot = np.random.default_rng([run.seed, 2]).permutation(len(t["phases"]))


def _schedule(run, seconds: float):
    """(due offset in s, camera, frame number) of every frame due in the
    window, in time order. The offsets do not depend on the seed."""
    t = run.traffic
    period = 1.0 / t["fps"]
    jitter = np.random.default_rng(4)
    due = []
    for slot, phase in enumerate(np.asarray(t["phases"], dtype=np.float64) / t["fps"]):
        k = np.arange(int((seconds - phase) / period) + 1)
        offs = phase + k * period + jitter.uniform(-1.0, 1.0, size=len(k)) * t["jitter_ms"] / 1e3
        cam = int(run.camera_of_slot[slot])
        due += [(o, cam, int(i)) for o, i in zip(offs, k) if 0.0 <= o < seconds]
    due.sort()
    return due


def window(run, seconds: float) -> None:
    engine, pool = run.engine, run.host_frames
    overloaded = program.engine_overloaded()
    schedule = _schedule(run, seconds)
    n = len(schedule)
    # The answers judged: a draw from the seed over every frame due, made
    # before the window; the others are dropped as they come.
    picked = set(np.random.default_rng([run.seed, 3]).choice(
        n, size=min(run.traffic["sample"], n), replace=False).tolist())
    done_at = np.full(n, np.nan)
    answers, lock, all_done = {}, threading.Lock(), threading.Event()
    state = {"submitted": 0, "finished": 0, "closed": False}
    replays0 = sum(engine.replays.values())

    def finished(i):
        def cb(fut):
            now = time.perf_counter()
            error = fut.exception()
            with lock:
                if error is None:
                    done_at[i] = now
                    if i in picked:
                        answers[i] = fut.result()
                state["finished"] += 1
                if state["finished"] == state["submitted"] and state["closed"]:
                    all_done.set()
        return cb

    late = 0.0
    t0 = run.mark_window_start()
    for i, (off, cam, k) in enumerate(schedule):
        due = t0 + off
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.perf_counter() - due)
        try:
            fut = engine.submit(pool[(cam * 7 + k) % len(pool)])
        except overloaded:  # refused: no answer, counted as failed below
            continue
        with lock:
            state["submitted"] += 1
        fut.add_done_callback(finished(i))
    with lock:
        state["closed"] = True
        if state["finished"] == state["submitted"]:
            all_done.set()
    all_done.wait(timeout=max(0.0, t0 + seconds + WAIT_S - time.perf_counter()))
    window_end = time.perf_counter()
    engine.stop_batcher()
    with lock:
        due_at = t0 + np.array([s[0] for s in schedule])
        lat = np.where(np.isnan(done_at), WAIT_S, done_at - due_at)
        frames = int(np.isfinite(done_at).sum())
        failed = n - frames
        half = n // 2  # a backlog that grows shows as a later half slower than the first
        run.result.update(
            window_s=window_end - t0, frames=frames, attempted=n, failed=failed,
            latencies_s=lat, generator_late_s=late,
            p95_first_half_ms=float(np.percentile(lat[:half], 95)) * 1e3 if half else 0.0,
            p95_second_half_ms=float(np.percentile(lat[half:], 95)) * 1e3 if half else 0.0,
            replays=sum(engine.replays.values()) - replays0)
        run.served = [((schedule[i][1] * 7 + schedule[i][2]) % len(pool), answers[i])
                      for i in sorted(answers)]


def close(run) -> None:
    if run.engine is not None:
        run.engine.stop_batcher()
    run.engine = None
