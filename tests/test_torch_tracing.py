"""The port's own spans and counters (``hvs_tpu_torch/utils/tracing.py``, the
serving engine's ``spans``) on the CPU, and the benchmark's per-layer
metrics that read them (``perfbench/metrics/``), on hand-made inputs.

The switch is a profiler running in the process: without one nothing is
recorded; under one, a tiny CPU engine and its micro-batcher record every
span the engine names (``engine.capture`` is the card's: the CPU captures
no graph, and ``test_torch_gpu.py`` checks it, with the card's clock).
"""

import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hvs_tpu_torch.inference import InferenceEngine
from hvs_tpu_torch.utils import tracing
from hvs_tpu_torch.utils.tracing import SpanRecorder
from tests.test_torch_engine_serving import port_inference_config, port_model_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RAW_HW = (48, 64)
CPU_SPANS = {"engine.dispatch", "engine.ring_wait", "engine.stage", "engine.letterbox_eager",
             "engine.launch", "engine.finalize", "engine.copyout_wait", "engine.postprocess",
             "batcher.wait", "batcher.assemble", "request.queued"}
# Spans opened inside another on the same thread, by their parent's name.
NESTED = {"engine.ring_wait": "engine.dispatch", "engine.stage": "engine.dispatch",
          "engine.letterbox_eager": "engine.dispatch", "engine.launch": "engine.dispatch",
          "engine.copyout_wait": "engine.finalize", "engine.postprocess": "engine.finalize"}


def _image(seed, hw=RAW_HW):
    return np.random.default_rng(seed).integers(0, 255, (*hw, 3), np.uint8)


@pytest.fixture(scope="module")
def tiny_engine():
    e = InferenceEngine(port_model_config(), port_inference_config())
    e.register_raw_shape(RAW_HW)
    e.infer_batch([_image(0), _image(1)])
    return e


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _serve_through_the_batcher(engine, n):
    """``n`` requests (at most the queue's 4) submitted at once to a batcher
    idle until then."""
    engine.start_batcher()
    try:
        time.sleep(0.05)
        futs = [engine.submit(_image(10 + i)) for i in range(n)]
        return [f.result(timeout=60) for f in futs]
    finally:
        engine.stop_batcher()


def _new_spans(engine, before):
    return engine.spans.spans()[before:]


def test_nothing_is_recorded_without_a_profiler(tiny_engine, monkeypatch):
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a) or real(*a, **k))
    before, eager = len(tiny_engine.spans.spans()), tiny_engine.eager_batches
    assert not tracing.profiling()
    tiny_engine.infer_batch([_image(2), _image(3)])
    tiny_engine.infer(_image(4, (37, 53)))
    _serve_through_the_batcher(tiny_engine, 3)
    assert _new_spans(tiny_engine, before) == [] and entered == []
    # The counters are kept all the same.
    assert tiny_engine.eager_batches == eager + 1


def _by_id(spans):
    return {s[3]: s for s in spans}


def _self_ns(span, spans):
    """A span's duration less the union of its children's intervals."""
    kids = sorted((s[1], s[2]) for s in spans if s[4] == span[3] and s[0] in NESTED)
    covered, end = 0, span[1]
    for s, e in kids:
        s, e = max(s, end), min(e, span[2])
        if e > s:
            covered += e - s
            end = e
    return span[2] - span[1] - covered


def test_spans_under_a_profiler_nest_and_name_the_batch(tiny_engine):
    before = len(tiny_engine.spans.spans())
    with _profile() as prof:
        tiny_engine.infer_batch([_image(5), _image(6)])
        tiny_engine.infer(_image(7, (37, 53)))
        _serve_through_the_batcher(tiny_engine, 4)
    spans = _new_spans(tiny_engine, before)
    assert {s[0] for s in spans} == CPU_SPANS
    by_id, main = _by_id(spans), threading.get_ident()
    for s in spans:
        name, start, end, _, parent, thread = s
        assert start <= end, s
        assert _self_ns(s, spans) >= 0, s
        if name in NESTED:
            p = by_id[parent]
            assert p[0] == NESTED[name] and p[5] == thread, (s, p)
            assert p[1] <= start and end <= p[2], (s, p)
        elif name == "engine.finalize":
            batch = by_id[parent]
            assert batch[0] == "engine.dispatch" and batch[2] <= start, (s, batch)
        elif name == "request.queued":
            batch = by_id[parent]
            assert batch[0] == "engine.dispatch" and batch[1] <= end <= batch[2], (s, batch)
        else:
            assert parent is None, s
        if name.startswith("batcher."):
            assert thread != main, s
    # Each batch is dispatched and finalised once; every request is queued once.
    dispatched = [s[3] for s in spans if s[0] == "engine.dispatch"]
    assert sorted(s[4] for s in spans if s[0] == "engine.finalize") == sorted(dispatched)
    assert len([s for s in spans if s[0] == "request.queued"]) == 4
    # The main thread's spans are ranges of the trace; the batcher's are not.
    ranges = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert {f"hvs.{s[0]}" for s in spans if s[5] == main} <= ranges
    assert "hvs.batcher.assemble" not in ranges


def test_latency_of_a_batcher_request_starts_at_submit(tiny_engine):
    tiny_engine.metrics.reset()
    before = len(tiny_engine.spans.spans())
    with _profile():
        dets = _serve_through_the_batcher(tiny_engine, 4)
    spans = _new_spans(tiny_engine, before)
    queued = sorted((s for s in spans if s[0] == "request.queued"), key=lambda s: s[3])
    queued_ms = [(s[2] - s[1]) / 1e6 for s in queued]
    for det, wait in zip(dets, queued_ms):
        assert det.latency_ms >= wait
    # Some request waited behind a whole batch in flight.
    batches = [s for s in spans if s[0] == "engine.dispatch"]
    assert any(q[1] <= b[1] and b[2] <= q[2] for q in queued for b in batches)
    stats = tiny_engine.get_performance_stats()
    assert stats["count"] == 4  # one entry per request
    assert stats["p95_latency_ms"] >= np.percentile(queued_ms, 95)
    assert stats["p95_latency_ms"] >= np.percentile([d.latency_ms for d in dets], 95) - 1e-9


def test_the_switch_is_the_profiler_on_every_thread():
    seen = {}

    def read(key):
        seen[key] = (tracing.profiling(), torch._C._autograd._profiler_enabled())

    with _profile():
        t = threading.Thread(target=read, args=("on",))
        t.start()
        t.join(timeout=10)
        on_main = (tracing.profiling(), torch._C._autograd._profiler_enabled())
    t = threading.Thread(target=read, args=("off",))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    # The thread-local flag reads False off the profiler's thread: the
    # recorder reads the process-wide one.
    assert seen["on"] == (True, False) and on_main == (True, True)
    assert seen["off"] == (False, False)


def test_a_span_and_its_profiler_range_share_the_clock():
    rec = SpanRecorder()
    with _profile() as prof:
        for _ in range(3):  # the first ranges of a process are slow to open
            with rec.span("warm"):
                pass
        for _ in range(20):
            with rec.span("clock"):
                time.sleep(0.001)
    ours = sorted((s[1], s[2]) for s in rec.spans() if s[0] == "clock")
    theirs = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                    for ev in prof.profiler.kineto_results.events() if ev.name() == "hvs.clock")
    assert len(ours) == len(theirs) == 20
    starts = [abs(a[0] - b[0]) for a, b in zip(ours, theirs)]
    ends = [abs(a[1] - b[1]) for a, b in zip(ours, theirs)]
    assert statistics.median(starts) < 100_000 and statistics.median(ends) < 100_000
    # The clock is the profiler's, not the interpreter's monotonic one.
    assert abs(ours[0][0] - time.time_ns()) < 60e9


def test_counters_cover_the_whole_load_and_the_eager_path(monkeypatch):
    from hvs_tpu_torch.config.model import ModelConfig

    real = ModelConfig.build_model

    def slow_build(self, *a, **k):
        time.sleep(0.3)
        return real(self, *a, **k)

    monkeypatch.setattr(ModelConfig, "build_model", slow_build)
    e = InferenceEngine(port_model_config(), port_inference_config())
    e.infer(_image(1, (37, 53)))
    e.register_raw_shape(RAW_HW)
    e.infer(_image(2))
    stats = e.get_performance_stats()
    assert stats["load_seconds"] >= 0.3  # the model's build is set-up
    assert stats["eager_batches"] == 1
    assert (stats["captures"], stats["capture_seconds"]) == (0, 0.0)  # the CPU captures none


# ---------------- the benchmark's readers, on hand-made inputs ----------------


def _metric(name):
    from perfbench.run import load_file

    return load_file(ROOT / "perfbench" / "metrics" / f"{name}.py")


MS = 1_000_000
T0 = 1_700_000_000_000_000_000  # the profiler's clock: Unix-epoch ns


def _span(name, start_ms, end_ms, sid, parent=None):
    return (name, T0 + int(start_ms * MS), T0 + int(end_ms * MS), sid, parent, 1)


def _engine(spans=(), stats=None):
    return SimpleNamespace(spans=SimpleNamespace(spans=lambda: list(spans)),
                           get_performance_stats=lambda: dict(stats or {}))


def _device_op(start_ms, end_ms, name="kernel", annotation=False):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: T0 + int(start_ms * MS),
                           duration_ns=lambda: int((end_ms - start_ms) * MS),
                           device_type=lambda: torch.autograd.DeviceType.CUDA,
                           is_user_annotation=lambda: annotation)


def _run(engine, events=None, window_s=0.1):
    trace = summary = None
    if events is not None:
        results = SimpleNamespace(events=lambda: events, trace_start_ns=lambda: T0)
        trace = SimpleNamespace(prof=SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=results)))
        summary = SimpleNamespace(window_s=window_s)
    return SimpleNamespace(engine=engine, trace=trace, summary=summary)


# Two batches: stage 3 and 5 ms, ring wait 1 and 0, postprocess 2 and 4.
SERVE = [_span("engine.dispatch", 0, 10, 1), _span("engine.ring_wait", 0, 1, 2, 1),
         _span("engine.stage", 1, 4, 3, 1), _span("engine.launch", 4, 9, 4, 1),
         _span("engine.dispatch", 20, 30, 5), _span("engine.ring_wait", 20, 20, 6, 5),
         _span("engine.stage", 20, 25, 7, 5), _span("engine.launch", 25, 29, 8, 5),
         _span("engine.finalize", 40, 46, 9, 1), _span("engine.postprocess", 44, 46, 10, 9),
         _span("engine.finalize", 50, 60, 11, 5), _span("engine.postprocess", 56, 60, 12, 11)]
# Twenty requests queued 1 ms, 2 ms, ... 20 ms: the nearest rank of 95 % is the 19th.
QUEUED = [_span("request.queued", 0, k, 100 + k, 1) for k in range(1, 21)]
# Window 0-100 ms. The first batch (launch ends 10 ms) holds requests from 2
# and 5 ms; the second (launch ends 40 ms) one from 30 ms; the third (launch
# ends 110 ms, past the window) one from 95 ms. The card runs 0-3, 6-8 (and an annotation 3-6,
# not an operation), 31-35 and 98-99. Held: 2-10, 30-40, 95-100 = 23 ms;
# of it busy 2-3, 6-8, 31-35, 98-99 = 8 ms; held and idle 15 ms of 100.
FLEET = [_span("engine.dispatch", 10, 10.5, 1), _span("engine.launch", 9, 10, 2, 1),
         _span("engine.dispatch", 38, 40, 3), _span("engine.launch", 39, 40, 4, 3),
         _span("engine.dispatch", 108, 110, 5), _span("engine.launch", 109, 110, 6, 5),
         _span("request.queued", 2, 10, 7, 1), _span("request.queued", 5, 10, 8, 1),
         _span("request.queued", 30, 38, 9, 3), _span("request.queued", 95, 108, 10, 5)]
DEVICE = [_device_op(0, 3), _device_op(6, 8), _device_op(3, 6, "hvs.engine.launch", True),
          _device_op(7, 8), _device_op(31, 35), _device_op(98, 99)]
STATS = {"capture_seconds": 4.25, "load_seconds": 2.5}


@pytest.mark.parametrize("metric,run,want", [
    ("stage_ms_per_batch", _run(_engine(SERVE)), 4.0),
    ("ring_wait_ms_per_batch", _run(_engine(SERVE)), 0.5),
    ("postprocess_ms_per_batch", _run(_engine(SERVE)), 3.0),
    ("queue_wait_ms", _run(_engine(QUEUED)), 19.0),
    ("idle_queued_share", _run(_engine(FLEET), DEVICE), 15.0),
    ("capture_s", _run(_engine(stats=STATS)), 4.25),
    ("load_s", _run(_engine(stats=STATS)), 2.5),
])
def test_each_metric_reads_its_hand_worked_value(metric, run, want):
    assert _metric(metric).read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["stage_ms_per_batch", "ring_wait_ms_per_batch",
                                    "postprocess_ms_per_batch", "queue_wait_ms",
                                    "idle_queued_share", "capture_s", "load_s"])
def test_each_metric_reads_none_where_its_input_is_missing(metric):
    read = _metric(metric).read
    # An engine without spans or these counters (the program before them), no
    # engine, no trace, a trace with no operation on the card.
    bare = SimpleNamespace(get_performance_stats=lambda: {"count": 0})
    runs = [_run(bare, []), _run(None), _run(_engine(), []), _run(_engine(SERVE[:1]), [])]
    if metric == "idle_queued_share":
        runs += [_run(_engine(FLEET)), _run(_engine(FLEET), [])]
    for run in runs:
        assert read(run) is None, run


# One traced run of each generator over a cut configuration, in a process of
# its own: the harness refuses to run where JAX is loaded, as it is here.
CUT_RUN = """
import json, sys
import torch
from perfbench import run as bench_run
from perfbench.tests.conftest import load_traffic, tiny_config

bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
names = set(sys.argv[1:])
entries = [dict(m, workloads=["tiny"]) for m in bench["per_layer"] if m["name"] in names]
assert len(entries) == len(names), entries
cfg = dict(tiny_config(), candidates_per_frame=120)
checked = {"check": "detections", "limits": load_traffic("serve_b16_720p")["limits"],
           "floors": {"frames": 1, "detections": 1}}
mixes = {"closed_batches": {"batch": 2, "pool": 4, "sample": 8},
         "open_cameras": {"buckets": [1, 2], "phases": [0.1, 0.6], "fps": 8,
                          "jitter_ms": 2.0, "pool": 4, "sample": 8}}
out = {}
for generator, mix in mixes.items():
    mix = dict(mix, generator=generator, frame_h=48, frame_w=80, image_size=64, **checked)
    line, _ = bench_run.execute(dict(bench, per_layer=entries),
                                {"name": "tiny", "config": "tiny", "traffic": "tiny",
                                 "chips": 1}, 3000000019, 0.6, 1, torch.device("cpu"),
                                cfg=cfg, traffic=mix)
    out[generator] = {"correct": line["correct"],
                      "metrics": {k: v["value"] for k, v in line["metrics"].items()}}
print(json.dumps(out))
"""


def test_a_traced_cut_run_reads_the_new_metrics_on_the_cpu():
    """The benchmark's harness, traced, over a cut configuration on the CPU:
    the span readers find the engine's spans (the card's metric reads
    nothing here)."""
    names = ["stage_ms_per_batch.serve", "ring_wait_ms_per_batch.serve",
             "postprocess_ms_per_batch.serve", "queue_wait_ms.fleet", "capture_s.setup",
             "load_s.setup", "idle_queued_share.fleet"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", CUT_RUN, *names], capture_output=True,
                          text=True, timeout=600, env=env, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    read = json.loads(done.stdout.strip().splitlines()[-1])
    closed, fleet = read["closed_batches"], read["open_cameras"]
    assert closed["correct"] and fleet["correct"]
    closed, fleet = closed["metrics"], fleet["metrics"]
    assert set(closed) == set(names[:3] + names[4:6])
    assert closed["stage_ms_per_batch.serve"] > 0 and closed["load_s.setup"] > 0
    assert closed["capture_s.setup"] == 0.0  # the CPU captures no graph
    assert set(fleet) == set(names[:6])
    assert fleet["queue_wait_ms.fleet"] >= 0
