"""Where the time of the serving engine's bucket graphs goes, on one CUDA card.

    python3 scripts/torch_engine_profile.py [--buckets 1 16] [--reps 20]

Builds ``InferenceEngine`` with the full-width flagship at 640² (seeded
weights with the prediction convs conditioned as in ``chip_smoke.py``, so the
NMS has candidates), captures its letterboxed graph per bucket, and prints,
per bucket, device ms (CUDA events around ``--reps`` replays, median of 3) of:

  * ``graph``: one replay of the bucket's serve graph (normalize, forward,
    decode, NMS, pack);
  * ``forward``: the model forward alone, captured the same way;
  * ``postprocess``: decode's output through the class-aware NMS and the
    pack, captured alone (all ``pre_nms_top_k`` fixed-point sweeps);
  * the same postprocess run eagerly, stopping at its fixed point: the
    sweeps it took, and its wall ms on the host clock;

then ``torch.profiler``'s device time by kernel category over one replay of
the largest bucket, beside the card's name and power limit. Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def graph_ms(fn, stream, reps: int) -> float:
    """Device ms of one call of ``fn`` captured in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    with torch.cuda.stream(side), torch.inference_mode():
        for _ in range(3):
            fn()
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(graph, stream=stream):
        fn()
    return replay_ms(graph, stream, reps)


def replay_ms(graph, stream, reps: int) -> float:
    """Device ms of one replay of ``graph``: ``reps`` replays between CUDA
    events, median of 3 trials."""
    times = []
    with torch.cuda.stream(stream):
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record(stream)
            for _ in range(reps):
                graph.replay()
            b.record(stream)
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    import chip_smoke as c
    from hvs_tpu_torch import build
    from hvs_tpu_torch.config import InferenceConfig, ModelConfig
    from hvs_tpu_torch.inference import InferenceEngine
    from hvs_tpu_torch.models.yolo_head import postprocess_detections
    from hvs_tpu_torch.ops import nms as nms_mod
    from torch_serve_profile import summarize  # same directory

    card = c.card_line()
    build.build(["mhc_block", "sinkhorn"])
    cfg = InferenceConfig()
    cfg.preprocessing.image_size = c.IMAGE
    cfg.performance.batch_buckets = tuple(sorted(args.buckets))
    engine = InferenceEngine(ModelConfig(), cfg, variables={"params": c.conditioned_params(0)})
    engine.warmup()
    pp, stream = cfg.postprocessing, engine._stream
    r = np.random.default_rng(0)
    for b in cfg.performance.batch_buckets:
        entry = engine._serve_fn(b)
        frames = list(r.integers(0, 256, (b, c.IMAGE, c.IMAGE, 3), dtype=np.uint8))
        with engine._serve_lock, torch.cuda.stream(stream):
            entry.stage(frames, stream)
            torch.cuda.synchronize()
            x = (entry.static_in.float() / 255.0 - engine._mean) / engine._std
            with torch.inference_mode():
                head = engine.model(x)["detection"]
            rows = {"graph": replay_ms(entry.graph, stream, args.reps),
                    "forward": graph_ms(lambda: engine.model(x), stream, args.reps),
                    "postprocess": graph_ms(
                        lambda: postprocess_detections(head, pp.score_threshold,
                                                       pp.iou_threshold, pp.max_detections,
                                                       pp.pre_nms_top_k), stream, args.reps)}
            sweeps = [0]
            fixed_point = nms_mod._greedy_fixed_point

            def counting(suppress, valid):
                sweeps[0] = 0
                real_equal = torch.equal

                def equal(a, b):
                    sweeps[0] += 1
                    return real_equal(a, b)

                torch.equal = equal
                try:
                    return fixed_point(suppress, valid)
                finally:
                    torch.equal = real_equal

            nms_mod._greedy_fixed_point = counting
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.inference_mode():
                    det = postprocess_detections(head, pp.score_threshold, pp.iou_threshold,
                                                 pp.max_detections, pp.pre_nms_top_k)
                torch.cuda.synchronize()
                eager_wall_ms = (time.perf_counter() - t0) * 1e3
            finally:
                nms_mod._greedy_fixed_point = fixed_point
        print(json.dumps({"bucket": b, "image": c.IMAGE, "device_ms": rows,
                          "nms_sweeps_to_fixed_point": sweeps[0],
                          "postprocess_eager_wall_ms": eager_wall_ms,
                          "nms_sweeps_captured": pp.pre_nms_top_k,
                          "detections": int(det.num_valid.sum()), "card": card}), flush=True)

    b = max(cfg.performance.batch_buckets)
    entry = engine._serve_fn(b)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with engine._serve_lock, torch.cuda.stream(stream):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            entry.graph.replay()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    summarize(prof, 1, wall_ms, card, {"bucket": b, "image": c.IMAGE}, "replay")


if __name__ == "__main__":
    main()
