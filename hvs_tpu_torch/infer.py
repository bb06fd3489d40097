"""Detection inference on images, a directory, a video, a webcam or the
synthetic camera, through the port's ``InferenceEngine``.

Counterpart of ``scripts/inference.py`` with its flags, plus ``--device``.
Writes ``results.json`` into ``--output`` (the per-source results and the
engine's performance stats) and prints a one-line JSON summary. Runs on the
card unless ``--device cpu`` is given::

    python -m hvs_tpu_torch.infer --image path.jpg --output out/
    python -m hvs_tpu_torch.infer --source synthetic --frames 30
    python -m hvs_tpu_torch.infer --video clip.avi --annotated out.mp4
    python -m hvs_tpu_torch.infer --tiny --device cpu --source synthetic

``--checkpoint`` reads the port trainer's checkpoints (a checkpoint of the
JAX package is converted first by ``scripts/torch_import_checkpoint.py``).
``main(argv)`` runs in-process and returns an :class:`InferRun`.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run detection inference (PyTorch/CUDA port)")
    p.add_argument("--image", default=None)
    p.add_argument("--dir", default=None, help="directory of images")
    p.add_argument("--video", default=None)
    p.add_argument("--source", default=None, help="webcam index or 'synthetic'")
    p.add_argument("--frames", type=int, default=30, help="max frames for streams")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--config", default=None, help="inference YAML")
    p.add_argument("--output", default="inference_results")
    p.add_argument("--annotated", default=None, help="annotated output path")
    p.add_argument("--score-threshold", type=float, default=None)
    p.add_argument("--tiny", action="store_true", help="tiny model (smoke/CI)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_engine(args: argparse.Namespace):
    from .config import InferenceConfig, ModelConfig, from_dict
    from .config.base import _read
    from .export_model import tiny_configs
    from .inference import InferenceEngine

    # The device comes from --device only (a config file's is ignored).
    device = args.device or "auto"
    data = _read(args.config) if args.config else {}
    icfg = from_dict(InferenceConfig, {**data, "device": device})
    if args.checkpoint:
        icfg.checkpoint_path = args.checkpoint
    if args.score_threshold is not None:
        icfg.postprocessing.score_threshold = args.score_threshold
    mcfg = ModelConfig(device=device)
    if args.tiny:
        tiny_configs(mcfg, icfg, 64)
        icfg.postprocessing.score_threshold = (
            args.score_threshold if args.score_threshold is not None else 0.01)
    return InferenceEngine(mcfg, icfg)


def process_image(engine, path: str, args: argparse.Namespace, visualizer) -> Dict[str, Any]:
    """One image file: decode (timed) and detect; optionally draw."""
    import cv2

    t0 = time.perf_counter()
    image = cv2.imread(path)
    t_load = time.perf_counter() - t0
    det = engine.infer(image)
    result = {
        "file": path,
        "num_detections": len(det),
        "detections": det.to_dict(),
        "timing_ms": {"load": t_load * 1e3, "infer_e2e": det.latency_ms},
    }
    if args.annotated:
        drawn = visualizer.draw_detections(image, det.boxes, det.scores, det.classes)
        out_path = (args.annotated if args.image
                    else os.path.join(args.annotated, os.path.basename(path)))
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        cv2.imwrite(out_path, drawn)
        result["annotated"] = out_path
    return result


def make_pipeline(engine, source):
    """A ``CompleteInferencePipeline`` around an existing engine (no second
    model build)."""
    from .data.streaming import RoboticCameraStream, StreamConfig, StreamType
    from .inference import (CompleteInferencePipeline, DetectionTracker, DetectionVisualizer,
                            PerformanceMonitor)

    pipe = CompleteInferencePipeline.__new__(CompleteInferencePipeline)
    pipe.engine = engine
    pipe.visualizer = DetectionVisualizer(class_names=engine.class_names)
    pipe.perf = PerformanceMonitor()
    pipe.tracker = DetectionTracker()
    stype = StreamType.SYNTHETIC if source == "synthetic" else (
        StreamType.USB if isinstance(source, int) else StreamType.FILE)
    pipe.camera = RoboticCameraStream(
        StreamConfig(source=source, stream_type=stype, target_fps=30.0))
    pipe.robot = None
    pipe.command_handler = None
    return pipe


@dataclass
class InferRun:
    """What one run produced: the engine, the per-source results, the
    printed summary and the path of ``results.json``."""

    engine: Any
    results: List[Dict[str, Any]]
    summary: Dict[str, Any]
    results_file: str


def main(argv: Optional[Sequence[str]] = None) -> InferRun:
    args = parse_args(argv)
    if not (args.image or args.dir or args.video or args.source is not None):
        print("nothing to do: pass --image/--dir/--video/--source", file=sys.stderr)
        sys.exit(2)
    engine = build_engine(args)
    engine.warmup()  # capture the buckets before any timed frame
    from .inference import DetectionVisualizer

    visualizer = DetectionVisualizer(class_names=engine.class_names)
    os.makedirs(args.output, exist_ok=True)
    results: List[Dict[str, Any]] = []

    if args.image:
        results.append(process_image(engine, args.image, args, visualizer))
    elif args.dir:
        paths = sorted(sum((glob.glob(os.path.join(args.dir, e))
                            for e in ("*.jpg", "*.jpeg", "*.png")), []))
        for path in paths:
            results.append(process_image(engine, path, args, visualizer))
    elif args.video:
        pipe = make_pipeline(engine, "synthetic")
        summary = pipe.process_video(args.video, args.annotated, args.frames)
        results.append({"video": args.video, **summary})
    else:
        source = args.source if args.source == "synthetic" else int(args.source)
        pipe = make_pipeline(engine, source)
        summary = pipe.run_realtime(max_frames=args.frames)
        pipe.shutdown()
        results.append({"source": args.source, **summary})

    out_path = os.path.join(args.output, "results.json")
    stats = engine.get_performance_stats()
    with open(out_path, "w") as f:
        json.dump({"results": results, "performance": stats}, f, indent=2, default=float)
    summary = {
        "processed": len(results),
        "total_detections": sum(r.get("num_detections", 0) for r in results),
        "mean_latency_ms": stats.get("mean_latency_ms"),
        "results_file": out_path,
    }
    print(json.dumps(summary, default=float))
    return InferRun(engine=engine, results=results, summary=summary, results_file=out_path)


if __name__ == "__main__":
    main()
