"""COCO-style detection evaluation: mAP@0.5, mAP@[.5:.95], AP by size, per
class, with the serving engine's latency percentiles and stability report.

Counterpart of ``scripts/evaluate.py``, with its flags and defaults plus
``--device``: each image of a COCO-format split (``COCODataset``) goes
through ``InferenceEngine.infer`` as BGR, as a camera frame would, and its
detections, in the image's own pixels like its ground truth, into
``DetectionEvaluator``. The report has the script's keys (``accuracy``,
``per_class_AP@0.5`` by class name, ``performance``, ``stability``).
``--checkpoint`` reads a checkpoint of the port's trainer (``torch.save``;
its EMA weights unless ``--no-ema``); without one the model keeps its
seeded random init. ``--synthetic`` is the evaluator's self-check: ground
truth fed back as predictions must give mAP@0.5 = 1.0. Runs on the CUDA
card unless ``--device cpu`` is given:

    python -m hvs_tpu_torch.evaluate --data-root data/shapes --split val \\
        --checkpoint runs/device_run/checkpoints/final --image-size 640
    python -m hvs_tpu_torch.evaluate --synthetic --images 8
    python -m hvs_tpu_torch.evaluate --data-root <root> --split val --tiny --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import TYPE_CHECKING, Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np

if TYPE_CHECKING:
    from .data import COCODataset
    from .inference import InferenceEngine


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Evaluate detection accuracy (PyTorch/CUDA port)")
    p.add_argument("--data-root", default="data/coco")
    p.add_argument("--split", default="val2017")
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of the port's trainer (<path> or <path>.pt)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--image-size", type=int, default=416)
    p.add_argument("--output", default="evaluation_results.json")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--num-classes", type=int, default=None,
                   help="model class count (default: from dataset categories)")
    p.add_argument("--no-ema", action="store_true",
                   help="evaluate raw params even if the checkpoint has EMA")
    p.add_argument("--score-threshold", type=float, default=0.05)
    p.add_argument("--synthetic", action="store_true",
                   help="self-check on synthetic data: feeds ground truth as "
                        "predictions, must yield mAP=1.0")
    p.add_argument("--images", type=int, default=8, help="synthetic image count")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def synthetic_self_check(args: argparse.Namespace) -> Dict[str, Any]:
    """Evaluator sanity: ground truth fed back as predictions -> mAP 1.0."""
    from .utils import DetectionEvaluator

    rng = np.random.default_rng(0)
    ev = DetectionEvaluator(num_classes=8)
    for _ in range(args.images):
        n = rng.integers(1, 6)
        x1 = rng.uniform(0, 300, n)
        y1 = rng.uniform(0, 300, n)
        w = rng.uniform(20, 100, n)
        h = rng.uniform(20, 100, n)
        boxes = np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
        cls = rng.integers(0, 8, n)
        ev.add_image(boxes, np.ones(n, np.float32), cls, boxes, cls)
    res = ev.evaluate()
    print(json.dumps({k: v for k, v in res.items() if not isinstance(v, dict)}, indent=2))
    if res["mAP@0.5"] != 1.0:
        raise RuntimeError(f"evaluator self-check failed: mAP@0.5 = {res['mAP@0.5']}")
    return res


def ground_truth(dataset: "COCODataset", i: int):
    """Image ``i``'s boxes (xyxy, the image's pixels) and contiguous classes."""
    anns = dataset.annotations.get(dataset.images[i]["id"], [])
    boxes = np.asarray([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                         a["bbox"][1] + a["bbox"][3]] for a in anns], np.float32).reshape(-1, 4)
    return boxes, np.asarray([a["category_id"] for a in anns], np.int64)


class EvalRun(NamedTuple):
    """What ``run`` evaluated, and how."""

    engine: "InferenceEngine"
    dataset: "COCODataset"
    detections: List[Any]  # the engine's Detections, one per image
    report: Dict[str, Any]
    seconds: float  # the loop over the images: decode, infer, evaluator


def run(args: argparse.Namespace) -> EvalRun:
    """Build the dataset and the engine, run every image through both, and
    return them with the report (``main`` writes it to ``--output``)."""
    from .config import InferenceConfig, ModelConfig
    from .data import COCODataset, load_image
    from .inference import InferenceEngine
    from .utils import DetectionEvaluator

    device = args.device or "auto"
    mcfg = ModelConfig(device=device)
    icfg = InferenceConfig(device=device)
    icfg.preprocessing.image_size = args.image_size
    icfg.postprocessing.score_threshold = args.score_threshold  # low for the AP sweep
    icfg.use_ema = not args.no_ema
    if args.checkpoint:
        icfg.checkpoint_path = args.checkpoint
    if args.tiny:
        mcfg.backbone.stage_channels = (16, 24, 32, 40)
        mcfg.backbone.stage_blocks = (1, 1, 1, 1)
        mcfg.vit.dim = 16
        mcfg.vit.depth = 1
        mcfg.vit.num_heads = 2
        mcfg.fusion.fpn_channels = 16
        mcfg.detection.head_channels = 16
        mcfg.mhc.sinkhorn_iterations = 5
        icfg.preprocessing.image_size = 64

    dataset = COCODataset(
        root=os.path.join(args.data_root, args.split),
        annotation_file=os.path.join(args.data_root, "annotations",
                                     f"instances_{args.split}.json"),
        image_size=args.image_size, max_samples=args.max_images, normalize=False)
    mcfg.detection.num_classes = (args.num_classes if args.num_classes is not None
                                  else len(dataset.class_names))
    engine = InferenceEngine(mcfg, icfg)
    evaluator = DetectionEvaluator(num_classes=len(dataset.class_names))

    detections = []
    t0 = time.perf_counter()
    for i in range(len(dataset)):
        image = load_image(dataset._resolve_path(dataset.images[i]["file_name"]))
        det = engine.infer(image[..., ::-1])  # the engine takes BGR frames
        detections.append(det)
        gt_boxes, gt_cls = ground_truth(dataset, i)
        evaluator.add_image(det.boxes, det.scores, det.classes, gt_boxes, gt_cls)
    seconds = time.perf_counter() - t0

    accuracy = evaluator.evaluate()
    per_class = accuracy.get("per_class_AP@0.5", {})
    names = dataset.class_names
    report = {
        "accuracy": {k: v for k, v in accuracy.items() if not isinstance(v, dict)},
        "per_class_AP@0.5": {names[c] if c < len(names) else str(c): v
                             for c, v in sorted(per_class.items())},
        "performance": engine.get_performance_stats(),
        "stability": engine.get_stability_report(),
    }
    return EvalRun(engine, dataset, detections, report, seconds)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    if args.synthetic:
        return synthetic_self_check(args)
    report = run(args).report
    with open(args.output, "w") as f:
        json.dump(report, f, indent=2, default=float)
    perf = report["performance"]
    print(json.dumps(report["accuracy"], indent=2))
    print(f"p95 latency: {perf.get('p95_latency_ms', 0):.1f} ms, "
          f"fps: {perf.get('fps', 0):.1f}")
    return report


if __name__ == "__main__":
    main()
