"""Evaluation and serving metrics, in numpy.

Counterpart of ``hvs_tpu/utils/metrics.py`` (copied):

  * ``DetectionEvaluator``: COCO-style detection AP without pycocotools
    (mAP@0.5, mAP@[.5:.95], AP@0.5 by size bucket, per class);
  * ``StabilityMetrics``: a composite 0-1 stability score from gradient,
    eigenvalue, Sinkhorn and activation sub-scores;
  * ``InferenceMetrics``: the serving engine's latency, percentiles and
    frame rates.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes: [N, 4] x [M, 4] -> [N, M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


@dataclass
class _ImageRecord:
    pred_boxes: np.ndarray
    pred_scores: np.ndarray
    pred_classes: np.ndarray
    gt_boxes: np.ndarray
    gt_classes: np.ndarray


class DetectionEvaluator:
    """COCO-style AP evaluator: all-point PR-curve AP per class, mAP@0.5,
    mAP@[.5:.95] and AP@0.5 per COCO size bucket.

    Usage: ``add_image`` per image with numpy arrays, then ``evaluate()``.
    Boxes are xyxy in any consistent coordinate space.
    """

    AREA_RANGES = {
        "all": (0.0, float("inf")),
        "small": (0.0, 32.0**2),
        "medium": (32.0**2, 96.0**2),
        "large": (96.0**2, float("inf")),
    }

    def __init__(self, num_classes: int = 80,
                 iou_thresholds: Optional[Sequence[float]] = None):
        self.num_classes = num_classes
        self.iou_thresholds = (
            np.asarray(iou_thresholds)
            if iou_thresholds is not None
            else np.arange(0.5, 1.0, 0.05)
        )
        self.records: List[_ImageRecord] = []

    def add_image(
        self,
        pred_boxes, pred_scores, pred_classes,
        gt_boxes, gt_classes,
    ) -> None:
        self.records.append(
            _ImageRecord(
                np.asarray(pred_boxes, np.float32).reshape(-1, 4),
                np.asarray(pred_scores, np.float32).reshape(-1),
                np.asarray(pred_classes, np.int64).reshape(-1),
                np.asarray(gt_boxes, np.float32).reshape(-1, 4),
                np.asarray(gt_classes, np.int64).reshape(-1),
            )
        )

    def reset(self) -> None:
        self.records.clear()

    # ------------------------------------------------------------------
    def _class_ap(self, cls: int, iou_t: float, area: str = "all") -> Optional[float]:
        """AP for one class at one IoU threshold via the all-point PR integral."""
        lo, hi = self.AREA_RANGES[area]
        scores, matches = [], []
        n_gt = 0
        for rec in self.records:
            gmask = rec.gt_classes == cls
            gboxes_all = rec.gt_boxes[gmask]
            if area != "all" and len(gboxes_all):
                ar = (gboxes_all[:, 2] - gboxes_all[:, 0]) * (
                    gboxes_all[:, 3] - gboxes_all[:, 1]
                )
                in_range = (ar >= lo) & (ar < hi)
                gboxes = gboxes_all[in_range]
                ignored_gt = gboxes_all[~in_range]
            else:
                gboxes = gboxes_all
                ignored_gt = np.zeros((0, 4), np.float32)
            n_gt += len(gboxes)
            pmask = rec.pred_classes == cls
            pboxes = rec.pred_boxes[pmask]
            pscores = rec.pred_scores[pmask]
            order = np.argsort(-pscores)
            pboxes, pscores = pboxes[order], pscores[order]
            iou = _iou_matrix(pboxes, gboxes)
            # COCO semantics: a prediction matching an out-of-size-range GT is
            # IGNORED for this bucket, not counted as a false positive.
            iou_ignored = _iou_matrix(pboxes, ignored_gt)
            taken = np.zeros(len(gboxes), bool)
            for i in range(len(pboxes)):
                best_j, best_iou = -1, iou_t
                for j in range(len(gboxes)):
                    if not taken[j] and iou[i, j] >= best_iou:
                        best_iou, best_j = iou[i, j], j
                if best_j >= 0:
                    taken[best_j] = True
                    matches.append(1)
                    scores.append(pscores[i])
                elif len(ignored_gt) and iou_ignored[i].max() >= iou_t:
                    continue  # ignored — matches a GT outside the bucket
                else:
                    matches.append(0)
                    scores.append(pscores[i])
        if n_gt == 0:
            return None
        if not scores:
            return 0.0
        order = np.argsort(-np.asarray(scores))
        tp = np.asarray(matches)[order]
        fp = 1 - tp
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        # All-point interpolation (COCO style).
        precision = np.maximum.accumulate(precision[::-1])[::-1]
        recall = np.concatenate([[0.0], recall, [recall[-1]]])
        precision = np.concatenate([[precision[0] if len(precision) else 0.0],
                                    precision, [0.0]])
        return float(np.sum(np.diff(recall) * precision[1:]))

    def evaluate(self) -> Dict[str, float]:
        """mAP@0.5, mAP@[.5:.95], per-size AP, the image count, and
        ``per_class_AP@0.5`` ({class: AP} for classes with ground truth)."""
        results: Dict[str, float] = {}
        ap50, ap_all = [], []
        per_class50: Dict[int, float] = {}
        for cls in range(self.num_classes):
            a50 = self._class_ap(cls, 0.5)
            if a50 is not None:
                ap50.append(a50)
                per_class50[cls] = a50
                ap_all.append(
                    np.mean([self._class_ap(cls, t) or 0.0 for t in self.iou_thresholds])
                )
        results["mAP@0.5"] = float(np.mean(ap50)) if ap50 else 0.0
        results["mAP@[.5:.95]"] = float(np.mean(ap_all)) if ap_all else 0.0
        for size in ("small", "medium", "large"):
            aps = [
                a for cls in per_class50
                if (a := self._class_ap(cls, 0.5, size)) is not None
            ]
            # COCO convention: -1 when the bucket contains no ground truth.
            results[f"AP@0.5_{size}"] = float(np.mean(aps)) if aps else -1.0
        results["num_images"] = float(len(self.records))
        results["per_class_AP@0.5"] = per_class50  # type: ignore[assignment]
        return results


class StabilityMetrics:
    """Composite 0-1 stability score: the geometric mean of the gradient,
    eigenvalue, Sinkhorn and activation sub-scores."""

    def __init__(self, window: int = 1000):
        self.window = window
        self.history: Dict[str, deque] = defaultdict(lambda: deque(maxlen=window))

    def update(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            if v is not None and np.isfinite(v):
                self.history[k].append(float(v))

    def _sub_score(self, key: str, threshold: float, invert: bool = False) -> float:
        if not self.history[key]:
            return 1.0
        val = self.history[key][-1]
        ratio = val / threshold
        score = np.clip(1.0 - ratio, 0.0, 1.0) if not invert else np.clip(ratio, 0.0, 1.0)
        return float(score)

    def gradient_score(self) -> float:
        if not self.history["grad_norm"]:
            return 1.0
        arr = np.asarray(self.history["grad_norm"])
        cv = arr.std() / (abs(arr.mean()) + 1e-9)
        return float(np.clip(1.0 - cv / 4.0, 0.0, 1.0))

    def eigenvalue_score(self) -> float:
        return self._sub_score("max_eigenvalue", 1.5)

    def sinkhorn_score(self) -> float:
        return self._sub_score("ds_error_max", 0.05)

    def activation_score(self) -> float:
        if not self.history["signal_ratio_mean"]:
            return 1.0
        val = self.history["signal_ratio_mean"][-1]
        return float(np.clip(1.0 - abs(np.log(max(val, 1e-6))) / 3.0, 0.0, 1.0))

    def composite_score(self) -> float:
        scores = [
            self.gradient_score(),
            self.eigenvalue_score(),
            self.sinkhorn_score(),
            self.activation_score(),
        ]
        return float(np.prod(scores) ** (1.0 / len(scores)))

    def report(self) -> Dict[str, float]:
        return {
            "stability_score": self.composite_score(),
            "gradient_score": self.gradient_score(),
            "eigenvalue_score": self.eigenvalue_score(),
            "sinkhorn_score": self.sinkhorn_score(),
            "activation_score": self.activation_score(),
        }


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
