"""Detection postprocessing: host orchestration around on-device NMS + tracking.

Counterpart of ``hvs_tpu/inference/postprocessing.py``, numpy on the host.
The NMS itself runs on the card inside the engine's serve graphs
(``hvs_tpu_torch.ops.nms``); this module covers everything around it:

  * :class:`DetectionPostprocessor` — output-format extraction, scale-weighted
    fusion, temperature calibration, validity filtering, coordinate scaling,
    and tracker hookup (reference pipeline :114-426).
  * :class:`NMSFilter` — standalone NMS API (hard, soft and matrix, through
    the port's ``ops.nms`` on CPU tensors) with a numpy greedy fallback for
    host-only use.
  * :class:`DetectionTracker` — IoU tracker with track age / min-hits and
    3-frame box smoothing (reference built-in tracker :850-1119).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def _assign(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimum-cost assignment: Hungarian via scipy when available, else a
    greedy cheapest-pair sweep (scipy is an optional dependency here — it is
    used nowhere else in the package)."""
    try:
        from scipy.optimize import linear_sum_assignment
    except ImportError:
        order = np.dstack(np.unravel_index(np.argsort(cost, axis=None),
                                           cost.shape))[0]
        rows, cols, used_r, used_c = [], [], set(), set()
        for ti, di in order:
            if ti in used_r or di in used_c:
                continue
            rows.append(ti)
            cols.append(di)
            used_r.add(ti)
            used_c.add(di)
        return np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    return linear_sum_assignment(cost)


def _np_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


class NMSFilter:
    """Standalone NMS with the hard, soft and matrix methods
    (``iou_threshold`` applies to hard only, as in the reference)."""

    def __init__(self, method: str = "hard", iou_threshold: float = 0.45,
                 score_threshold: float = 0.25, max_detections: int = 100):
        if method not in ("hard", "soft", "matrix"):
            raise ValueError(f"unknown NMS method: {method!r}")
        self.method = method
        self.iou_threshold = iou_threshold
        self.score_threshold = score_threshold
        self.max_detections = max_detections

    def apply(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray):
        """NMS on numpy inputs (CPU tensors); returns filtered numpy arrays."""
        import torch

        from ..ops.nms import NMS_METHODS

        b = torch.as_tensor(np.asarray(boxes, np.float32)).reshape(-1, 4)
        s = torch.as_tensor(np.asarray(scores, np.float32)).reshape(-1)
        c = torch.as_tensor(np.asarray(classes, np.int32)).reshape(-1)
        kwargs = dict(score_threshold=self.score_threshold,
                      max_detections=self.max_detections,
                      pre_nms_top_k=min(512, max(len(s), 1)))
        if self.method == "hard":
            kwargs["iou_threshold"] = self.iou_threshold
        r = NMS_METHODS[self.method](b, s, c, **kwargs)
        k = int(r.num_valid)
        return r.boxes[:k].numpy(), r.scores[:k].numpy(), r.classes[:k].numpy()

    @staticmethod
    def greedy_numpy(boxes, scores, iou_threshold=0.45):
        """Pure-numpy greedy NMS (host fallback / oracle)."""
        order = np.argsort(-scores)
        keep = []
        while len(order):
            i = order[0]
            keep.append(i)
            if len(order) == 1:
                break
            rest = order[1:]
            iou = _np_iou(boxes[i : i + 1], boxes[rest])[0]
            order = rest[iou <= iou_threshold]
        return np.asarray(keep, np.int64)


@dataclass
class Track:
    track_id: int
    box: np.ndarray  # xyxy
    score: float
    class_id: int
    hits: int = 1
    age: int = 0
    history: List[np.ndarray] = field(default_factory=list)

    def smoothed_box(self, window: int = 3) -> np.ndarray:
        recent = self.history[-window:] or [self.box]
        return np.mean(recent, axis=0)


class DetectionTracker:
    """IoU tracker with age/min-hits and 3-frame smoothing
    (reference: DetectionTracker, src/inference/postprocessing.py:850-1119)."""

    def __init__(self, iou_threshold: float = 0.3, max_age: int = 5, min_hits: int = 2):
        self.iou_threshold = iou_threshold
        self.max_age = max_age
        self.min_hits = min_hits
        self.tracks: List[Track] = []
        self._next_id = itertools.count(1)

    def update(self, boxes: np.ndarray, scores: np.ndarray, classes: np.ndarray
               ) -> List[Track]:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        matched_tracks: set = set()
        matched_dets: set = set()
        if self.tracks and len(boxes):
            track_boxes = np.stack([t.box for t in self.tracks])
            iou = _np_iou(track_boxes, boxes)
            # Greedy matching by IoU, class-consistent.
            pairs = sorted(
                ((iou[ti, di], ti, di)
                 for ti in range(len(self.tracks)) for di in range(len(boxes))),
                reverse=True,
            )
            for score_iou, ti, di in pairs:
                if score_iou < self.iou_threshold:
                    break
                if ti in matched_tracks or di in matched_dets:
                    continue
                if self.tracks[ti].class_id != int(classes[di]):
                    continue
                t = self.tracks[ti]
                t.box = boxes[di]
                t.score = float(scores[di])
                t.hits += 1
                t.age = 0
                t.history.append(boxes[di])
                matched_tracks.add(ti)
                matched_dets.add(di)

        # New tracks for unmatched detections.
        for di in range(len(boxes)):
            if di not in matched_dets:
                self.tracks.append(
                    Track(
                        track_id=next(self._next_id),
                        box=boxes[di],
                        score=float(scores[di]),
                        class_id=int(classes[di]),
                        history=[boxes[di]],
                    )
                )
        # Age unmatched pre-existing tracks; newly appended tracks stay age 0.
        n_new = sum(1 for di in range(len(boxes)) if di not in matched_dets)
        for ti in range(len(self.tracks) - n_new):
            if ti not in matched_tracks:
                self.tracks[ti].age += 1
        self.tracks = [t for t in self.tracks if t.age <= self.max_age]
        return [t for t in self.tracks if t.hits >= self.min_hits]

    def reset(self) -> None:
        self.tracks.clear()


class AppearanceTracker:
    """DeepSORT-style tracker: appearance embeddings + IoU gating + Hungarian
    assignment (reference attempts SORT/DeepSORT with an IoU fallback,
    src/inference/postprocessing.py:850-1119; here the embedding is the
    engine's device-side ROI feature — ``Detections.embeddings`` via
    ``PostprocessingConfig.return_embeddings`` — so no second network runs).

    Cost = ``appearance_weight * cosine_distance + (1 - w) * (1 - IoU)``;
    pairs are gated out when the cosine distance exceeds ``max_cosine_distance``
    AND IoU is below ``iou_gate`` (either signal can rescue a match — occluded
    re-appearances match on appearance, embedding drift matches on motion).
    Track embeddings update by EMA. Falls back to pure-IoU greedy matching
    when detections carry no embeddings.
    """

    def __init__(
        self,
        max_cosine_distance: float = 0.35,
        iou_gate: float = 0.2,
        appearance_weight: float = 0.6,
        embedding_momentum: float = 0.8,
        max_age: int = 10,
        min_hits: int = 2,
    ):
        self.max_cosine_distance = max_cosine_distance
        self.iou_gate = iou_gate
        self.appearance_weight = appearance_weight
        self.momentum = embedding_momentum
        self.max_age = max_age
        self.min_hits = min_hits
        self.tracks: List[Track] = []
        # track_id -> L2-normalized embedding, or None for tracks created on
        # an embedding-less (fallback) frame; None means "no appearance signal
        # yet" and is treated as max cosine distance in the cost matrix.
        self._embeddings: Dict[int, Optional[np.ndarray]] = {}
        self._next_id = itertools.count(1)
        self._iou_fallback = DetectionTracker(max_age=max_age, min_hits=min_hits)
        # One shared ID counter: independent counters would mint duplicate
        # track_ids across the fallback and appearance paths and silently
        # cross-contaminate self._embeddings.
        self._iou_fallback._next_id = self._next_id

    def update(
        self,
        boxes: np.ndarray,
        scores: np.ndarray,
        classes: np.ndarray,
        embeddings: Optional[np.ndarray] = None,
    ) -> List[Track]:
        if embeddings is None:
            # Mirror the reference's graceful degradation to the IoU tracker.
            self._iou_fallback.tracks = self.tracks
            out = self._iou_fallback.update(boxes, scores, classes)
            self.tracks = self._iou_fallback.tracks
            # Seed placeholder embeddings for tracks the fallback created so a
            # later embedding frame doesn't KeyError.
            for t in self.tracks:
                self._embeddings.setdefault(t.track_id, None)
            return out
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        emb = np.asarray(embeddings, np.float32)
        if len(boxes):
            emb = emb.reshape(len(boxes), -1)
            emb = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-6)

        matched_tracks: set = set()
        matched_dets: set = set()
        if self.tracks and len(boxes):
            track_boxes = np.stack([t.box for t in self.tracks])
            dim = emb.shape[-1]
            # None placeholder (track born on a fallback frame) -> zero vector
            # -> cosine distance 1.0: no appearance signal, IoU can still match.
            track_emb = np.stack([
                e if (e := self._embeddings.get(t.track_id)) is not None
                else np.zeros(dim, np.float32)
                for t in self.tracks
            ])
            iou = _np_iou(track_boxes, boxes)
            cos_dist = 1.0 - track_emb @ emb.T  # [T, D]
            cost = (
                self.appearance_weight * cos_dist
                + (1.0 - self.appearance_weight) * (1.0 - iou)
            )
            # Gate: a pair is inadmissible only when BOTH signals fail.
            gate = (cos_dist > self.max_cosine_distance) & (iou < self.iou_gate)
            # Class consistency.
            track_cls = np.asarray([t.class_id for t in self.tracks])
            gate |= track_cls[:, None] != np.asarray(classes)[None, :]
            BIG = 1e6
            cost = np.where(gate, BIG, cost)
            for ti, di in zip(*_assign(cost)):
                if cost[ti, di] >= BIG:
                    continue
                t = self.tracks[ti]
                t.box = boxes[di]
                t.score = float(scores[di])
                t.hits += 1
                t.age = 0
                t.history.append(boxes[di])
                tid = t.track_id
                prev = self._embeddings.get(tid)
                if prev is None:
                    self._embeddings[tid] = emb[di]
                else:
                    mixed = (
                        self.momentum * prev
                        + (1.0 - self.momentum) * emb[di]
                    )
                    self._embeddings[tid] = mixed / (np.linalg.norm(mixed) + 1e-6)
                matched_tracks.add(ti)
                matched_dets.add(di)

        for di in range(len(boxes)):
            if di not in matched_dets:
                tid = next(self._next_id)
                self.tracks.append(
                    Track(
                        track_id=tid, box=boxes[di], score=float(scores[di]),
                        class_id=int(classes[di]), history=[boxes[di]],
                    )
                )
                self._embeddings[tid] = emb[di]
        n_new = sum(1 for di in range(len(boxes)) if di not in matched_dets)
        for ti in range(len(self.tracks) - n_new):
            if ti not in matched_tracks:
                self.tracks[ti].age += 1
        dead = [t.track_id for t in self.tracks if t.age > self.max_age]
        for tid in dead:
            self._embeddings.pop(tid, None)
        self.tracks = [t for t in self.tracks if t.age <= self.max_age]
        return [t for t in self.tracks if t.hits >= self.min_hits]

    def reset(self) -> None:
        self.tracks.clear()
        self._embeddings.clear()


class DetectionPostprocessor:
    """Host-side postprocessing pipeline
    (reference: DetectionPostprocessor, src/inference/postprocessing.py:114-426).

    The device serve path already yields NMS'd fixed-size detections; this
    class covers the standalone path for raw model outputs (multiple output
    formats), scale-weighted fusion, calibration, filtering, coordinate
    scaling, and tracking.
    """

    def __init__(
        self,
        nms_method: str = "hard",
        score_threshold: float = 0.25,
        iou_threshold: float = 0.45,
        max_detections: int = 100,
        calibration_temperature: float = 1.0,
        min_box_size: float = 2.0,
        max_aspect_ratio: float = 20.0,
        scale_weights: Optional[Dict[str, float]] = None,
        tracking: str = "none",
    ):
        self.nms = NMSFilter(nms_method, iou_threshold, score_threshold, max_detections)
        self.temperature = calibration_temperature
        self.min_box_size = min_box_size
        self.max_aspect_ratio = max_aspect_ratio
        self.scale_weights = scale_weights or {}
        self.tracker = (
            AppearanceTracker() if tracking in ("appearance", "deepsort")
            else DetectionTracker() if tracking != "none" else None
        )

    # ------------------------------------------------------------------
    def extract(self, outputs: Any) -> Tuple[np.ndarray, np.ndarray]:
        """Unify model outputs to (boxes [N,4], scores [N,C])
        (reference: :217-350 handles multiple output formats)."""
        if isinstance(outputs, dict):
            if "detection" in outputs:
                outputs = outputs["detection"]
            boxes = np.asarray(outputs["boxes"], np.float32)
            scores = np.asarray(outputs["scores"], np.float32)
            if boxes.ndim == 3:
                boxes, scores = boxes[0], scores[0]
            return boxes, scores
        if isinstance(outputs, (tuple, list)) and len(outputs) >= 2:
            return np.asarray(outputs[0], np.float32), np.asarray(outputs[1], np.float32)
        raise ValueError(f"unrecognized output format: {type(outputs)}")

    def calibrate(self, scores: np.ndarray) -> np.ndarray:
        """Temperature calibration on confidence (reference: :352-360)."""
        if self.temperature == 1.0:
            return scores
        return scores ** (1.0 / self.temperature)

    def process(
        self,
        outputs: Any,
        image_size: Tuple[int, int] = (416, 416),
        normalized: bool = True,
        embeddings: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """``embeddings`` (optional, [N, D], aligned with the raw detections
        in ``outputs``) feed the appearance tracker when ``tracking=
        "appearance"``; without them the tracker degrades to pure IoU."""
        boxes, scores = self.extract(outputs)
        class_scores = scores.max(-1)
        class_ids = scores.argmax(-1).astype(np.int32)
        class_scores = self.calibrate(class_scores)

        b, s, c = self.nms.apply(boxes, class_scores, class_ids)
        sel_emb: Optional[np.ndarray] = None
        if embeddings is not None and len(b):
            # NMS passes box coordinates through unmodified, so surviving
            # boxes match their raw detections bit-exactly (done BEFORE the
            # image-size scaling below).
            raw = np.asarray(boxes, np.float32).reshape(-1, 4)
            emb = np.asarray(embeddings, np.float32).reshape(len(raw), -1)
            idxs = np.asarray(
                [np.flatnonzero((raw == bb).all(1))[:1].sum() for bb in b],
                np.int64,
            )
            sel_emb = emb[idxs]
        if normalized and len(b):
            h, w = image_size
            b = b * np.array([w, h, w, h], np.float32)
        # Validity filter (reference :362-408).
        if len(b):
            wh = np.stack([b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)
            ar = np.maximum(wh[:, 0], 1e-3) / np.maximum(wh[:, 1], 1e-3)
            keep = (
                (wh > self.min_box_size).all(1)
                & (ar < self.max_aspect_ratio)
                & (ar > 1.0 / self.max_aspect_ratio)
            )
            b, s, c = b[keep], s[keep], c[keep]
            if sel_emb is not None:
                sel_emb = sel_emb[keep]

        result = {"boxes": b, "scores": s, "classes": c}
        if self.tracker is not None:
            if isinstance(self.tracker, AppearanceTracker):
                tracks = self.tracker.update(b, s, c, sel_emb)
            else:
                tracks = self.tracker.update(b, s, c)
            result["track_ids"] = np.asarray([t.track_id for t in tracks], np.int64)
            result["tracked_boxes"] = (
                np.stack([t.smoothed_box() for t in tracks])
                if tracks else np.zeros((0, 4), np.float32)
            )
        return result
