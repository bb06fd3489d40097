"""Fixed-shape, class-aware NMS on tensors: greedy hard NMS, Gaussian soft
NMS and matrix NMS.

Counterpart of ``hvs_tpu/ops/nms.py`` (``NMSResult``, ``nms_fixed``,
``soft_nms_fixed``, ``matrix_nms`` and ``batched_nms`` with its three
methods). Shapes are static: the top ``pre_nms_top_k`` candidates, an [M, M]
IoU matrix, and outputs padded to ``max_detections`` with score -1 and class
-1. Hard NMS finds the greedy result as the unique fixed point of
K <- {j : no kept higher-scored box suppresses j}; soft NMS decays scores in
the candidates' score order; matrix NMS is one masked reduction.

Two deliberate differences from a direct transcription:
  * top-k keeps the lower index first on ties, as ``lax.top_k`` does, through
    a stable descending sort (``torch.topk`` promises no tie order);
  * class-aware suppression masks pairs of different classes (their IoU
    counts as 0, so a soft or matrix decay across classes is exactly 1),
    where the reference shifts boxes by class * 4096 before the IoU. In fp32
    that shift costs IoU precision (from class 8 on for boxes in pixels on a
    half-pixel grid, from class 1 on for normalized boxes); the mask gives the
    exact IoU. The two agree wherever the reference's arithmetic is exact.
Leading batch dimensions are handled directly, so ``batched_nms`` needs no map.

The data-dependent loops (hard NMS's fixed point, soft NMS's pass over the
candidates) stop early when run eagerly. Inside a CUDA graph capture nothing
may wait on the host, and ``torch.export`` cannot trace a check of the data,
so there both run their full M trips; the extra trips change nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .boxes import pairwise_iou


class NMSResult(NamedTuple):
    """Fixed-size NMS output; invalid slots have score -1 and class -1."""

    boxes: torch.Tensor  # [..., K, 4] xyxy
    scores: torch.Tensor  # [..., K]
    classes: torch.Tensor  # [..., K] int32
    valid: torch.Tensor  # [..., K] bool
    num_valid: torch.Tensor  # [...] int32


def top_k_stable(values: torch.Tensor, k: int):
    """The k largest along the last axis, lower index first among equals."""
    s, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return s[..., :k], idx[..., :k]


def _gather_boxes(boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4))


def _full_trips(t: torch.Tensor) -> bool:
    """Whether a data-dependent loop over ``t`` must run its full trip count:
    inside a CUDA graph capture or a ``torch.export`` trace."""
    return torch.compiler.is_exporting() or (t.is_cuda
                                              and torch.cuda.is_current_stream_capturing())


def _greedy_fixed_point(suppress: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy result: the unique fixed point of K <- {j valid : no kept
    i suppresses j}, iterated from K = valid.

    One sweep counts each candidate's kept suppressors in one batched
    product and keeps those with none: ``keep = max(valid - keep @ S, 0)``
    on 0/1 values, exact in fp16 up to 2048 candidates (fp32 on the CPU).
    Eagerly the loop stops at the fixed point (typically a few sweeps; each
    check waits on the device); captured or exported it runs all M sweeps:
    sweeps past the fixed point change nothing, and M bounds the depth of any
    suppression chain.
    """
    m = valid.shape[-1]
    dtype = torch.float16 if valid.is_cuda and m <= 2048 else torch.float32
    supp = suppress.to(dtype).reshape(-1, m, m)
    valid_f = valid.to(dtype).reshape(-1, 1, m)
    keep = valid_f
    if _full_trips(valid):
        for _ in range(m):
            keep = torch.baddbmm(valid_f, keep, supp, alpha=-1).clamp_(min=0)
    else:
        for _ in range(m):
            new = torch.baddbmm(valid_f, keep, supp, alpha=-1).clamp_(min=0)
            if torch.equal(new, keep):
                break
            keep = new
    return (keep > 0).reshape(valid.shape)


def _candidates(boxes, scores, classes, score_threshold: float, pre_nms_top_k: int):
    """Threshold and top-M preselection: (boxes, scores, classes, valid) of
    the candidates in descending score order."""
    masked = torch.where(scores >= score_threshold, scores, -1.0)
    m = min(pre_nms_top_k, scores.shape[-1])
    s, idx = top_k_stable(masked, m)
    return _gather_boxes(boxes, idx), s, torch.gather(classes, -1, idx), s >= score_threshold


def _class_iou(b: torch.Tensor, c: torch.Tensor, class_aware: bool) -> torch.Tensor:
    """Pairwise IoU of the candidates; 0 across classes when class-aware."""
    iou = pairwise_iou(b, b)
    if class_aware:
        iou = torch.where(c[..., :, None] == c[..., None, :], iou, 0.0)
    return iou


def _result(b, c, kept_scores, max_detections: int, keep_above: float,
            inclusive: bool) -> NMSResult:
    """The top ``max_detections`` of ``kept_scores`` (-1 where dropped) as a
    padded ``NMSResult``; a slot is valid when its score is at least
    (``inclusive``) or above ``keep_above``."""
    k = min(max_detections, kept_scores.shape[-1])
    out_scores, out_idx = top_k_stable(kept_scores, k)
    out_valid = out_scores >= keep_above if inclusive else out_scores > keep_above
    pad = max_detections - k
    out_classes = torch.where(out_valid, torch.gather(c, -1, out_idx), -1).to(torch.int32)
    result_valid = F.pad(out_valid, (0, pad), value=False)
    return NMSResult(
        boxes=F.pad(_gather_boxes(b, out_idx), (0, 0, 0, pad)),
        scores=F.pad(torch.where(out_valid, out_scores, -1.0), (0, pad), value=-1.0),
        classes=F.pad(out_classes, (0, pad), value=-1),
        valid=result_valid,
        num_valid=result_valid.sum(dim=-1, dtype=torch.int32),
    )


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    *,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.25,
    max_detections: int = 100,
    pre_nms_top_k: int = 512,
    class_aware: bool = True,
) -> NMSResult:
    """Exact greedy hard NMS with static shapes.

    Args:
        boxes: [..., N, 4] xyxy.
        scores: [..., N] confidence.
        classes: [..., N] integer class ids.
    """
    b, s, c, valid = _candidates(boxes, scores, classes, score_threshold, pre_nms_top_k)
    m = s.shape[-1]
    upper = torch.ones(m, m, dtype=torch.bool, device=boxes.device).triu(1)
    # suppress[..., i, j]: higher-scored i (of the same class) overlaps lower-scored j.
    suppress = (pairwise_iou(b, b) > iou_threshold) & upper
    if class_aware:
        suppress &= c[..., :, None] == c[..., None, :]
    keep = _greedy_fixed_point(suppress, valid)
    return _result(b, c, torch.where(keep, s, -1.0), max_detections, score_threshold,
                   inclusive=True)


def soft_nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    *,
    sigma: float = 0.5,
    score_threshold: float = 0.25,
    final_threshold: float = 0.001,
    max_detections: int = 100,
    pre_nms_top_k: int = 512,
    class_aware: bool = True,
) -> NMSResult:
    """Gaussian soft NMS in the candidates' initial score order (one fixed
    pass, as the reference's): candidate i, while its own decayed score is
    above ``final_threshold``, multiplies each later candidate's score by
    ``exp(-iou^2 / sigma)``. The products are taken in the reference's order
    (i ascending), so the scores agree to fp32 rounding. One trip per
    candidate, three launches each; eagerly the pass stops after the last
    valid candidate (one wait on the device), captured or exported it runs
    all M trips. Slots are valid above ``final_threshold``.
    """
    b, s, c, valid = _candidates(boxes, scores, classes, score_threshold, pre_nms_top_k)
    m = s.shape[-1]
    decay = torch.exp(-(_class_iou(b, c, class_aware) ** 2) / sigma)
    upper = torch.ones(m, m, dtype=torch.bool, device=boxes.device).triu(1)
    factors = torch.where(upper, decay, 1.0)  # row i: what i multiplies into each later j
    cur = torch.where(valid, s, -1.0)
    # The valid candidates are a prefix (sorted, then thresholded): past them
    # nothing is alive, so an eager pass stops there.
    trips = m if _full_trips(cur) else int(valid.sum(dim=-1).max()) if m else 0
    for i in range(trips):
        alive = cur[..., i:i + 1] > final_threshold
        cur = cur * torch.where(alive, factors[..., i, :], 1.0)
    return _result(b, c, torch.where(cur > final_threshold, cur, -1.0), max_detections,
                   final_threshold, inclusive=False)


def matrix_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    *,
    sigma: float = 0.5,
    score_threshold: float = 0.25,
    final_threshold: float = 0.05,
    max_detections: int = 100,
    pre_nms_top_k: int = 512,
    class_aware: bool = True,
) -> NMSResult:
    """Matrix NMS, as the reference computes it: candidate j's score times
    min over higher-scored i of ``exp(-(iou_ij^2 - max_k iou_ik^2) / sigma)``,
    where the max runs over the candidates k scored below i (the reference's
    ``axis=1``). One masked reduction, no loop. Slots are valid above
    ``final_threshold``.

    Kept for parity with the reference, whose compensation term makes every
    factor at least 1: no candidate is suppressed, and overlapped scores can
    grow past 1 (SOLOv2's compensation is the max over the candidates scored
    above i). Recorded in ROADMAP §3.
    """
    b, s, c, valid = _candidates(boxes, scores, classes, score_threshold, pre_nms_top_k)
    m = s.shape[-1]
    upper = torch.ones(m, m, dtype=torch.bool, device=boxes.device).triu(1)
    sup = torch.where(upper, _class_iou(b, c, class_aware), 0.0)
    max_iou = sup.amax(dim=-1)
    decay = torch.exp(-(sup ** 2 - (max_iou ** 2)[..., :, None]) / sigma)
    decay = torch.where(upper, decay, torch.inf).amin(dim=-2)
    decay = torch.where(torch.isfinite(decay), decay, 1.0)
    decayed = torch.where(valid, s * decay, -1.0)
    return _result(b, c, torch.where(decayed > final_threshold, decayed, -1.0),
                   max_detections, final_threshold, inclusive=False)


NMS_METHODS = {"hard": nms_fixed, "soft": soft_nms_fixed, "matrix": matrix_nms}


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                method: str = "hard", **kwargs) -> NMSResult:
    """NMS of ``method`` (hard, soft or matrix) over a leading batch axis:
    ``boxes`` [B, N, 4], ``scores`` and ``classes`` [B, N]."""
    if method not in NMS_METHODS:
        raise ValueError(f"unknown NMS method: {method!r}")
    if boxes.dim() != 3 or scores.dim() != 2 or classes.dim() != 2:
        raise ValueError(f"batched_nms takes [B, N, 4], [B, N], [B, N]; got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(classes.shape)}")
    return NMS_METHODS[method](boxes, scores, classes, **kwargs)
