"""Fixed-shape, class-aware greedy NMS on tensors.

Counterpart of ``hvs_tpu/ops/nms.py`` (``NMSResult``, ``nms_fixed``,
``batched_nms`` with the hard method). Shapes are static: the top
``pre_nms_top_k`` candidates, an [M, M] IoU matrix, the greedy result found
as the unique fixed point of K <- {j : no kept higher-scored box suppresses j},
and outputs padded to ``max_detections`` with score -1 and class -1.

Two deliberate differences from a direct transcription:
  * top-k keeps the lower index first on ties, as ``lax.top_k`` does, through
    a stable descending sort (``torch.topk`` promises no tie order);
  * class-aware suppression masks pairs of different classes, where the
    reference shifts boxes by class * 4096 before the IoU. In fp32 that shift
    costs IoU precision from class 8 on; the mask gives the exact IoU. The two
    agree wherever the reference's arithmetic is exact.
Leading batch dimensions are handled directly, so ``batched_nms`` needs no map.
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


def _greedy_fixed_point(suppress: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy result: the unique fixed point of K <- {j valid : no kept
    i suppresses j}, iterated from K = valid.

    One sweep counts each candidate's kept suppressors in one batched
    product and keeps those with none: ``keep = max(valid - keep @ S, 0)``
    on 0/1 values, exact in fp16 up to 2048 candidates (fp32 on the CPU).
    Eagerly the loop stops at the fixed point (typically a few sweeps; each
    check waits on the device). Inside a CUDA graph capture nothing may wait
    on the host, and ``torch.export`` cannot trace a check of the data, so
    both run all M sweeps: sweeps past the fixed point change nothing, and M
    bounds the depth of any suppression chain.
    """
    m = valid.shape[-1]
    dtype = torch.float16 if valid.is_cuda and m <= 2048 else torch.float32
    supp = suppress.to(dtype).reshape(-1, m, m)
    valid_f = valid.to(dtype).reshape(-1, 1, m)
    keep = valid_f
    if torch.compiler.is_exporting() or (valid.is_cuda
                                         and torch.cuda.is_current_stream_capturing()):
        for _ in range(m):
            keep = torch.baddbmm(valid_f, keep, supp, alpha=-1).clamp_(min=0)
    else:
        for _ in range(m):
            new = torch.baddbmm(valid_f, keep, supp, alpha=-1).clamp_(min=0)
            if torch.equal(new, keep):
                break
            keep = new
    return (keep > 0).reshape(valid.shape)


def nms_fixed(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    *,
    iou_threshold: float = 0.45,
    score_threshold: float = 0.25,
    max_detections: int = 100,
    pre_nms_top_k: int = 512,
) -> NMSResult:
    """Exact greedy, class-aware hard NMS with static shapes.

    Args:
        boxes: [..., N, 4] xyxy.
        scores: [..., N] confidence.
        classes: [..., N] integer class ids.
    """
    masked = torch.where(scores >= score_threshold, scores, -1.0)
    m = min(pre_nms_top_k, scores.shape[-1])
    s, idx = top_k_stable(masked, m)
    b = _gather_boxes(boxes, idx)
    c = torch.gather(classes, -1, idx)
    valid = s >= score_threshold

    upper = torch.ones(m, m, dtype=torch.bool, device=boxes.device).triu(1)
    same_class = c[..., :, None] == c[..., None, :]
    # suppress[..., i, j]: higher-scored i of the same class overlaps lower-scored j.
    suppress = (pairwise_iou(b, b) > iou_threshold) & upper & same_class

    keep = _greedy_fixed_point(suppress, valid)
    kept_scores = torch.where(keep, s, -1.0)
    k = min(max_detections, m)
    out_scores, out_idx = top_k_stable(kept_scores, k)
    out_valid = out_scores >= score_threshold
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


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                **kwargs) -> NMSResult:
    """Hard NMS over a leading batch axis: ``boxes`` [B, N, 4], ``scores`` and
    ``classes`` [B, N]. (The soft and matrix methods are not ported yet.)"""
    if boxes.dim() != 3 or scores.dim() != 2 or classes.dim() != 2:
        raise ValueError(f"batched_nms takes [B, N, 4], [B, N], [B, N]; got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}, {tuple(classes.shape)}")
    return nms_fixed(boxes, scores, classes, **kwargs)
