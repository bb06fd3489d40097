"""Box geometry for xyxy boxes on trailing ``[..., 4]`` axes.

Counterpart of the parts of ``hvs_tpu/ops/boxes.py`` that NMS uses.
"""

from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; negative extents clamp to zero."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of xyxy boxes, broadcasting ``a`` against ``b``."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    return inter / (union + eps)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """All-pairs IoU: ``a`` [..., N, 4] x ``b`` [..., M, 4] -> [..., N, M]."""
    return box_iou(a[..., :, None, :], b[..., None, :, :], eps=eps)
