"""Box geometry on trailing ``[..., 4]`` axes (xyxy unless named cxcywh).

Counterpart of ``hvs_tpu/ops/boxes.py``: format conversion, areas, the IoU
family (IoU, pairwise IoU, GIoU, CIoU) and clipping to the image.
"""

from __future__ import annotations

import math

import torch


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes.unbind(dim=-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = boxes.unbind(dim=-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


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


def box_giou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Generalized IoU of xyxy boxes, elementwise with broadcasting: IoU minus
    the share of the enclosing box that the union leaves empty."""
    iou = box_iou(a, b, eps)
    wh = torch.clamp(torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2]),
                     min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    inter_wh = torch.clamp(torch.minimum(a[..., 2:], b[..., 2:])
                           - torch.maximum(a[..., :2], b[..., :2]), min=0.0)
    union = box_area(a) + box_area(b) - inter_wh[..., 0] * inter_wh[..., 1]
    return iou - (hull - union) / (hull + eps)


def box_ciou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU of xyxy boxes, elementwise with broadcasting: IoU minus
    the centre-distance and aspect-ratio penalties. The aspect weight alpha
    is held constant for gradients (detached), as in the JAX function."""
    iou = box_iou(a, b, eps)
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:], b[..., 2:])
    c2 = ((rb - lt) ** 2).sum(dim=-1) + eps
    ca = (a[..., :2] + a[..., 2:]) / 2
    cb = (b[..., :2] + b[..., 2:]) / 2
    rho2 = ((ca - cb) ** 2).sum(dim=-1)
    wa = torch.clamp(a[..., 2] - a[..., 0], min=eps)
    ha = torch.clamp(a[..., 3] - a[..., 1], min=eps)
    wb = torch.clamp(b[..., 2] - b[..., 0], min=eps)
    hb = torch.clamp(b[..., 3] - b[..., 1], min=eps)
    v = (4.0 / math.pi ** 2) * (torch.atan(wb / hb) - torch.atan(wa / ha)) ** 2
    alpha = (v / (1.0 - iou + v + eps)).detach()
    return iou - rho2 / c2 - alpha * v


def clip_boxes(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """xyxy boxes clipped to an image of ``height`` x ``width``."""
    x1, y1, x2, y2 = boxes.unbind(dim=-1)
    return torch.stack([x1.clamp(0.0, width), y1.clamp(0.0, height),
                        x2.clamp(0.0, width), y2.clamp(0.0, height)], dim=-1)
