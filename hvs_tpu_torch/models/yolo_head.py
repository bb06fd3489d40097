"""YOLO multi-scale detection head with on-device decode and NMS.

Counterpart of ``hvs_tpu/models/yolo_head.py``: the COCO anchor table,
``effective_anchors``, ``make_anchor_grid``, ``YOLOPredictionHead`` (with
the -4.0 objectness/class bias), ``decode_predictions``,
``YOLODetectionHead`` and ``postprocess_detections``.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import NMSResult, batched_nms
from ..ops.quant import quantize_tensor
from .layers import Conv, ManifoldHyperConnection, QuantConv, QuantSites, group_norm

# COCO anchor sizes in pixels at a 416 input, normalized by 416, ordered from
# the fine (stride 8) grid to the coarse (stride 32) one.
COCO_ANCHORS_416: Tuple[Tuple[Tuple[float, float], ...], ...] = (
    ((10 / 416, 13 / 416), (16 / 416, 30 / 416), (33 / 416, 23 / 416)),
    ((30 / 416, 61 / 416), (62 / 416, 45 / 416), (59 / 416, 119 / 416)),
    ((116 / 416, 90 / 416), (156 / 416, 198 / 416), (373 / 416, 326 / 416)),
)

SCALE_ORDER = ("fused_small", "fused_medium", "fused_large")

# Grid sizes per scale at the 416 reference input (strides 8/16/32).
ANCHOR_REF_GRIDS: Tuple[int, int, int] = (52, 26, 13)
NUM_ANCHORS = 3  # per scale
WH_CLIP = 4.0  # clamp on the wh logits before exp


def effective_anchors(scale_idx: int, grid_h: int, anchors=COCO_ANCHORS_416):
    """Anchors of one scale rescaled so their pixel size does not change with
    the input resolution (the identity at 416)."""
    f = ANCHOR_REF_GRIDS[scale_idx] / float(grid_h)
    return tuple((aw * f, ah * f) for aw, ah in anchors[scale_idx])


def make_anchor_grid(grid_h: int, grid_w: int, anchors) -> np.ndarray:
    """Static anchor tensor [A, H, W, 4] (cx, cy, w, h), normalized."""
    a = len(anchors)
    ys, xs = np.meshgrid(np.arange(grid_h), np.arange(grid_w), indexing="ij")
    out = np.zeros((a, grid_h, grid_w, 4), np.float32)
    for i, (w, h) in enumerate(anchors):
        out[i, ..., 0] = (xs + 0.5) / grid_w
        out[i, ..., 1] = (ys + 0.5) / grid_h
        out[i, ..., 2] = w
        out[i, ..., 3] = h
    return out


class YOLOPredictionHead(QuantSites, nn.Module):
    """Per-scale tower: 1x1 reduce -> GN/SiLU -> 3x3 -> GN/SiLU -> channel mHC
    -> 1x1 to A*(5+C) logits (A = ``num_anchors``); returns [B, H, W, A, 5+C].
    The mHC keeps the layer's default dropout rate (0.1), as the JAX tower
    passes none; ``mhc`` are its other keyword options; ``use_mhc=False``
    builds no mHC layer (no ``mhc`` parameters). ``act_quant``: ``reduce`` and ``conv``
    take int8 inputs (sites ``x_scale``, ``y1_scale``); the mHC layer and the
    ``predict`` logits stay bf16, as in JAX."""

    SITES = ("x_scale", "y1_scale")

    def __init__(self, in_channels: int, num_classes: int = 80, head_channels: int = 256,
                 dtype: torch.dtype = torch.bfloat16, act_quant: bool = False,
                 num_anchors: int = NUM_ANCHORS, use_mhc: bool = True, **mhc):
        super().__init__()
        self.dtype = dtype
        self.act_quant = act_quant
        self.num_anchors = num_anchors
        self.per_anchor = 5 + num_classes
        conv = QuantConv if act_quant else partial(Conv, use_bias=False)
        self.reduce = conv(in_channels, head_channels, (1, 1), dtype=dtype)
        self.GroupNorm_0 = group_norm(head_channels, dtype)
        self.conv = conv(head_channels, head_channels, (3, 3), dtype=dtype)
        self.GroupNorm_1 = group_norm(head_channels, dtype)
        self.mhc = (ManifoldHyperConnection(head_channels, 1, 1, dtype=dtype, **mhc)
                    if use_mhc else None)
        self.predict = Conv(head_channels, num_anchors * self.per_anchor, (1, 1), dtype=dtype,
                            bias_init=self._bias_init)
        self._init_quant(self.SITES, self.SITES if act_quant else ())

    def _bias_init(self, bias: torch.Tensor) -> None:
        # Objectness and class logits start at -4.0, box offsets at 0.
        b = bias.view(self.num_anchors, self.per_anchor)
        b.fill_(-4.0)
        b[:, :4] = 0.0

    def _conv(self, layer: Conv, x: torch.Tensor, site: str) -> torch.Tensor:
        if self.act_quant:
            scale = self.act_scale(site)
            return layer(quantize_tensor(x, scale), scale)
        self.record(site, x)
        return layer(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.GroupNorm_0(self._conv(self.reduce, x.to(self.dtype), "x_scale")))
        y = F.silu(self.GroupNorm_1(self._conv(self.conv, y, "y1_scale")))
        if self.mhc is not None:
            y = self.mhc(y)
        out = self.predict(y)
        b, h, w, _ = out.shape
        return out.reshape(b, h, w, self.num_anchors, self.per_anchor)


def decode_predictions(raw: torch.Tensor, anchors: torch.Tensor) -> Dict[str, torch.Tensor]:
    """YOLO decode of raw [B, H, W, A, 5+C] against anchors [A, H, W, 4]:
    normalized xyxy ``boxes``, per-class ``scores``, ``objectness``, and the
    best class per anchor (``class_scores``, ``class_indices``; argmax takes
    the first maximum)."""
    box_raw = raw[..., :5].float()
    _, h, w, _, _ = raw.shape
    xy = torch.sigmoid(box_raw[..., 0:2])
    wh = torch.exp(torch.clamp(box_raw[..., 2:4], -WH_CLIP, WH_CLIP))
    obj = torch.sigmoid(box_raw[..., 4:5])

    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=raw.device),
                            torch.arange(w, dtype=torch.float32, device=raw.device),
                            indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)[None, :, :, None, :]
    anc = anchors.permute(1, 2, 0, 3)[None]
    # Divided by Python scalars, not a tensor made from a list: that would be
    # a host-to-device copy, which a CUDA graph capture does not allow.
    cell = grid + xy
    center = torch.cat([cell[..., :1] / w, cell[..., 1:] / h], dim=-1)
    half = anc[..., 2:4] * wh / 2
    boxes = torch.cat([center - half, center + half], dim=-1)

    cls_logits = raw[..., 5:]
    max_logit = cls_logits.amax(dim=-1).float()
    return {
        "boxes": boxes,
        "scores": obj * torch.sigmoid(cls_logits.float()),
        "objectness": obj,
        "class_scores": obj[..., 0] * torch.sigmoid(max_logit),
        "class_indices": torch.argmax(cls_logits, dim=-1),
    }


class YOLODetectionHead(nn.Module):
    """Prediction towers on the three fused scales and their decode,
    concatenated fine to coarse. ``anchors`` (per scale, fine to coarse,
    normalized at 416 as ``COCO_ANCHORS_416``) and ``num_anchors`` per scale
    as JAX's; ``use_mhc`` goes to the towers."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024), num_classes: int = 80,
                 head_channels: int = 256, dtype: torch.dtype = torch.bfloat16,
                 act_quant: bool = False, num_anchors: int = NUM_ANCHORS, use_mhc: bool = True,
                 anchors=COCO_ANCHORS_416, **mhc):
        super().__init__()
        self.num_classes = num_classes
        self.anchors = anchors
        for key, c in zip(SCALE_ORDER, in_channels):
            self.add_module(f"head_{key}", YOLOPredictionHead(c, num_classes, head_channels,
                                                              dtype=dtype, act_quant=act_quant,
                                                              num_anchors=num_anchors,
                                                              use_mhc=use_mhc, **mhc))
        self._anchor_grids: Dict[Any, torch.Tensor] = {}

    def _anchor_grid(self, scale_idx: int, h: int, w: int, device) -> torch.Tensor:
        key = (scale_idx, h, w, str(device))
        grid = self._anchor_grids.get(key)
        if grid is None:
            grid = torch.from_numpy(make_anchor_grid(h, w, effective_anchors(scale_idx, h,
                                                                             self.anchors)))
            grid = grid.to(device)
            self._anchor_grids[key] = grid
        return grid

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        raw_outputs, boxes, scores, cls_scores, cls_idx = {}, [], [], [], []
        for scale_idx, key in enumerate(SCALE_ORDER):
            raw = getattr(self, f"head_{key}")(features[key])
            raw_outputs[key] = raw
            b, h, w = raw.shape[:3]
            dec = decode_predictions(raw, self._anchor_grid(scale_idx, h, w, raw.device))
            boxes.append(dec["boxes"].reshape(b, -1, 4))
            scores.append(dec["scores"].reshape(b, -1, self.num_classes))
            cls_scores.append(dec["class_scores"].reshape(b, -1))
            cls_idx.append(dec["class_indices"].reshape(b, -1))
        return {
            "raw": raw_outputs,
            "boxes": torch.cat(boxes, dim=1),
            "scores": torch.cat(scores, dim=1),
            "class_scores": torch.cat(cls_scores, dim=1),
            "class_indices": torch.cat(cls_idx, dim=1).to(torch.int32),
        }


def postprocess_detections(outputs: Dict[str, torch.Tensor], score_threshold: float = 0.25,
                           iou_threshold: float = 0.45, max_detections: int = 100,
                           pre_nms_top_k: int = 512, nms_method: str = "hard") -> NMSResult:
    """Confidence threshold -> class-aware NMS (``nms_method``: hard, soft or
    matrix) -> fixed top-K, on the device the head ran on. ``iou_threshold``
    goes to hard NMS only, as in the reference. Boxes stay normalized xyxy."""
    kwargs = dict(score_threshold=score_threshold, max_detections=max_detections,
                  pre_nms_top_k=pre_nms_top_k)
    if nms_method == "hard":
        kwargs["iou_threshold"] = iou_threshold
    return batched_nms(outputs["boxes"], outputs["class_scores"], outputs["class_indices"],
                       method=nms_method, **kwargs)
