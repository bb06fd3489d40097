"""Losses: YOLO target assignment, CIoU/focal/BCE, the manifold regulariser
and the multi-task objective.

Counterpart of ``hvs_tpu/training/losses.py`` (``build_targets``,
``focal_bce``, ``bce_with_smoothing``, ``mhc_yolo_loss``,
``_spectral_norm_bound``, ``iter_h_res_leaves``,
``manifold_regularization_loss``, ``multi_task_loss``). Parameters are a
dict of the model's named parameters (dotted paths, as
``model.named_parameters()`` gives). Every loss has fixed shapes and reads
nothing back to the host, so a CUDA graph can capture it.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..device import device_constant
from ..models.yolo_head import COCO_ANCHORS_416, SCALE_ORDER, effective_anchors
from ..ops.boxes import box_ciou, cxcywh_to_xyxy
from ..ops.sinkhorn import sinkhorn_log_many
from ..parallel.mesh import Mesh

Tensor = torch.Tensor


class LossWeights(NamedTuple):
    """Lambda weights of the YOLO loss."""

    coord: float = 5.0
    obj: float = 1.0
    noobj: float = 0.5
    cls: float = 1.0


def build_targets(gt_boxes: Tensor, gt_labels: Tensor, gt_mask: Tensor,
                  grid_sizes: Sequence[Tuple[int, int]], num_classes: int,
                  anchors=COCO_ANCHORS_416) -> Dict[str, Dict[str, Tensor]]:
    """Assign padded ground truth to anchor cells, YOLOv3-style.

    Each gt box goes to the best of the 9 anchors by wh-IoU (first on ties);
    the anchor fixes the scale, the box centre the cell. Padded slots (mask
    0) are dropped.

    When two boxes land on one (cell, anchor), the one in the highest slot
    wins. The JAX function scatters with ``mode="drop"``, where XLA leaves the
    winner unspecified; the port picks it deterministically (a max-reduce of
    the slot index per target, then a collision-free write).

    Every shape is fixed by the inputs' (no boolean indexing, so no host
    sync and nothing a CUDA graph cannot capture): slots that are padded,
    belong to another scale or lose a collision are sent to a spare row
    ``n_cells`` of buffers with ``n_cells + 1`` rows, which is dropped.

    Args:
        gt_boxes: [B, M, 4] normalized cxcywh ground truth (padded).
        gt_labels: [B, M] int class ids.
        gt_mask: [B, M] 1.0 for real boxes.
        grid_sizes: [(H, W)] per scale, fine to coarse (``SCALE_ORDER``).

    Returns per scale: {"box": [B,H,W,A,4] cxcywh, "obj": [B,H,W,A] fp32,
    "cls": [B,H,W,A] int64}.
    """
    b, m, _ = gt_boxes.shape
    dev = gt_boxes.device
    a_per_scale = len(anchors[0])
    grids = tuple(tuple(g) for g in grid_sizes)
    flat_anchors = device_constant(
        ("anchors", grids, anchors), dev,
        lambda: [wh for s in range(len(grids)) for wh in effective_anchors(s, grids[s][0], anchors)]
    )  # [S*A, 2]
    gw, gh = gt_boxes[..., 2:3], gt_boxes[..., 3:4]
    aw, ah = flat_anchors[None, None, :, 0], flat_anchors[None, None, :, 1]
    inter = torch.minimum(gw, aw) * torch.minimum(gh, ah)
    wh_iou = inter / (gw * gh + aw * ah - inter + 1e-9)  # [B, M, S*A]
    best = torch.argmax(wh_iou, dim=-1)
    best_scale, best_anchor = best // a_per_scale, best % a_per_scale
    batch_idx = torch.arange(b, device=dev)[:, None]
    slot = torch.arange(m, device=dev)[None, :].expand(b, m).reshape(-1)
    boxes = gt_boxes.reshape(b * m, 4).float()
    labels = gt_labels.reshape(b * m).long()

    targets = {}
    for s, (gh_s, gw_s) in enumerate(grids):
        valid = (best_scale == s) & (gt_mask > 0.5)
        gx = torch.clamp(torch.floor(gt_boxes[..., 0] * gw_s), 0, gw_s - 1).long()
        gy = torch.clamp(torch.floor(gt_boxes[..., 1] * gh_s), 0, gh_s - 1).long()
        cell = ((batch_idx * gh_s + gy) * gw_s + gx) * a_per_scale + best_anchor
        n_cells = b * gh_s * gw_s * a_per_scale
        cell = torch.where(valid, cell, n_cells).reshape(-1)
        winner_slot = torch.full((n_cells + 1,), -1, dtype=torch.long, device=dev).scatter_reduce(
            0, cell, slot, reduce="amax")
        idx = torch.where(winner_slot[cell] == slot, cell, n_cells)
        box_t = torch.zeros(n_cells + 1, 4, dtype=torch.float32, device=dev)
        obj_t = torch.zeros(n_cells + 1, dtype=torch.float32, device=dev)
        cls_t = torch.zeros(n_cells + 1, dtype=torch.long, device=dev)
        box_t[idx] = boxes
        obj_t.index_fill_(0, idx, 1.0)  # a scalar setitem would copy from the host
        cls_t[idx] = labels
        shape = (b, gh_s, gw_s, a_per_scale)
        targets[SCALE_ORDER[s]] = {"box": box_t[:n_cells].reshape(shape + (4,)),
                                   "obj": obj_t[:n_cells].reshape(shape),
                                   "cls": cls_t[:n_cells].reshape(shape)}
    return targets


def _relu0(x: Tensor) -> Tensor:
    """max(x, 0) with JAX's gradient at a tie (half to each side)."""
    return torch.maximum(x, x.new_zeros(()))


def focal_bce(logits: Tensor, targets: Tensor, gamma: float = 2.0, alpha: float = 0.25) -> Tensor:
    """Focal binary cross-entropy on logits."""
    p = torch.sigmoid(logits)
    ce = _relu0(logits) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    return alpha_t * ((1 - p_t) ** gamma) * ce


def bce_with_smoothing(logits: Tensor, onehot: Tensor, smoothing: float = 0.05) -> Tensor:
    """BCE on logits with label smoothing."""
    t = onehot * (1 - smoothing) + 0.5 * smoothing
    return _relu0(logits) - logits * t + torch.log1p(torch.exp(-torch.abs(logits)))


def mhc_yolo_loss(raw_outputs: Dict[str, Tensor], targets: Dict[str, Dict[str, Tensor]],
                  num_classes: int, weights: LossWeights = LossWeights(),
                  label_smoothing: float = 0.05, ignore_iou: float = 0.5, cls_mode: str = "bce",
                  cls_pos_weight: float = 1.0, mesh: Optional[Mesh] = None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """YOLO loss over all scales: CIoU box loss at positive cells, focal
    objectness (no-object cells down-weighted and ignored where the
    prediction overlaps a gt by more than ``ignore_iou``), and the class loss
    at positive cells, each divided by the positive count (at least 1).

    ``cls_mode``: ``"bce"`` (per-class logistic loss with label smoothing;
    ``cls_pos_weight`` multiplies the true-class term) or ``"softmax"``
    (smoothed softmax cross-entropy).

    A data-parallel ``mesh`` sums the positive counts over its processes:
    they are then the global batch's, so each process's loss is its share
    of the global loss and the shares sum to it.
    """
    total_box = total_obj = total_cls = n_pos_total = 0.0
    n_pos_all = torch.stack([targets[key]["obj"].sum() for key in SCALE_ORDER])
    if mesh is not None:
        n_pos_all = mesh.all_sum(n_pos_all)
    for scale_idx, key in enumerate(SCALE_ORDER):
        raw = raw_outputs[key].float()
        t = targets[key]
        _, h, w, _, _ = raw.shape
        obj_mask = t["obj"]
        n_pos = n_pos_all[scale_idx]
        denom = torch.clamp(n_pos, min=1.0)

        gy = torch.arange(h, dtype=torch.float32, device=raw.device)[None, :, None, None]
        gx = torch.arange(w, dtype=torch.float32, device=raw.device)[None, None, :, None]
        anc = device_constant(("loss_anchors", scale_idx, h), raw.device,
                               lambda: effective_anchors(scale_idx, h))  # [A, 2]
        px = (gx + torch.sigmoid(raw[..., 0])) / w
        py = (gy + torch.sigmoid(raw[..., 1])) / h
        pw = anc[:, 0] * torch.exp(torch.clamp(raw[..., 2], -4, 4))
        ph = anc[:, 1] * torch.exp(torch.clamp(raw[..., 3], -4, 4))
        pred_xyxy = cxcywh_to_xyxy(torch.stack([px, py, pw, ph], dim=-1))
        ciou = box_ciou(pred_xyxy, cxcywh_to_xyxy(t["box"]))
        box_loss = ((1.0 - ciou) * obj_mask).sum() / denom

        obj_loss_map = focal_bce(raw[..., 4], obj_mask)
        noobj_mask = (1.0 - obj_mask) * torch.where(ciou > ignore_iou, 0.0, 1.0)
        obj_loss = (weights.obj * (obj_loss_map * obj_mask).sum()
                    + weights.noobj * (obj_loss_map * noobj_mask).sum()) / denom

        onehot = F.one_hot(t["cls"], num_classes).float()
        if cls_mode == "softmax":
            tgt = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
            ce = -(tgt * torch.log_softmax(raw[..., 5:], dim=-1)).sum(dim=-1)
            cls_loss = (ce * obj_mask).sum() / denom
        else:
            cls_map = bce_with_smoothing(raw[..., 5:], onehot, label_smoothing)
            if cls_pos_weight != 1.0:
                cls_map = cls_map * (1.0 + (cls_pos_weight - 1.0) * onehot)
            cls_loss = (cls_map.sum(dim=-1) * obj_mask).sum() / denom

        total_box = total_box + box_loss
        total_obj = total_obj + obj_loss
        total_cls = total_cls + cls_loss
        n_pos_total = n_pos_total + n_pos

    loss = weights.coord * total_box + total_obj + weights.cls * total_cls
    metrics = {"box_loss": total_box, "obj_loss": total_obj, "cls_loss": total_cls,
               "num_positives": n_pos_total}
    return loss, metrics


def _spectral_norm_bound(m: Tensor, iters: int = 8) -> Tensor:
    """Largest singular value of ``m`` by power iteration (differentiable)."""
    v = torch.ones(m.shape[-1], dtype=torch.float32, device=m.device) / math.sqrt(m.shape[-1])
    for _ in range(iters):
        u = m @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-9)
        v = m.T @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-9)
    return torch.linalg.vector_norm(m @ v)


def iter_h_res_leaves(params: Dict[str, Tensor]) -> Iterator[Tuple[str, Tensor]]:
    """Every ``H_res_raw`` parameter of a named-parameter dict, by path."""
    for name, leaf in params.items():
        if name.rsplit(".", 1)[-1] == "H_res_raw":
            yield name, leaf


def manifold_regularization_loss(params: Dict[str, Tensor], ds_weight: float = 1.0,
                                 spectral_weight: float = 0.1, smooth_weight: float = 0.01,
                                 sk_iters: int = 20) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Soft manifold penalty over every mHC residual matrix: the column-sum
    error of its finite-iteration Sinkhorn projection (the same projection the
    forward uses; Sinkhorn through the Hopper kernel on the card), the excess
    of the projection's spectral norm over 1, and the smoothness of the raw
    matrix; averaged over the matrices. The projections are one grouped call
    (one kernel launch per width on the card)."""
    ds_total = spec_total = smooth_total = 0.0
    count = 0
    leaves = [leaf for _, leaf in iter_h_res_leaves(params)]
    projections = sinkhorn_log_many([leaf.float() for leaf in leaves], n_iters=sk_iters)
    for leaf, proj in zip(leaves, projections):
        ds_total = ds_total + ((proj.sum(dim=-2) - 1.0) ** 2).mean()
        spec_total = spec_total + torch.relu(_spectral_norm_bound(proj) - 1.0) ** 2
        dr = leaf[1:, :] - leaf[:-1, :]
        dc = leaf[:, 1:] - leaf[:, :-1]
        smooth_total = smooth_total + (dr ** 2).mean() + (dc ** 2).mean()
        count += 1
    count = max(count, 1)
    loss = (ds_weight * ds_total + spectral_weight * spec_total
            + smooth_weight * smooth_total) / count
    metrics = {"manifold_ds": ds_total / count, "manifold_spectral": spec_total / count,
               "manifold_smooth": smooth_total / count}
    return loss, metrics


def at_head_stride(dense: Tensor, h: int, w: int) -> Tensor:
    """Nearest downsampling of [B, H', W'] labels to a head's [h, w] grid by
    striding (every fy-th row and column, fy = H' // h), as JAX does."""
    if dense.shape[1] == h:
        return dense
    fy = dense.shape[1] // h
    return dense[:, ::fy, ::fy][:, :h, :w]


def multi_task_loss(outputs: Dict[str, object], batch: Dict[str, object], num_classes: int,
                    task_weights: Optional[Dict[str, float]] = None,
                    mesh: Optional[Mesh] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Weighted multi-task objective over whichever heads ran and have labels
    in ``batch``, with the JAX function's terms and metric names:

    * detection (weight 1): ``mhc_yolo_loss`` of ``outputs["detection"]``
      against ``batch["targets"]`` (``build_targets``);
    * classification (0.5): cross-entropy against ``batch["class_labels"]``;
    * segmentation (0.5): labels ``batch["seg_labels"]`` (class id + 1, 0 the
      background) strided to the head's grid; class-balanced cross-entropy
      (each pixel weighted by size / (k · count) of its class in the batch,
      clipped to [0.05, 20], as a weighted mean) plus 0.5 × the soft Dice
      loss over the classes present;
    * depth (0.5): L1 between log(pred + 1e-3) and log(gt + 1e-3),
      ``batch["depth"]`` strided the same way.

    A data-parallel ``mesh`` sums every batch statistic (positive counts,
    class counts and pixel weights, the Dice sums, element counts) over its
    processes, so it is the global batch's, and each process's loss is its
    share of the global loss (the shares sum to it, and so do their
    gradients). The Dice term is not a sum over pixels: each process takes
    the global value over the process count, through a differentiable
    all-reduce of the Dice sums whose backward sums the gradients.
    """
    tw = {"detection": 1.0, "classification": 0.5, "segmentation": 0.5}
    if task_weights:
        tw.update(task_weights)
    total: Tensor = 0.0
    metrics: Dict[str, Tensor] = {}
    if "detection" in outputs and "targets" in batch:
        det_loss, det_m = mhc_yolo_loss(outputs["detection"]["raw"], batch["targets"],
                                        num_classes, mesh=mesh)
        total = total + tw["detection"] * det_loss
        metrics.update(det_m)
        metrics["detection_loss"] = det_loss
    if "classification" in outputs and "class_labels" in batch:
        logits = outputs["classification"].float()
        labels = batch["class_labels"].long()
        if mesh is None:
            cls = F.cross_entropy(logits, labels)
        else:
            count = mesh.all_sum(torch.full((), labels.numel(), dtype=torch.float32,
                                            device=logits.device))
            cls = F.cross_entropy(logits, labels, reduction="sum") / count
        total = total + tw["classification"] * cls
        metrics["classification_loss"] = cls
    if "segmentation" in outputs and "seg_labels" in batch:
        logits = outputs["segmentation"].float()
        _, h, w, k = logits.shape
        labels = at_head_stride(batch["seg_labels"], h, w).long()
        log_p = torch.log_softmax(logits, dim=-1)
        ce_map = -log_p.gather(-1, labels[..., None])[..., 0]
        onehot = F.one_hot(labels, k).float()
        counts = onehot.sum(dim=(0, 1, 2))
        numel = torch.full((), labels.numel(), dtype=torch.float32, device=logits.device)
        if mesh is not None:
            stats = mesh.all_sum(torch.cat([counts, numel[None]]))
            counts, numel = stats[:k], stats[k]
        weights = torch.where(counts > 0, numel / (k * torch.clamp(counts, min=1.0)),
                              torch.zeros_like(counts))
        pix_w = torch.clamp(weights, 0.05, 20.0)[labels]
        weight_sum = pix_w.sum()
        if mesh is not None:
            weight_sum = mesh.all_sum(weight_sum)
        seg = (ce_map * pix_w).sum() / torch.clamp(weight_sum, min=1.0)
        p = log_p.exp()
        inter = (p * onehot).sum(dim=(0, 1, 2))
        denom = (p + onehot).sum(dim=(0, 1, 2))
        if mesh is not None:
            inter, denom = mesh.all_sum(torch.cat([inter, denom])).split(k)
        present = (counts > 0).float()
        dice = 1.0 - (present * (2.0 * inter + 1.0) / (denom + 1.0)).sum() / torch.clamp(
            present.sum(), min=1.0)
        if mesh is not None:
            dice = dice / mesh.data
        seg = seg + 0.5 * dice
        total = total + tw["segmentation"] * seg
        metrics["segmentation_loss"] = seg
        metrics["segmentation_dice_loss"] = dice
    if "depth" in outputs and "depth" in batch:
        pred = outputs["depth"].float()[..., 0]
        gt = at_head_stride(batch["depth"].float(), pred.shape[1], pred.shape[2])
        err = (torch.log(pred + 1e-3) - torch.log(gt + 1e-3)).abs()
        if mesh is None:
            dep = err.mean()
        else:
            dep = err.sum() / mesh.all_sum(torch.full((), err.numel(), dtype=torch.float32,
                                                      device=err.device))
        total = total + tw.get("depth", 0.5) * dep
        metrics["depth_loss"] = dep
    metrics["total_loss"] = total
    return total, metrics
