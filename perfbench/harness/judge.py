"""The comparison that decides ``correct`` for served detections.

Each served frame is held against the plain reference run on the same raw
frame (fp32). Every anchor of the reference has a box, clipped to the frame
as the engine clips, and a score per class.

Boxes are compared by ``box_distance``: the largest distance between a
corner coordinate of one box and of the other, as a share of the longer
side of the reference's box before clipping. Rounding moves a box in
proportion to its size, so a box that the frame's edge cuts to a sliver is
judged as the box it was cut from, not by the sliver's overlap. A served
detection's anchors are those within ``MATCH_GAP`` of it (a shift by a
third of a square box's side leaves an overlap of IoU 0.5).

One number is compared, ``logit_gap``: the widest, over the judged frames'
served detections and the reference's detections they leave out, of

- for each served detection, the gap in logits between its score and the
  reference's score for its class at its best anchor, the one whose score
  lies nearest among its anchors (``UNMATCHED_LOGIT_GAP`` where it has
  none, or its class is not the model's). It covers the letterbox, the
  forward, the decode and the clipping: a wrong pixel, layer, logit, box or
  class moves it, and a box moved by more than ``MATCH_GAP`` of its size
  has no anchor left.
- for each detection the reference serves itself (its own NMS and box
  filter) that no served box accounts for, the height of its score's logit
  above the threshold's: the least that rounding would have had to lower
  the program's score for it to be left out. A served box accounts for it
  when it lies within ``MATCH_GAP`` of it, of any class (a class that
  rounding moved), or when the box of the served detection's best anchor
  overlaps it, before clipping, by more than the NMS threshold less
  ``IOU_MARGIN`` with its class (a suppression that rounding moved). Only
  reference detections whose cut sides keep ``MIN_SIDE_SHARE`` of their
  longer side, and whose aspect ratio lies inside the box filter's by a
  margin, are required: rounding can move the others across the filter.
  It covers NMS and the frames or answers the program leaves out; their
  count is reported as ``missed``.

In logits and not in scores: a score is a product of two sigmoids, whose
slope hides a logit's error near 0 or 1 and shows it near one half, so the
score gaps of this model's bf16 answers and of the float8 control's overlap
more than their logit gaps do.

No number of its own compares box geometry: bf16 rounding of this model's
box logits moves a served box by up to a fifth of its size from its
anchor's fp32 box, and the float8 control by a quarter to a third, so no
limit lies three times above the one and below the other. A box moved
further than ``MATCH_GAP`` leaves its detection without an anchor.

Also reported: the mean logit gap over the same answers
(``mean_logit_gap``); the widest score gap of a served detection
(``served_gap``);
the frames and the served detections judged (the cell's traffic file sets
floors on both); ``missed``; and the most candidates at
or above the threshold and the most detections the reference kept in a
frame (under ``pre_nms_top_k`` and ``max_detections``, where no cut can
flip).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

MATCH_GAP = 1.0 / 3.0  # box distance within which two boxes are one detection
IOU_MARGIN = 0.1       # suppressions this close to the NMS threshold may flip
MIN_SIDE_SHARE = 0.1   # cut sides below this share of the box's longer side may flip
ASPECT_MARGIN = 0.8    # aspect ratios beyond this share of the filter's limit may flip
UNMATCHED_LOGIT_GAP = 20.0  # a served detection with no anchor, in logits
WIDEST = ("served_gap", "missed", "candidates", "kept")


class Served:
    """One frame's detections in the frame's pixels: boxes [K, 4] xyxy,
    scores [K], classes [K]."""

    def __init__(self, boxes, scores, classes):
        self.boxes = torch.as_tensor(boxes, dtype=torch.float32).reshape(-1, 4)
        self.scores = torch.as_tensor(scores, dtype=torch.float32).reshape(-1)
        self.classes = torch.as_tensor(classes, dtype=torch.long).reshape(-1)


def reference_tables(ref, model, frames_u8: torch.Tensor, size: int, block: int = 8
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per frame: every anchor's box in normalised letterbox xyxy and its
    per-class scores, from ``model`` (of the reference ``ref``), ``block``
    frames at a time."""
    out = []
    with torch.no_grad():
        for i in range(0, frames_u8.shape[0], block):
            boxes, scores = ref.decode(model.raw(ref.preprocess(frames_u8[i:i + block], size)))
            out.extend(zip(boxes, scores))
    return out


def reference_detections(ref, boxes: torch.Tensor, scores: torch.Tensor, frame_hw, size: int,
                         cfg) -> Served:
    """The reference's own served answer for one frame: NMS, the frame's
    pixels and the box filter, as the engine applies them."""
    b, s, c = ref.nms(boxes, scores, cfg)
    px = ref.to_pixels(b, frame_hw, size)
    keep = ref.box_filter(px, cfg["min_box_size"], cfg["max_aspect_ratio"])
    return Served(px[keep].cpu(), s[keep].cpu(), c[keep].cpu())


def extent(ref, boxes: torch.Tensor, frame_hw, size: int) -> torch.Tensor:
    """The longer side of each box (normalised letterbox xyxy) in the
    frame's pixels, before any clipping."""
    scale = ref.letterbox_geometry(frame_hw[0], frame_hw[1], size)[0]
    wh = (boxes[:, 2:] - boxes[:, :2]) * size / scale
    return wh.amax(dim=1).clamp(min=1e-3)


def box_distance(a_px: torch.Tensor, b_px: torch.Tensor, b_extent: torch.Tensor) -> torch.Tensor:
    """[len(a), len(b)]: the largest corner-coordinate distance between each
    box of ``a`` and each of ``b`` (frame pixels), over ``b``'s extent."""
    return (a_px[:, None, :] - b_px[None, :, :]).abs().amax(dim=-1) / b_extent[None, :]


def judge_frame(ref, served: Served, boxes: torch.Tensor, scores: torch.Tensor, frame_hw,
                size: int, cfg) -> Dict[str, float]:
    """The numbers for one frame (``boxes``, ``scores``: its reference
    table)."""
    dev = boxes.device
    best = scores.max(dim=-1).values
    px = ref.to_pixels(boxes, frame_hw, size)
    ext = extent(ref, boxes, frame_hw, size)
    none = torch.zeros(0, device=dev)
    out = {"logit_gaps": none, "served_gap": 0.0, "missed": 0.0,
           "detections": float(len(served.scores)),
           "candidates": float((best >= cfg["score_threshold"]).sum())}
    anchor = torch.zeros(0, dtype=torch.long, device=dev)
    if len(served.scores):
        cls = served.classes.to(dev)
        ok = (cls >= 0) & (cls < scores.shape[1])
        gap = (served.scores.to(dev)[:, None]
               - scores[:, cls.clamp(0, scores.shape[1] - 1)].T).abs()
        dist = box_distance(served.boxes.to(dev), px, ext)
        gap = torch.where(dist <= MATCH_GAP, gap, torch.ones_like(gap))
        least, anchor = gap.min(dim=1)
        matched = ok & (least < 1)
        least = torch.where(ok, least, torch.ones_like(least))
        mine = scores[anchor, cls.clamp(0, scores.shape[1] - 1)]
        lgap = (_logit(served.scores.to(dev)) - _logit(mine)).abs()
        out["served_gap"] = float(least.max())
        out["logit_gaps"] = torch.where(matched, lgap, torch.full_like(lgap, UNMATCHED_LOGIT_GAP))
    b, s, c = ref.nms(boxes, scores, cfg)
    mine_px = ref.to_pixels(b, frame_hw, size)
    keep = ref.box_filter(mine_px, cfg["min_box_size"], cfg["max_aspect_ratio"])
    out["kept"] = float(keep.sum())
    mine_ext = extent(ref, b, frame_hw, size)
    sides = mine_px[:, 2:] - mine_px[:, :2]
    sure = keep & (sides.amin(dim=1) >= MIN_SIDE_SHARE * mine_ext)
    sure &= ref.box_filter(mine_px, cfg["min_box_size"], cfg["max_aspect_ratio"] * ASPECT_MARGIN)
    if sure.any():
        if len(served.scores):
            near = box_distance(served.boxes.to(dev), mine_px[sure], mine_ext[sure]) <= MATCH_GAP
            iou = ref.iou_matrix(boxes[anchor], b[sure])
            same = served.classes.to(dev)[:, None] == c[sure][None, :]
            covered = (near | (same & (iou > cfg["iou_threshold"] - IOU_MARGIN))).any(dim=0)
        else:
            covered = torch.zeros(int(sure.sum()), dtype=torch.bool, device=dev)
        out["missed"] = float((~covered).sum())
        if out["missed"]:
            left_out = s[sure][~covered]
            thr = torch.tensor(cfg["score_threshold"], device=dev)
            out["logit_gaps"] = torch.cat([out["logit_gaps"], _logit(left_out) - _logit(thr)])
    return out


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def judge(ref, served: Sequence[Served], tables, frame_hw, size: int, cfg) -> Dict[str, float]:
    """``logit_gap`` and ``mean_logit_gap`` over the frames (``tables`` as
    ``reference_tables`` gives them, one per served frame), the frames and
    served detections judged, and the most of each count in a frame."""
    worst = dict.fromkeys(WIDEST, 0.0)
    frames, detections, gaps = 0, 0.0, [torch.zeros(0)]
    for s, (boxes, scores) in zip(served, tables):
        r = judge_frame(ref, s, boxes, scores, frame_hw, size, cfg)
        for k in worst:
            worst[k] = max(worst[k], r[k])
        frames += 1
        detections += r["detections"]
        gaps.append(r["logit_gaps"].cpu())
    g = torch.cat(gaps)
    widest, mean = (float(g.max()), float(g.mean())) if len(g) else (0.0, 0.0)
    return {"logit_gap": widest, "mean_logit_gap": mean, **worst, "frames": float(frames),
            "detections": detections}
