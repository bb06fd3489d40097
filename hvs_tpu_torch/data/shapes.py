"""Synthetic-shapes detection benchmark: a reproducible COCO-format dataset.

Counterpart of ``hvs_tpu/data/shapes.py`` (numpy and cv2, copied): the same
RNG streams, drawing calls and files, so for one seed and one cv2 build both
write the same arrays, JSON and image bytes. The annotation JSON keeps the
reference's ``info.description`` text, so the two packages' files are
interchangeable. Layout:

    root/
      train/  *.jpg
      val/    *.jpg
      annotations/instances_train.json
      annotations/instances_val.json
      masks/<split>/*.png, depth/<split>/*.png   (with_dense=True)

What makes it a detection benchmark:

  * Class identity is geometry only (8 classes; colours are random per
    instance), or geometry x hue family x fill (80 classes).
  * Cluttered backgrounds: low-frequency colour gradients, sensor-style
    noise, and unlabelled distractors (thin lines, small specks).
  * 2..12 instances per image with mutual IoU up to 0.4 plus draw-order
    occlusion, so the crowding and NMS path is exercised.
  * Three size buckets at generation size 640 (boxes of 10-32, 33-96 and
    97-205 px), so AP_small, AP_medium and AP_large are all real numbers.
  * Deterministic given ``seed``: one independent RNG stream per image, so
    any subset regenerates identically.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

SHAPE_CLASSES = (
    "circle",
    "square",
    "triangle",
    "rectangle",
    "ellipse",
    "ring",
    "cross",
    "star",
)

# ---------------------------------------------------------------------------
# 80-class taxonomy: shape x color-family x fill-pattern grid.
#
# The detector's default taxonomy is COCO's 80 classes. The 8-class geometry
# taxonomy above cannot exercise an 80-way classification path, so the
# 80-class benchmark factors
# class identity over three visual axes the detector must read jointly:
#
#   8 geometry classes x 5 color families x 2 fill patterns = 80 classes
#
#   * geometry: the 8 SHAPE_CLASSES silhouettes;
#   * color family: a HUE BAND, not a fixed color — hue is sampled inside
#     the band and saturation/value jitter per instance, so the model must
#     learn hue categories rather than memorize RGB triples;
#   * fill: "solid", or "striped" — parallel bands at ~35% value inside the
#     instance, period scaled with instance size (>=4 px so the COCO-small
#     bucket keeps >=2 visible bands through AA + JPEG q92).
#
# Label layout: cls = shape_id * 10 + family_id * 2 + fill_id. The small/
# medium/large SIZE_BUCKETS quota is unchanged, so per-size AP stays real.
# ---------------------------------------------------------------------------

# (name, hue_lo_deg, hue_hi_deg); red wraps around 360.
COLOR_FAMILIES = (
    ("red", 350.0, 375.0),
    ("yellow", 40.0, 65.0),
    ("green", 100.0, 140.0),
    ("blue", 200.0, 240.0),
    ("magenta", 285.0, 320.0),
)

FILL_PATTERNS = ("solid", "striped")

SHAPE80_CLASSES = tuple(
    f"{shape}_{family}_{fill}"
    for shape in SHAPE_CLASSES
    for family, _, _ in COLOR_FAMILIES
    for fill in FILL_PATTERNS
)


def class_names_for(num_classes: int) -> Tuple[str, ...]:
    """Class-name tuple for a supported taxonomy size (8 or 80)."""
    if num_classes == len(SHAPE_CLASSES):
        return SHAPE_CLASSES
    if num_classes == len(SHAPE80_CLASSES):
        return SHAPE80_CLASSES
    raise ValueError(
        f"unsupported taxonomy size {num_classes}; expected 8 or 80"
    )


def _hsv_to_rgb(h_deg: float, s: float, v: float) -> np.ndarray:
    """Scalar HSV (h in degrees) -> RGB float32 in [0, 255]."""
    h = (h_deg % 360.0) / 60.0
    i = int(h) % 6
    f = h - int(h)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    rgb = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))[i]
    return np.asarray(rgb, np.float32) * 255.0


def _sample_family_color(rng: np.random.Generator, family_id: int) -> np.ndarray:
    """Sample an RGB color inside a hue-band family (sat/value jittered)."""
    _, lo, hi = COLOR_FAMILIES[family_id]
    hue = float(rng.uniform(lo, hi))
    sat = float(rng.uniform(0.78, 1.0))
    val = float(rng.uniform(0.78, 1.0))
    return _hsv_to_rgb(hue, sat, val)


def _apply_stripes(img: np.ndarray, stamp: np.ndarray, cx: float, cy: float,
                   s: float, stripe_theta: float) -> None:
    """Darken alternating parallel bands inside an instance mask.

    Multiplicative (x0.35) so hue — the color-family signal — is preserved in
    both bands. Period >= 4 px keeps stripes legible on COCO-small instances.
    """
    ys, xs = np.nonzero(stamp)
    if ys.size == 0:
        return
    period = float(np.clip(0.55 * s, 4.0, 22.0))
    c, si = np.cos(stripe_theta), np.sin(stripe_theta)
    phase = (xs - cx) * c + (ys - cy) * si
    dark = (np.floor(phase / (period / 2.0)).astype(np.int64) % 2) == 0
    sel_y, sel_x = ys[dark], xs[dark]
    img[sel_y, sel_x] = (img[sel_y, sel_x].astype(np.float32) * 0.35
                         ).astype(img.dtype)

# Saturated foreground palette (BGR-agnostic; stored RGB). Class-independent.
_PALETTE = np.asarray(
    [
        (230, 60, 50),
        (60, 200, 60),
        (60, 90, 235),
        (240, 200, 40),
        (230, 60, 220),
        (40, 220, 220),
        (250, 140, 30),
        (150, 70, 240),
        (240, 240, 240),
        (110, 250, 130),
    ],
    np.float32,
)


def _poly_points(cls: str, cx: float, cy: float, s: float, theta: float,
                 aspect: float) -> Optional[np.ndarray]:
    """Vertex list for polygonal classes (None for curved classes)."""
    if cls == "square":
        pts = np.asarray([(-1, -1), (1, -1), (1, 1), (-1, 1)], np.float32) * s
    elif cls == "rectangle":
        pts = np.asarray([(-1, -1), (1, -1), (1, 1), (-1, 1)], np.float32)
        pts = pts * np.asarray([s, s * aspect], np.float32)
    elif cls == "triangle":
        ang = np.asarray([np.pi / 2, np.pi / 2 + 2 * np.pi / 3,
                          np.pi / 2 + 4 * np.pi / 3], np.float32)
        pts = np.stack([np.cos(ang), -np.sin(ang)], 1) * s
    elif cls == "cross":
        t = 0.36  # arm half-thickness relative to s
        a, b = s, s * t
        pts = np.asarray(
            [(-b, -a), (b, -a), (b, -b), (a, -b), (a, b), (b, b),
             (b, a), (-b, a), (-b, b), (-a, b), (-a, -b), (-b, -b)],
            np.float32,
        )
    elif cls == "star":
        outer, inner = s, 0.45 * s
        ang = np.pi / 2 + np.arange(10, dtype=np.float32) * np.pi / 5
        rad = np.where(np.arange(10) % 2 == 0, outer, inner).astype(np.float32)
        pts = np.stack([rad * np.cos(ang), -rad * np.sin(ang)], 1)
    else:
        return None
    c, si = np.cos(theta), np.sin(theta)
    rot = np.asarray([[c, -si], [si, c]], np.float32)
    return pts @ rot.T + np.asarray([cx, cy], np.float32)


def _draw_shape(img: np.ndarray, cls: str, cx: float, cy: float, s: float,
                theta: float, aspect: float, color: Tuple[int, int, int],
                ) -> Tuple[float, float, float, float]:
    """Draw one instance; return its tight pixel bbox as (x, y, w, h)."""
    import cv2

    col = tuple(int(v) for v in color)
    pts = _poly_points(cls, cx, cy, s, theta, aspect)
    if pts is not None:
        ipts = np.round(pts).astype(np.int32)
        cv2.fillPoly(img, [ipts], col, lineType=cv2.LINE_AA)
        x1, y1 = pts.min(0)
        x2, y2 = pts.max(0)
    elif cls == "circle":
        cv2.circle(img, (int(round(cx)), int(round(cy))), int(round(s)), col,
                   -1, lineType=cv2.LINE_AA)
        x1, y1, x2, y2 = cx - s, cy - s, cx + s, cy + s
    elif cls == "ellipse":
        ax = (int(round(s)), int(round(s * aspect)))
        deg = float(np.degrees(theta))
        cv2.ellipse(img, (int(round(cx)), int(round(cy))), ax, deg, 0, 360,
                    col, -1, lineType=cv2.LINE_AA)
        # Tight bbox of a rotated ellipse: half-axes projected onto x/y.
        c, si = np.cos(theta), np.sin(theta)
        hx = float(np.hypot(s * c, s * aspect * si))
        hy = float(np.hypot(s * si, s * aspect * c))
        x1, y1, x2, y2 = cx - hx, cy - hy, cx + hx, cy + hy
    elif cls == "ring":
        r_out = int(round(s))
        thickness = max(2, int(round(s * 0.28)))
        cv2.circle(img, (int(round(cx)), int(round(cy))), r_out, col,
                   thickness, lineType=cv2.LINE_AA)
        half = s + thickness / 2.0
        x1, y1, x2, y2 = cx - half, cy - half, cx + half, cy + half
    else:  # pragma: no cover — guarded by SHAPE_CLASSES
        raise ValueError(f"unknown shape class: {cls}")
    return float(x1), float(y1), float(x2 - x1), float(y2 - y1)


def _background(rng: np.random.Generator, size: int) -> np.ndarray:
    """Cluttered but desaturated background: gradient + noise + distractors."""
    import cv2

    # Low-frequency color field (upsampled coarse noise), kept dim so the
    # saturated foreground palette always contrasts.
    coarse = rng.uniform(30, 140, (4, 4, 3)).astype(np.float32)
    bg = cv2.resize(coarse, (size, size), interpolation=cv2.INTER_CUBIC)
    bg = bg + rng.normal(0, 9, (size, size, 3)).astype(np.float32)
    img = np.clip(bg, 0, 255).astype(np.uint8)

    # Unlabeled distractors: thin lines + small specks (below detector scale).
    for _ in range(int(rng.integers(2, 7))):
        p1 = tuple(int(v) for v in rng.integers(0, size, 2))
        p2 = tuple(int(v) for v in rng.integers(0, size, 2))
        col = tuple(int(v) for v in rng.uniform(40, 170, 3))
        cv2.line(img, p1, p2, col, 1, lineType=cv2.LINE_AA)
    for _ in range(int(rng.integers(4, 12))):
        c = tuple(int(v) for v in rng.integers(0, size, 2))
        col = tuple(int(v) for v in rng.uniform(40, 170, 3))
        cv2.circle(img, c, int(rng.integers(1, 5)), col, -1,
                   lineType=cv2.LINE_AA)
    return img


def _iou_xywh(a: np.ndarray, b: np.ndarray) -> float:
    ax1, ay1, ax2, ay2 = a[0], a[1], a[0] + a[2], a[1] + a[3]
    bx1, by1, bx2, by2 = b[0], b[1], b[0] + b[2], b[1] + b[3]
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


# Size buckets as (probability, lo, hi) of the half-extent as a fraction of
# the image side. At generation size 640 these give boxes of ~10-32 px
# (COCO-small), ~33-96 px (COCO-medium), ~97-205 px (COCO-large).
SIZE_BUCKETS = (
    (0.30, 0.008, 0.025),
    (0.40, 0.026, 0.075),
    (0.30, 0.076, 0.160),
)


def _sample_half_extent(rng: np.random.Generator, size: int) -> float:
    u = float(rng.uniform())
    acc = 0.0
    for p, lo, hi in SIZE_BUCKETS:
        acc += p
        if u <= acc:
            return max(float(rng.uniform(lo, hi)) * size, 3.0)
    p, lo, hi = SIZE_BUCKETS[-1]
    return max(float(rng.uniform(lo, hi)) * size, 3.0)


def generate_image(
    rng: np.random.Generator,
    size: int = 416,
    min_shapes: int = 2,
    max_shapes: int = 12,
    max_overlap: float = 0.40,
    with_dense: bool = False,
    num_classes: int = 8,
):
    """One synthetic frame.

    Returns ``(image_rgb_uint8 [size,size,3], boxes_xywh_px [N,4] float32,
    labels [N] int32)`` with labels indexing :data:`SHAPE_CLASSES` (the
    default ``num_classes=8``) or :data:`SHAPE80_CLASSES`
    (``num_classes=80``, the reference-scale taxonomy — 80-way like COCO,
    reference: src/data/dataset.py:428-450). The 8-class path draws the
    identical RNG sequence it always has, so existing datasets regenerate
    byte-identically.

    With ``with_dense=True`` additionally returns ``(seg_mask, depth)``:
    ``seg_mask`` [size,size] uint8 class-id+1 per pixel (0 = background, exact
    by construction — the generator re-draws each instance onto an id canvas),
    and ``depth`` [size,size] float32 meters (background 10 m; each instance
    at a distance inversely proportional to its drawn size, the same pinhole
    model the SafetyMonitor assumes). Targets for the segmentation/depth
    heads (reference: src/models/hybrid_vision.py:131-156).
    """
    if num_classes not in (8, 80):
        raise ValueError(f"unsupported num_classes {num_classes}")
    eighty = num_classes == 80
    img = _background(rng, size)
    seg = np.zeros((size, size), np.uint8) if with_dense else None
    depth = np.full((size, size), 10.0, np.float32) if with_dense else None
    n = int(rng.integers(min_shapes, max_shapes + 1))
    boxes: List[np.ndarray] = []
    labels: List[int] = []
    for _ in range(n):
        for _attempt in range(20):
            cls_id = int(rng.integers(0, num_classes))
            if eighty:
                shape_id, family_id, fill_id = (
                    cls_id // 10, (cls_id % 10) // 2, cls_id % 2)
            else:
                shape_id, family_id, fill_id = cls_id, -1, 0
            cls = SHAPE_CLASSES[shape_id]
            s = _sample_half_extent(rng, size)  # half-extent in px
            margin = 1.35 * s + 2
            cx = float(rng.uniform(margin, size - margin))
            cy = float(rng.uniform(margin, size - margin))
            theta = float(rng.uniform(0, 2 * np.pi))
            if cls in ("circle", "ring"):
                theta = 0.0
            aspect = float(rng.uniform(0.45, 0.7))
            # Dry-run bbox (draw on scratch is wasteful; bbox math is exact).
            pts = _poly_points(cls, cx, cy, s, theta, aspect)
            if pts is not None:
                bb = np.asarray([pts[:, 0].min(), pts[:, 1].min(),
                                 np.ptp(pts[:, 0]), np.ptp(pts[:, 1])],
                                np.float32)
            elif cls == "ellipse":
                c, si = np.cos(theta), np.sin(theta)
                hx = float(np.hypot(s * c, s * aspect * si))
                hy = float(np.hypot(s * si, s * aspect * c))
                bb = np.asarray([cx - hx, cy - hy, 2 * hx, 2 * hy], np.float32)
            else:
                half = s * (1.14 if cls == "ring" else 1.0)
                bb = np.asarray([cx - half, cy - half, 2 * half, 2 * half],
                                np.float32)
            if all(_iou_xywh(bb, b) <= max_overlap for b in boxes):
                if eighty:
                    color = _sample_family_color(rng, family_id)
                    stripe_theta = float(rng.uniform(0, np.pi))
                else:
                    color = _PALETTE[int(rng.integers(0, len(_PALETTE)))]
                    color = np.clip(color + rng.normal(0, 12, 3), 0, 255)
                    stripe_theta = 0.0
                bbox = _draw_shape(img, cls, cx, cy, s, theta, aspect,
                                   tuple(color))
                stamp = None
                if with_dense or fill_id == 1:
                    # Exact instance mask: re-draw on an id canvas (AA-free
                    # boundary differences are below label tolerance).
                    stamp = np.zeros((size, size), np.uint8)
                    _draw_shape(stamp, cls, cx, cy, s, theta, aspect, (1,))
                if fill_id == 1:
                    _apply_stripes(img, stamp, cx, cy, s, stripe_theta)
                if with_dense:
                    covered = stamp > 0
                    seg[covered] = cls_id + 1
                    # Pinhole distance: bigger drawn size = closer.
                    depth[covered] = float(
                        np.clip(0.4 * size / (2.0 * s), 0.5, 9.5)
                    )
                boxes.append(np.asarray(bbox, np.float32))
                labels.append(cls_id)
                break
    if not boxes:  # extremely unlikely; keep the invariant n >= 1
        bbox = _draw_shape(img, "circle", size / 2, size / 2, size * 0.1,
                           0.0, 1.0, tuple(_PALETTE[0]))
        boxes.append(np.asarray(bbox, np.float32))
        labels.append(0)
        if with_dense:
            stamp = np.zeros((size, size), np.uint8)
            _draw_shape(stamp, "circle", size / 2, size / 2, size * 0.1,
                        0.0, 1.0, (1,))
            seg[stamp > 0] = 1
            depth[stamp > 0] = 2.0
    if with_dense:
        return img, np.stack(boxes), np.asarray(labels, np.int32), seg, depth
    return img, np.stack(boxes), np.asarray(labels, np.int32)


def _write_split(
    root: str,
    split: str,
    num_images: int,
    size: int,
    seed: int,
    jpeg_quality: int = 92,
    with_dense: bool = False,
    num_classes: int = 8,
) -> str:
    import cv2

    img_dir = os.path.join(root, split)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    if with_dense:
        os.makedirs(os.path.join(root, "masks", split), exist_ok=True)
        os.makedirs(os.path.join(root, "depth", split), exist_ok=True)

    images, annotations = [], []
    ann_id = 1
    for i in range(num_images):
        # Independent stream per image: any subset regenerates identically.
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        if with_dense:
            img, boxes, labels, seg, depth = generate_image(
                rng, size=size, with_dense=True, num_classes=num_classes
            )
        else:
            img, boxes, labels = generate_image(
                rng, size=size, num_classes=num_classes
            )
        fname = f"{split}_{i:06d}.jpg"
        cv2.imwrite(
            os.path.join(img_dir, fname),
            cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
            [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality],
        )
        if with_dense:
            stem = fname.replace(".jpg", ".png")
            cv2.imwrite(os.path.join(root, "masks", split, stem), seg)
            # Depth as 16-bit PNG millimeters (lossless, standard encoding).
            cv2.imwrite(
                os.path.join(root, "depth", split, stem),
                np.clip(depth * 1000.0, 0, 65535).astype(np.uint16),
            )
        image_id = i + 1
        images.append({"id": image_id, "file_name": fname,
                       "width": size, "height": size})
        for b, lab in zip(boxes, labels):
            # Clip to the frame so areas/IoUs match what is actually visible.
            x1 = float(np.clip(b[0], 0, size))
            y1 = float(np.clip(b[1], 0, size))
            x2 = float(np.clip(b[0] + b[2], 0, size))
            y2 = float(np.clip(b[1] + b[3], 0, size))
            annotations.append({
                "id": ann_id,
                "image_id": image_id,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "category_id": int(lab) + 1,  # COCO ids are 1-based
                "area": (x2 - x1) * (y2 - y1),
                "iscrowd": 0,
            })
            ann_id += 1

    ann_path = os.path.join(ann_dir, f"instances_{split}.json")
    with open(ann_path, "w") as f:
        json.dump({
            "info": {"description": f"hvs_tpu synthetic shapes ({split})",
                     "seed": seed, "size": size},
            "images": images,
            "annotations": annotations,
            "categories": [
                {"id": i + 1, "name": name, "supercategory": "shape"}
                for i, name in enumerate(class_names_for(num_classes))
            ],
        }, f)
    return ann_path


def generate_dataset(
    root: str,
    num_train: int = 4000,
    num_val: int = 500,
    size: int = 416,
    seed: int = 0,
    with_dense: bool = False,
    num_classes: int = 8,
) -> Dict[str, str]:
    """Generate the full benchmark; returns {split: annotation_path}.

    ``with_dense=True`` also writes per-pixel class masks (masks/<split>/*.png,
    uint8 class-id+1) and depth maps (depth/<split>/*.png, uint16 mm) for the
    segmentation/depth heads. ``num_classes=80`` selects the reference-scale
    shape x color-family x fill taxonomy (:data:`SHAPE80_CLASSES`)."""
    return {
        "train": _write_split(root, "train", num_train, size, seed,
                              with_dense=with_dense, num_classes=num_classes),
        # Disjoint stream for val (never reuses a train image).
        "val": _write_split(root, "val", num_val, size, seed + 1_000_003,
                            with_dense=with_dense, num_classes=num_classes),
    }
