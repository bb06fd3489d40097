"""Box-aware augmentations: the numpy host pipeline and a torch batch
augmentation on the images' device.

Counterpart of ``hvs_tpu/data/transforms.py``. The host transforms (numpy
and cv2, copied) take and return ``(image HWC uint8, boxes [N, 4] pixel
xywh, labels)`` and draw from the ``np.random.Generator`` they are given:
``hflip``, ``color_jitter``, ``random_resized_crop``, ``rotate_small``,
``random_erasing``, ``mosaic``, ``mixup``, composed per sample by
``MHCTransformComposer`` with the optional ``AdaptiveAugmentation`` decay.

``batch_augment_device`` is the reference's on-device batch augmentation
(flip, brightness and contrast per image) in torch, on the device the
images are on. It draws from an explicit ``torch.Generator`` where the
reference takes a JAX key; ``draw_batch_augment`` makes the draws and
``apply_batch_augment`` is the deterministic rest, so a test can feed the
reference's own draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


Sample = Tuple[np.ndarray, np.ndarray, np.ndarray]


def hflip(image, boxes, labels, rng) -> Sample:
    image = image[:, ::-1].copy()
    if len(boxes):
        w = image.shape[1]
        boxes = boxes.copy()
        boxes[:, 0] = w - boxes[:, 0] - boxes[:, 2]
    return image, boxes, labels


def color_jitter(image, boxes, labels, rng, strength=0.4) -> Sample:
    img = image.astype(np.float32)
    img = img * rng.uniform(1 - strength, 1 + strength)  # brightness
    mean = img.mean()
    img = (img - mean) * rng.uniform(1 - strength, 1 + strength) + mean  # contrast
    # saturation: blend with grayscale
    gray = img.mean(axis=2, keepdims=True)
    img = gray + (img - gray) * rng.uniform(1 - strength, 1 + strength)
    return np.clip(img, 0, 255).astype(np.uint8), boxes, labels


def random_resized_crop(image, boxes, labels, rng, min_scale=0.6) -> Sample:
    h, w = image.shape[:2]
    scale = rng.uniform(min_scale, 1.0)
    ch, cw = int(h * scale), int(w * scale)
    y0 = rng.integers(0, h - ch + 1)
    x0 = rng.integers(0, w - cw + 1)
    crop = image[y0 : y0 + ch, x0 : x0 + cw]
    if len(boxes):
        b = boxes.copy()
        x1 = np.clip(b[:, 0] - x0, 0, cw)
        y1 = np.clip(b[:, 1] - y0, 0, ch)
        x2 = np.clip(b[:, 0] + b[:, 2] - x0, 0, cw)
        y2 = np.clip(b[:, 1] + b[:, 3] - y0, 0, ch)
        nb = np.stack([x1, y1, x2 - x1, y2 - y1], axis=1)
        keep = (nb[:, 2] > 2) & (nb[:, 3] > 2)
        boxes, labels = nb[keep], labels[keep]
    return crop, boxes, labels


def rotate_small(image, boxes, labels, rng, max_degrees=5.0) -> Sample:
    """Small-angle rotation; boxes follow via rotated-corner AABB."""
    import cv2

    angle = rng.uniform(-max_degrees, max_degrees)
    h, w = image.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    image = cv2.warpAffine(image, m, (w, h), borderValue=(114, 114, 114))
    if len(boxes):
        b = boxes
        corners = np.stack(
            [
                np.stack([b[:, 0], b[:, 1]], 1),
                np.stack([b[:, 0] + b[:, 2], b[:, 1]], 1),
                np.stack([b[:, 0], b[:, 1] + b[:, 3]], 1),
                np.stack([b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]], 1),
            ],
            axis=1,
        )  # [N, 4, 2]
        ones = np.ones((*corners.shape[:2], 1))
        rot = np.concatenate([corners, ones], -1) @ m.T  # [N, 4, 2]
        x1 = np.clip(rot[..., 0].min(1), 0, w)
        y1 = np.clip(rot[..., 1].min(1), 0, h)
        x2 = np.clip(rot[..., 0].max(1), 0, w)
        y2 = np.clip(rot[..., 1].max(1), 0, h)
        boxes = np.stack([x1, y1, x2 - x1, y2 - y1], 1)
        keep = (boxes[:, 2] > 2) & (boxes[:, 3] > 2)
        boxes, labels = boxes[keep], labels[keep]
    return image, boxes, labels


def random_erasing(image, boxes, labels, rng, max_frac=0.15) -> Sample:
    """Cutout-style erasing of one rectangle with one random grey value."""
    h, w = image.shape[:2]
    eh = int(h * rng.uniform(0.05, max_frac))
    ew = int(w * rng.uniform(0.05, max_frac))
    y0 = rng.integers(0, max(h - eh, 1))
    x0 = rng.integers(0, max(w - ew, 1))
    image = image.copy()
    image[y0 : y0 + eh, x0 : x0 + ew] = rng.integers(0, 255)
    return image, boxes, labels


def mosaic(samples: Sequence[Sample], rng, out_size: Optional[int] = None) -> Sample:
    """4-image mosaic: each sample resized into one quadrant, boxes
    scaled and offset with it."""
    import cv2

    assert len(samples) == 4
    size = out_size or max(s[0].shape[0] for s in samples)
    half = size // 2
    canvas = np.full((size, size, 3), 114, np.uint8)
    all_boxes, all_labels = [], []
    offsets = [(0, 0), (half, 0), (0, half), (half, half)]
    for (img, boxes, labels), (ox, oy) in zip(samples, offsets):
        resized = cv2.resize(img, (half, half))
        sx = half / img.shape[1]
        sy = half / img.shape[0]
        canvas[oy : oy + half, ox : ox + half] = resized
        if len(boxes):
            b = boxes.copy().astype(np.float32)
            b[:, 0] = b[:, 0] * sx + ox
            b[:, 1] = b[:, 1] * sy + oy
            b[:, 2] *= sx
            b[:, 3] *= sy
            all_boxes.append(b)
            all_labels.append(labels)
    boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4), np.float32)
    labels = np.concatenate(all_labels) if all_labels else np.zeros((0,), np.int32)
    return canvas, boxes, labels


def mixup(a: Sample, b: Sample, rng, alpha=0.2) -> Sample:
    """Mixup: blend two images (weight max(lam, 1 - lam), lam ~
    Beta(alpha, alpha)) and take the union of their boxes."""
    import cv2

    lam = float(rng.beta(alpha, alpha))
    lam = max(lam, 1 - lam)
    img_b = cv2.resize(b[0], (a[0].shape[1], a[0].shape[0]))
    img = (a[0].astype(np.float32) * lam + img_b.astype(np.float32) * (1 - lam))
    sx = a[0].shape[1] / b[0].shape[1]
    sy = a[0].shape[0] / b[0].shape[0]
    bb = b[1].copy().astype(np.float32)
    if len(bb):
        bb[:, 0] *= sx
        bb[:, 2] *= sx
        bb[:, 1] *= sy
        bb[:, 3] *= sy
    boxes = np.concatenate([a[1], bb]) if len(a[1]) or len(bb) else a[1]
    labels = np.concatenate([a[2], b[2]]) if len(a[2]) or len(b[2]) else a[2]
    return np.clip(img, 0, 255).astype(np.uint8), boxes, labels


@dataclass
class AdaptiveAugmentation:
    """Linear augmentation-strength decay over epochs."""

    initial_strength: float = 1.0
    final_strength: float = 0.2
    decay_epochs: int = 100
    epoch: int = 0

    def step_epoch(self) -> float:
        self.epoch += 1
        return self.strength

    @property
    def strength(self) -> float:
        t = min(self.epoch / max(self.decay_epochs, 1), 1.0)
        return self.initial_strength + t * (self.final_strength - self.initial_strength)


class MHCTransformComposer:
    """The per-sample host pipeline: flip, colour jitter, random resized crop,
    small rotation and random erasing, each with its probability (scaled by
    the adaptive strength). One ``np.random.Generator`` draws for every call,
    so loader threads that share a composer draw in their own order."""

    def __init__(
        self,
        horizontal_flip: float = 0.5,
        color_jitter_p: float = 0.4,
        random_crop_p: float = 0.3,
        rotation_degrees: float = 5.0,
        random_erasing_p: float = 0.2,
        adaptive: Optional[AdaptiveAugmentation] = None,
        seed: int = 0,
    ):
        self.p_flip = horizontal_flip
        self.p_jitter = color_jitter_p
        self.p_crop = random_crop_p
        self.rot_deg = rotation_degrees
        self.p_erase = random_erasing_p
        self.adaptive = adaptive
        self.rng = np.random.default_rng(seed)

    @classmethod
    def train_default(cls, image_size: int, aug_config=None) -> "MHCTransformComposer":
        if aug_config is None:
            return cls()
        return cls(
            horizontal_flip=aug_config.horizontal_flip,
            color_jitter_p=aug_config.color_jitter,
            random_crop_p=aug_config.random_crop,
            rotation_degrees=aug_config.rotation_degrees,
            random_erasing_p=aug_config.random_erasing,
            adaptive=(
                AdaptiveAugmentation(decay_epochs=aug_config.adaptive_decay_epochs)
                if getattr(aug_config, "adaptive_decay_epochs", 0)
                else None
            ),
        )

    def __call__(self, image, boxes, labels) -> Sample:
        rng = self.rng
        s = self.adaptive.strength if self.adaptive else 1.0
        if rng.uniform() < self.p_flip * s:
            image, boxes, labels = hflip(image, boxes, labels, rng)
        if rng.uniform() < self.p_jitter * s:
            image, boxes, labels = color_jitter(image, boxes, labels, rng)
        if rng.uniform() < self.p_crop * s:
            image, boxes, labels = random_resized_crop(image, boxes, labels, rng)
        if self.rot_deg > 0 and rng.uniform() < 0.3 * s:
            image, boxes, labels = rotate_small(image, boxes, labels, rng, self.rot_deg)
        if rng.uniform() < self.p_erase * s:
            image, boxes, labels = random_erasing(image, boxes, labels, rng)
        return image, boxes, labels


class BatchAugmentDraws(NamedTuple):
    """The random numbers of one ``batch_augment_device`` call, each
    [B, 1, 1, 1]: a uniform draw in [0, 1) for the flip, and the brightness
    and contrast factors in [1 - jitter, 1 + jitter)."""

    flip_u: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor


def draw_batch_augment(batch: int, generator: torch.Generator, jitter: float = 0.2
                       ) -> BatchAugmentDraws:
    """The draws of one call, made by ``generator`` on its own device."""
    def u(lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        r = torch.rand((batch, 1, 1, 1), generator=generator, device=generator.device)
        return lo + (hi - lo) * r

    return BatchAugmentDraws(u(), u(1 - jitter, 1 + jitter), u(1 - jitter, 1 + jitter))


def apply_batch_augment(images: torch.Tensor, draws: BatchAugmentDraws, flip_p: float = 0.5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip the images whose draw is below ``flip_p`` (along the width),
    then ``(x * brightness - mean) * contrast + mean`` with each image's
    mean over all its pixels and channels. Returns (images, flipped [B])."""
    dev = images.device
    do_flip = draws.flip_u.to(dev) < flip_p
    images = torch.where(do_flip, images.flip(2), images)
    mean = images.mean(dim=(1, 2, 3), keepdim=True)
    images = (images * draws.brightness.to(dev) - mean) * draws.contrast.to(dev) + mean
    return images, do_flip[:, 0, 0, 0]


def batch_augment_device(images: torch.Tensor, generator: torch.Generator,
                         flip_p: float = 0.5, jitter: float = 0.2
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch augmentation on the images' device: horizontal flip and
    brightness and contrast per image. ``images``: [B, H, W, C] float. Only
    box-safe transforms; the caller mirrors the boxes of the flipped images
    (the returned [B] mask)."""
    return apply_batch_augment(images, draw_batch_augment(images.shape[0], generator, jitter),
                               flip_p)
