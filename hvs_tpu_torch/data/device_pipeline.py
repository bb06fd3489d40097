"""The dataset in device memory, with each training batch drawn and augmented
on the device.

Counterpart of ``hvs_tpu/data/device_pipeline.py``. The images (uint8), the
padded boxes, labels and box mask of a whole split are uploaded once
(``put_device_data``); every train step then gathers a random batch and
applies horizontal flip, colour jitter and a random zoom/translate with the
boxes remapped, all as device ops with fixed shapes. Nothing reads a value
back to the host, so the sampler runs inside the captured train step of
``ManifoldConstrainedTrainer.train_chunked``.

The JAX ``sample_batch`` draws its random numbers and applies them in one
function. Here the two are split: ``draw_augment`` makes the draws from a
torch generator and ``apply_augment`` is the deterministic rest, so the
tests can feed JAX's own draws to the port. ``warp_images`` computes
``jax.image.scale_and_translate(method="linear", antialias=True)`` as two
batched products with per-sample weight matrices, built as
``jax/_src/image/scale.py::compute_weight_mat`` builds them.

``DenseData`` adds the segmentation and depth labels of the multi-task
model's data; its batches (``dense_batch``) are gathered rows, not
augmented, as the JAX multi-task script draws them.

``load_coco_arrays`` decodes a COCO-format split of square frames (the
shapes benchmark's) into the host arrays that ``put_device_data`` and
``put_dense_data`` upload; cv2 is imported only there.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from ..constants import IMAGENET_MEAN, IMAGENET_STD
from ..device import DeviceLike, device_constant, resolve_device

Tensor = torch.Tensor
_FP32_EPS = float(np.finfo(np.float32).eps)


class DeviceData(NamedTuple):
    """A split resident on one device."""

    images: Tensor  # [N, S, S, 3] uint8
    boxes: Tensor   # [N, M, 4] float32 normalized cxcywh
    labels: Tensor  # [N, M] int32
    mask: Tensor    # [N, M] float32 (1 = real box)


class DenseData(NamedTuple):
    """A split with the dense labels of the segmentation and depth heads,
    resident on one device (the multi-task model's training data)."""

    images: Tensor  # [N, S, S, 3] uint8
    boxes: Tensor   # [N, M, 4] float32 normalized cxcywh
    labels: Tensor  # [N, M] int32
    mask: Tensor    # [N, M] float32 (1 = real box)
    seg: Tensor     # [N, S, S] uint8 class id + 1 per pixel (0 = background)
    depth: Tensor   # [N, S, S] float32 metres


@dataclass(frozen=True)
class AugmentConfig:
    """On-device augmentation knobs; the JAX package's fields and defaults."""

    flip_prob: float = 0.5
    brightness: float = 0.2
    contrast: float = 0.25
    channel_gain: float = 0.08
    zoom_min: float = 0.6
    zoom_max: float = 1.5
    min_box_px: float = 3.0
    fill: float = 114.0 / 255.0  # letterbox pad colour


class AugmentDraws(NamedTuple):
    """The random numbers of one batch, as JAX's ``sample_batch`` draws them:
    the image indices, a flip flag per image, brightness and contrast
    [B, 1, 1, 1], per-channel gain [B, 1, 1, 3], the zoom factor [B], and the
    uniform fractions in [0, 1) [B] that place the zoomed frame along x and y."""

    idx: Tensor
    flip: Tensor
    brightness: Tensor
    contrast: Tensor
    gain: Tensor
    zoom: Tensor
    tx: Tensor
    ty: Tensor


def load_coco_arrays(root: str, split: str, max_boxes: int = 64, limit: Optional[int] = None,
                     dense: bool = False):
    """Decode a COCO-format split of uniform square frames into stacked host
    arrays, for ``put_device_data``: images [N, S, S, 3] uint8 RGB, boxes
    [N, max_boxes, 4] normalized cxcywh, labels [N, max_boxes] int32 (the
    file's 1-based category ids minus one), mask [N, max_boxes] float32.

    ``dense=True`` also reads the class masks (``masks/<split>/*.png``,
    uint8) and depth maps (``depth/<split>/*.png``, uint16 mm -> float32 m)
    that ``data.shapes.generate_dataset(with_dense=True)`` writes, returned
    after the mask (for ``put_dense_data``). The first ``limit`` images when
    given; boxes beyond ``max_boxes`` are dropped."""
    import cv2

    ann_path = os.path.join(root, "annotations", f"instances_{split}.json")
    with open(ann_path) as f:
        ann = json.load(f)
    images_meta = ann["images"][:limit] if limit else ann["images"]
    by_image: Dict[int, list] = {m["id"]: [] for m in images_meta}
    for a in ann["annotations"]:
        if a["image_id"] in by_image:
            by_image[a["image_id"]].append(a)

    def read(path: str, flags: int = cv2.IMREAD_COLOR) -> np.ndarray:
        img = cv2.imread(path, flags)
        if img is None:
            raise FileNotFoundError(f"missing or unreadable image: {path}")
        return img

    n = len(images_meta)
    size = int(images_meta[0]["height"])
    images = np.empty((n, size, size, 3), np.uint8)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int32)
    mask = np.zeros((n, max_boxes), np.float32)
    seg = np.empty((n, size, size), np.uint8) if dense else None
    depth = np.empty((n, size, size), np.float32) if dense else None
    for i, meta in enumerate(images_meta):
        if meta["height"] != size or meta["width"] != size:
            raise ValueError(f"{meta['file_name']}: {meta['width']}x{meta['height']}; the "
                             f"device pipeline needs uniform square frames of {size}")
        images[i] = cv2.cvtColor(read(os.path.join(root, split, meta["file_name"])),
                                 cv2.COLOR_BGR2RGB)
        if dense:
            stem = meta["file_name"].replace(".jpg", ".png")
            seg[i] = read(os.path.join(root, "masks", split, stem), cv2.IMREAD_UNCHANGED)
            depth[i] = read(os.path.join(root, "depth", split, stem),
                            cv2.IMREAD_UNCHANGED).astype(np.float32) / 1000.0
        for j, a in enumerate(by_image[meta["id"]][:max_boxes]):
            x, y, w, h = a["bbox"]
            boxes[i, j] = ((x + w / 2) / size, (y + h / 2) / size, w / size, h / size)
            labels[i, j] = a["category_id"] - 1  # COCO ids are 1-based
            mask[i, j] = 1.0
    if dense:
        return images, boxes, labels, mask, seg, depth
    return images, boxes, labels, mask


def put_device_data(images: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                    mask: np.ndarray, device: DeviceLike = None) -> DeviceData:
    """Upload a split to ``device`` (the CUDA card unless ``device="cpu"``).
    Sharding over a mesh waits for ROADMAP queue 1 item 6."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    return DeviceData(put(images, np.uint8), put(boxes, np.float32), put(labels, np.int32),
                      put(mask, np.float32))


def put_dense_data(images: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                   mask: np.ndarray, seg: np.ndarray, depth: np.ndarray,
                   device: DeviceLike = None) -> DenseData:
    """Upload a split with dense labels to ``device`` (the CUDA card unless
    ``device="cpu"``)."""
    base = put_device_data(images, boxes, labels, mask, device)
    dev = base.images.device
    return DenseData(*base, torch.from_numpy(np.ascontiguousarray(seg, np.uint8)).to(dev),
                     torch.from_numpy(np.ascontiguousarray(depth, np.float32)).to(dev))


def dense_batch(data: DenseData, idx: Tensor) -> Dict[str, Tensor]:
    """The rows ``idx`` of ``data`` as a multi-task batch, no augmentation:
    normalized images, the boxes, and the dense labels (``seg_labels``
    int64, ``depth``) at the images' size."""
    imgs = data.images.index_select(0, idx).float() / 255.0
    return {"images": normalize(imgs), "boxes": data.boxes.index_select(0, idx),
            "labels": data.labels.index_select(0, idx),
            "box_mask": data.mask.index_select(0, idx),
            "seg_labels": data.seg.index_select(0, idx).long(),
            "depth": data.depth.index_select(0, idx)}


def normalize(imgs: Tensor) -> Tensor:
    """(imgs - ImageNet mean) / std over the channel axis."""
    mean = device_constant(("imagenet_mean",), imgs.device, lambda: IMAGENET_MEAN)
    std = device_constant(("imagenet_std",), imgs.device, lambda: IMAGENET_STD)
    return (imgs - mean) / std


def resize_weights(in_size: int, out_size: int, scale: Tensor, translation: Tensor) -> Tensor:
    """[B, out, in] linear-interpolation weights with antialiasing, one
    matrix per sample (JAX's ``compute_weight_mat``, transposed)."""
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    sample_f = (out_pos[None, :] + 0.5) * inv_scale - translation[:, None] * inv_scale - 0.5
    x = (sample_f[:, :, None] - in_pos[None, None, :]).abs() / kernel_scale[:, :, None]
    weights = torch.clamp(1.0 - x.abs(), min=0.0)  # the triangle kernel
    total = weights.sum(dim=2, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _FP32_EPS,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, torch.zeros_like(weights))


def warp_images(imgs: Tensor, scale: Tensor, tx: Tensor, ty: Tensor, out_size: int,
                fill: float) -> Tensor:
    """Per-sample zoom/translate of ``imgs`` [B, S, S, C] fp32 into an
    [B, out_size, out_size, C] frame: input pixel p lands at output pixel
    p·scale + t (``jax.image.scale_and_translate`` semantics, rows by ``ty``,
    columns by ``tx``); output pixels outside the zoomed source take the
    letterbox ``fill`` through an analytic coverage box."""
    b, s, _, c = imgs.shape
    o = out_size
    wy = resize_weights(s, o, scale, ty)  # [B, O, S]
    wx = resize_weights(s, o, scale, tx)
    rows = torch.bmm(wy, imgs.reshape(b, s, s * c)).reshape(b, o, s, c)
    cols = torch.bmm(wx, rows.transpose(1, 2).reshape(b, s, o * c))  # [B, O(x), O(y)*C]
    out = cols.reshape(b, o, o, c).transpose(1, 2)
    pos = torch.arange(o, dtype=torch.float32, device=imgs.device)
    span = s * scale[:, None]
    inside_x = (pos[None, :] >= tx[:, None]) & (pos[None, :] <= tx[:, None] + span)
    inside_y = (pos[None, :] >= ty[:, None]) & (pos[None, :] <= ty[:, None] + span)
    cov = (inside_y[:, :, None] & inside_x[:, None, :]).to(out.dtype)[..., None]
    return out * cov + fill * (1.0 - cov)


def draw_augment(generator: Optional[torch.Generator], batch: int, n: int,
                 aug: AugmentConfig = AugmentConfig(),
                 device: Union[str, torch.device, None] = None) -> AugmentDraws:
    """The random draws of one batch from ``generator`` (on ``device``, by
    default the generator's): indices uniform in [0, n), and the
    augmentation draws of ``apply_augment`` with the ranges of ``aug``."""
    dev = torch.device(device) if device is not None else generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    return AugmentDraws(
        idx=torch.randint(0, n, (batch,), generator=generator, device=dev),
        flip=torch.rand((batch,), generator=generator, device=dev) < aug.flip_prob,
        brightness=uniform((batch, 1, 1, 1), -aug.brightness, aug.brightness),
        contrast=uniform((batch, 1, 1, 1), 1 - aug.contrast, 1 + aug.contrast),
        gain=uniform((batch, 1, 1, 3), 1 - aug.channel_gain, 1 + aug.channel_gain),
        zoom=uniform((batch,), aug.zoom_min, aug.zoom_max),
        tx=torch.rand((batch,), generator=generator, device=dev),
        ty=torch.rand((batch,), generator=generator, device=dev),
    )


def apply_augment(data: DeviceData, draws: AugmentDraws, out_size: int,
                  aug: AugmentConfig = AugmentConfig(), augment: bool = True
                  ) -> Dict[str, Tensor]:
    """The deterministic part of JAX's ``sample_batch``: gather the drawn
    images and their boxes, then (``augment``) colour jitter, flip, and the
    zoom/translate into the ``out_size`` frame with the boxes clipped to it
    and those that shrank under ``min_box_px`` or left it masked out;
    without ``augment`` only a resize to ``out_size``.

    Returns the trainer's batch: normalized fp32 images [B, O, O, 3],
    normalized cxcywh boxes [B, M, 4], labels [B, M], box_mask [B, M].
    """
    s = data.images.shape[1]
    idx = draws.idx
    b = idx.shape[0]
    imgs = data.images.index_select(0, idx).float() / 255.0
    boxes = data.boxes.index_select(0, idx)
    labels = data.labels.index_select(0, idx)
    mask = data.mask.index_select(0, idx)
    if augment:
        mean_px = imgs.mean(dim=(1, 2, 3), keepdim=True)
        imgs = (imgs - mean_px) * draws.contrast + mean_px + draws.brightness
        imgs = torch.clamp(imgs * draws.gain, 0.0, 1.0)
        imgs = torch.where(draws.flip[:, None, None, None], imgs.flip(2), imgs)
        cx = torch.where(draws.flip[:, None], 1.0 - boxes[..., 0], boxes[..., 0])
        boxes = torch.cat([cx[..., None], boxes[..., 1:]], dim=-1)

        scale = draws.zoom * out_size / s
        free = out_size - s * scale
        t_lo, t_hi = torch.clamp(free, max=0.0), torch.clamp(free, min=0.0)
        tx = t_lo + draws.tx * (t_hi - t_lo)
        ty = t_lo + draws.ty * (t_hi - t_lo)
        imgs = warp_images(imgs, scale, tx, ty, out_size, aug.fill)

        k = s * scale[:, None]
        cxp = (boxes[..., 0] * k + tx[:, None]) / out_size
        cyp = (boxes[..., 1] * k + ty[:, None]) / out_size
        wp = boxes[..., 2] * k / out_size
        hp = boxes[..., 3] * k / out_size
        x1 = torch.clamp(cxp - wp / 2, 0.0, 1.0)
        y1 = torch.clamp(cyp - hp / 2, 0.0, 1.0)
        x2 = torch.clamp(cxp + wp / 2, 0.0, 1.0)
        y2 = torch.clamp(cyp + hp / 2, 0.0, 1.0)
        boxes = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)
        min_frac = aug.min_box_px / out_size
        visible = (boxes[..., 2] > min_frac) & (boxes[..., 3] > min_frac)
        mask = mask * visible.to(mask.dtype)
    elif out_size != s:
        scale = torch.full((b,), out_size / s, dtype=torch.float32, device=imgs.device)
        zero = torch.zeros((b,), dtype=torch.float32, device=imgs.device)
        imgs = warp_images(imgs, scale, zero, zero, out_size, aug.fill)
        # Normalized boxes do not change under a uniform resize.
    return {"images": normalize(imgs), "boxes": boxes, "labels": labels, "box_mask": mask}


def eval_batch(data: DeviceData, start: Union[int, Tensor], batch_size: int, out_size: int,
               fill: float = 114.0 / 255.0) -> Dict[str, Tensor]:
    """The contiguous validation batch of rows [start, start + batch_size),
    resized to ``out_size``, no augmentation. ``start`` may be a 0-dim
    integer tensor on the data's device, so that one captured graph serves
    every batch of a split."""
    s = data.images.shape[1]
    dev = data.images.device
    idx = start + torch.arange(batch_size, device=dev)
    imgs = data.images.index_select(0, idx).float() / 255.0
    if out_size != s:
        scale = torch.full((batch_size,), out_size / s, dtype=torch.float32, device=dev)
        zero = torch.zeros((batch_size,), dtype=torch.float32, device=dev)
        imgs = warp_images(imgs, scale, zero, zero, out_size, fill)
    return {"images": normalize(imgs), "boxes": data.boxes.index_select(0, idx),
            "labels": data.labels.index_select(0, idx),
            "box_mask": data.mask.index_select(0, idx)}
