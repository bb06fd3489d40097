"""Letterboxing, and the host dataset over a JSON annotation file.

``letterbox`` and ``letterbox_raw_batch`` are the counterparts of
``hvs_tpu/data/dataset.py::letterbox`` and of the raw-frame preprocessing
inside ``hvs_tpu/inference/engine.py``'s serve program, for the engine. The
geometry is the reference's: scale = S / max(h, w), the resized size rounded,
the padding centred (floor of half the slack on the left and top). Both
resize in torch (bilinear, half-pixel centres, no antialias) on the device
the image is on; cv2 is not needed.

``BaseVisionDataset`` (with ``load_image`` and ``letterbox_cv2``) is the
counterpart of the reference's host dataset: numpy samples with targets
padded to ``max_boxes``. It letterboxes with cv2's ``INTER_LINEAR`` exactly
as the reference does (``letterbox_cv2``), so its pixels equal the
reference's; cv2 is imported only when an image is decoded or resized.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import COCO_CLASSES, IMAGENET_MEAN, IMAGENET_STD

Image = Union[np.ndarray, torch.Tensor]


def letterbox_geometry(h: int, w: int, size: int) -> Tuple[float, Tuple[int, int],
                                                              Tuple[int, int]]:
    """(scale, (new_h, new_w), (pad_x, pad_y)) of an h x w image boxed into
    size x size."""
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return scale, (nh, nw), ((size - nw) // 2, (size - nh) // 2)


def _resize_nhwc(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of float NHWC maps, half-pixel centres, no antialias:
    ``jax.image.resize(..., "bilinear", antialias=False)`` and cv2's
    INTER_LINEAR sample the same points."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1)


def letterbox(image: Image, size: int, pad_value: int = 114
              ) -> Tuple[Image, float, Tuple[int, int]]:
    """Resize ``image`` [h, w, c] to fit ``size`` x ``size`` and pad it with
    ``pad_value``; returns (padded, scale, (pad_x, pad_y)).

    A numpy image comes back as numpy (computed on the CPU), a tensor as a
    tensor on its own device. uint8 images are resized in fp32 and rounded half up
    to uint8, as the reference's host letterbox rounds after its resize; the
    two agree within one grey level (cv2 and the native letterbox interpolate
    in fixed point or another summation order).
    """
    as_numpy = isinstance(image, np.ndarray)
    x = torch.from_numpy(np.ascontiguousarray(image)) if as_numpy else image
    h, w, c = x.shape
    scale, (nh, nw), (pad_x, pad_y) = letterbox_geometry(h, w, size)
    resized = x
    if (nh, nw) != (h, w):
        resized = _resize_nhwc(x[None].float(), (nh, nw))[0]
        if x.dtype == torch.uint8:
            resized = torch.floor(resized + 0.5).clamp_(0, 255)
        resized = resized.to(x.dtype)
    out = torch.full((size, size, c), pad_value, dtype=x.dtype, device=x.device)
    out[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    if as_numpy:
        out = out.cpu().numpy()
    return out, scale, (pad_x, pad_y)


def letterbox_raw_batch(images_u8: torch.Tensor, size: int, pad_value: int = 114,
                        bgr_to_rgb: bool = True) -> torch.Tensor:
    """The raw-frame preprocessing of the engine's serve graphs: uint8
    [B, h, w, 3] frames -> fp32 [B, size, size, 3] in [0, 1], letterboxed.

    As the reference's raw program (``hvs_tpu/inference/engine.py:483-503``):
    BGR -> RGB, divide by 255, bilinear resize (no antialias) when the size
    changes, then a canvas of ``pad_value / 255`` with the frame at the
    centred offset. Nothing is rounded to uint8 on this path.
    """
    x = images_u8
    if bgr_to_rgb:
        x = x.flip(-1)
    x = x.float() / 255.0
    b, h, w, _ = x.shape
    _, (nh, nw), (pad_x, pad_y) = letterbox_geometry(h, w, size)
    if (nh, nw) != (h, w):
        x = _resize_nhwc(x, (nh, nw))
    if (nh, nw) != (size, size):
        canvas = torch.full((b, size, size, 3), pad_value / 255.0, dtype=torch.float32,
                            device=x.device)
        canvas[:, pad_y:pad_y + nh, pad_x:pad_x + nw] = x
        x = canvas
    return x


# ---------------------------------------------------------------------------
# The host dataset


def load_image(path: str) -> np.ndarray:
    """Read an image file to RGB uint8 HWC."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def letterbox_cv2(image: np.ndarray, size: int, pad_value: int = 114
                  ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """``letterbox`` on the host with cv2's ``INTER_LINEAR`` resize, the
    reference dataset's own (cv2 interpolates uint8 in fixed point, so its
    pixels can differ from ``letterbox``'s by one grey level). Returns
    (padded_image, scale, (pad_x, pad_y))."""
    import cv2

    h, w = image.shape[:2]
    scale, (nh, nw), (pad_x, pad_y) = letterbox_geometry(h, w, size)
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = np.full((size, size, image.shape[2]), pad_value, image.dtype)
    out[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    return out, scale, (pad_x, pad_y)


class BaseVisionDataset:
    """Multi-task dataset over a JSON annotation file (counterpart of
    ``hvs_tpu/data/dataset.py::BaseVisionDataset``, numpy and cv2, copied).

    Annotation format (standardized; ``annotation_file`` is a JSON file or
    its parsed content):
        {"images": [{"id", "file_name", "width", "height"}],
         "annotations": [{"image_id", "bbox": [x, y, w, h] (pixels),
                          "category_id"}]}

    ``__getitem__`` returns a numpy dict:
        images   [S, S, 3] float32 in [0, 1], ImageNet-normalized optionally
        boxes    [max_boxes, 4] normalized cxcywh
        labels   [max_boxes] int32
        box_mask [max_boxes] float32
    """

    def __init__(
        self,
        root: str,
        annotation_file: Union[str, Dict[str, Any]],
        image_size: int = 416,
        max_boxes: int = 64,
        task: str = "detection",
        transform: Optional[Callable] = None,
        class_names: Sequence[str] = COCO_CLASSES,
        normalize: bool = True,
        max_samples: Optional[int] = None,
        skip_empty: bool = False,
        cache_images: bool = False,
        as_uint8: bool = False,
    ):
        if task not in ("detection", "classification", "segmentation", "multi_task"):
            raise ValueError(f"unknown task {task!r}")
        self.root = root
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.task = task
        self.transform = transform
        self.class_names = list(class_names)
        self.normalize = normalize
        # uint8 output: a quarter of the bytes to the device, normalized
        # there (``training.trainer.prepare_images``).
        self.as_uint8 = as_uint8
        # Decoded-image RAM cache: after the first epoch no JPEG is decoded.
        self.cache_images = cache_images
        self._image_cache: Dict[int, np.ndarray] = {}

        if isinstance(annotation_file, dict):
            data = annotation_file
        else:
            with open(annotation_file) as f:
                data = json.load(f)
        self.images: List[Dict[str, Any]] = list(data.get("images", []))
        anns: Dict[Any, List[Dict[str, Any]]] = {}
        for a in data.get("annotations", []):
            anns.setdefault(a["image_id"], []).append(a)
        self.annotations = anns
        if skip_empty:
            self.images = [im for im in self.images if anns.get(im["id"])]
        if max_samples:
            self.images = self.images[:max_samples]

    def __len__(self) -> int:
        return len(self.images)

    # ------------------------------------------------------------------
    def _resolve_path(self, file_name: str) -> str:
        if os.path.isabs(file_name):
            return file_name
        return os.path.join(self.root, file_name)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.images[idx]
        if self.cache_images and idx in self._image_cache:
            image = self._image_cache[idx]
        else:
            image = load_image(self._resolve_path(info["file_name"]))
            if self.cache_images:
                self._image_cache[idx] = image
        anns = self.annotations.get(info["id"], [])

        boxes = np.zeros((len(anns), 4), np.float32)  # pixel xywh
        labels = np.zeros((len(anns),), np.int32)
        for i, a in enumerate(anns):
            boxes[i] = a["bbox"]
            labels[i] = a["category_id"]

        if self.transform is not None:
            image, boxes, labels = self.transform(image, boxes, labels)

        h, w = image.shape[:2]
        padded, scale, (px, py) = letterbox_cv2(image, self.image_size)

        # Pixel xywh -> normalized cxcywh in the letterboxed frame.
        out_boxes = np.zeros((self.max_boxes, 4), np.float32)
        out_labels = np.zeros((self.max_boxes,), np.int32)
        mask = np.zeros((self.max_boxes,), np.float32)
        n = min(len(boxes), self.max_boxes)
        if n:
            b = boxes[:n].astype(np.float32)
            cx = (b[:, 0] + b[:, 2] / 2) * scale + px
            cy = (b[:, 1] + b[:, 3] / 2) * scale + py
            bw = b[:, 2] * scale
            bh = b[:, 3] * scale
            out_boxes[:n, 0] = cx / self.image_size
            out_boxes[:n, 1] = cy / self.image_size
            out_boxes[:n, 2] = bw / self.image_size
            out_boxes[:n, 3] = bh / self.image_size
            out_labels[:n] = labels[:n]
            valid = (out_boxes[:n, 2] > 1e-4) & (out_boxes[:n, 3] > 1e-4)
            mask[:n] = valid.astype(np.float32)

        if self.as_uint8:
            img = padded  # normalized on the device (trainer.prepare_images)
        else:
            img = padded.astype(np.float32) / 255.0
            if self.normalize:
                img = (img - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
                    IMAGENET_STD, np.float32)

        sample = {
            "images": img,
            "boxes": out_boxes,
            "labels": out_labels,
            "box_mask": mask,
            "image_id": np.asarray(info["id"], np.int64),
        }
        if self.task in ("classification", "multi_task"):
            sample["class_labels"] = (
                out_labels[0] if mask[0] > 0 else np.asarray(0, np.int32)
            )
        return sample

    # ------------------------------------------------------------------
    def class_distribution(self) -> Dict[int, int]:
        """Boxes per category id over the whole annotation file."""
        dist: Dict[int, int] = {}
        for anns in self.annotations.values():
            for a in anns:
                dist[a["category_id"]] = dist.get(a["category_id"], 0) + 1
        return dist

    def visualize_sample(self, idx: int, path: str) -> Optional[str]:
        """Draw a sample's boxes and names on its image and write it to
        ``path``; None when cv2 is missing."""
        try:
            import cv2
        except Exception:
            return None
        info = self.images[idx]
        image = load_image(self._resolve_path(info["file_name"]))
        img = cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
        for a in self.annotations.get(info["id"], []):
            x, y, w, h = [int(v) for v in a["bbox"]]
            cv2.rectangle(img, (x, y), (x + w, y + h), (0, 255, 0), 2)
            name = (
                self.class_names[a["category_id"]]
                if a["category_id"] < len(self.class_names)
                else str(a["category_id"])
            )
            cv2.putText(img, name, (x, max(y - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, (0, 255, 0), 1)
        cv2.imwrite(path, img)
        return path
