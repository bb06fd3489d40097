"""COCO instances reader and the train/val loader factory.

Counterpart of ``hvs_tpu/data/coco.py`` (numpy and cv2, copied). The
instances JSON is parsed directly (no pycocotools): category ids remapped to
contiguous [0, C) in id order (COCO files count from 1), crowd annotations
and unknown categories dropped, an optional class filter, empty images
skipped. One difference: the reference writes the standardized view to a
file beside the annotation file, or to one fixed temporary name when that
directory is read-only, which two processes can overwrite; here the view is
handed to ``BaseVisionDataset`` in memory and nothing is written.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

from .dataset import BaseVisionDataset
from .loader import MHCDataLoader
from .transforms import MHCTransformComposer


class COCODataset(BaseVisionDataset):
    """COCO instances dataset: a ``BaseVisionDataset`` over the remapped
    annotations, with the file's category names as ``class_names``."""

    def __init__(
        self,
        root: str,
        annotation_file: str,
        image_dir: Optional[str] = None,
        image_size: int = 416,
        max_boxes: int = 64,
        transform=None,
        class_filter: Optional[Sequence[str]] = None,
        max_samples: Optional[int] = None,
        skip_empty: bool = True,
        normalize: bool = True,
        cache_images: bool = False,
        as_uint8: bool = False,
    ):
        with open(annotation_file) as f:
            coco = json.load(f)

        categories = sorted(coco.get("categories", []), key=lambda c: c["id"])
        self.cat_id_to_contiguous = {c["id"]: i for i, c in enumerate(categories)}
        class_names = [c["name"] for c in categories]

        keep_contiguous = None
        if class_filter:
            keep_contiguous = {
                i for i, name in enumerate(class_names) if name in set(class_filter)
            }

        images = coco.get("images", [])
        annotations = []
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            cid = self.cat_id_to_contiguous.get(a["category_id"])
            if cid is None:
                continue
            if keep_contiguous is not None and cid not in keep_contiguous:
                continue
            annotations.append(
                {
                    "image_id": a["image_id"],
                    "bbox": a["bbox"],
                    "category_id": cid,
                    "segmentation": a.get("segmentation"),
                }
            )

        super().__init__(
            root=image_dir or root,
            annotation_file={"images": images, "annotations": annotations},
            image_size=image_size,
            max_boxes=max_boxes,
            transform=transform,
            class_names=class_names,
            max_samples=max_samples,
            skip_empty=skip_empty,
            normalize=normalize,
            cache_images=cache_images,
            as_uint8=as_uint8,
        )


class COCODataModule:
    """Train/val datasets and loaders of ``root/<split>`` and
    ``root/annotations/instances_<split>.json``: the train set augmented by
    ``MHCTransformComposer.train_default`` and shuffled, the val set
    neither; both uint8 by default (normalized on the device)."""

    def __init__(
        self,
        root: str,
        image_size: int = 416,
        batch_size: int = 8,
        max_boxes: int = 64,
        num_workers: int = 2,
        train_split: str = "train2017",
        val_split: str = "val2017",
        max_samples: Optional[int] = None,
        augmentation_config=None,
        cache_images: bool = False,
        as_uint8: bool = True,
    ):
        self.root = root
        self.image_size = image_size
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.num_workers = num_workers
        self.train_split = train_split
        self.val_split = val_split
        self.max_samples = max_samples
        self.augmentation_config = augmentation_config
        self.cache_images = cache_images
        self.as_uint8 = as_uint8
        self.train_dataset: Optional[COCODataset] = None
        self.val_dataset: Optional[COCODataset] = None

    def _ann(self, split: str) -> str:
        return os.path.join(self.root, "annotations", f"instances_{split}.json")

    def setup(self) -> None:
        train_tf = MHCTransformComposer.train_default(
            self.image_size, self.augmentation_config
        )
        self.train_dataset = COCODataset(
            root=os.path.join(self.root, self.train_split),
            annotation_file=self._ann(self.train_split),
            image_size=self.image_size,
            max_boxes=self.max_boxes,
            transform=train_tf,
            max_samples=self.max_samples,
            cache_images=self.cache_images,
            as_uint8=self.as_uint8,
        )
        self.val_dataset = COCODataset(
            root=os.path.join(self.root, self.val_split),
            annotation_file=self._ann(self.val_split),
            image_size=self.image_size,
            max_boxes=self.max_boxes,
            transform=None,
            max_samples=self.max_samples,
            cache_images=self.cache_images,
            as_uint8=self.as_uint8,
        )

    def train_dataloader(self) -> MHCDataLoader:
        assert self.train_dataset is not None, "call setup() first"
        return MHCDataLoader(
            self.train_dataset, batch_size=self.batch_size, shuffle=True,
            num_workers=self.num_workers, drop_last=True,
        )

    def val_dataloader(self) -> MHCDataLoader:
        assert self.val_dataset is not None, "call setup() first"
        return MHCDataLoader(
            self.val_dataset, batch_size=self.batch_size, shuffle=False,
            num_workers=self.num_workers, drop_last=True,
        )
