"""Data: the shapes benchmark generator, the COCO reader and host loaders with
their transforms, the letterbox, camera streaming, and the dataset held in
device memory with sampling and augmentation on the device (counterpart of
``hvs_tpu/data``).
Importing it needs no cv2: only the functions that decode, draw or resize
import it."""

from .coco import COCODataModule, COCODataset
from .dataset import (BaseVisionDataset, letterbox, letterbox_cv2, letterbox_geometry,
                      letterbox_raw_batch, load_image)
from .device_pipeline import (AugmentConfig, AugmentDraws, DenseData, DeviceData, apply_augment,
                              dense_batch, draw_augment, eval_batch, load_coco_arrays,
                              put_dense_data, put_device_data, warp_images)
from .loader import MHCDataLoader, ShardedDataLoader, StreamingDataLoader, default_collate
from .shapes import SHAPE80_CLASSES, SHAPE_CLASSES, class_names_for
from .shapes import generate_dataset as generate_shapes_dataset
from .shapes import generate_image as generate_shapes_image
from .streaming import Frame, MultiCameraManager, RoboticCameraStream, StreamConfig, StreamType
from .transforms import (AdaptiveAugmentation, BatchAugmentDraws, MHCTransformComposer,
                         apply_batch_augment, batch_augment_device, color_jitter,
                         draw_batch_augment, hflip, mixup, mosaic, random_erasing,
                         random_resized_crop, rotate_small)

__all__ = [
    "letterbox", "letterbox_geometry", "letterbox_raw_batch", "letterbox_cv2", "load_image",
    "BaseVisionDataset", "COCODataset", "COCODataModule",
    "SHAPE_CLASSES", "SHAPE80_CLASSES", "class_names_for", "generate_shapes_dataset",
    "generate_shapes_image",
    "MHCTransformComposer", "AdaptiveAugmentation", "BatchAugmentDraws", "batch_augment_device",
    "draw_batch_augment", "apply_batch_augment", "mosaic", "mixup", "hflip", "color_jitter",
    "random_resized_crop", "rotate_small", "random_erasing",
    "MHCDataLoader", "ShardedDataLoader", "StreamingDataLoader", "default_collate",
    "Frame", "MultiCameraManager", "RoboticCameraStream", "StreamConfig", "StreamType",
    "AugmentConfig", "AugmentDraws", "DeviceData", "DenseData", "apply_augment", "dense_batch",
    "draw_augment", "eval_batch", "load_coco_arrays", "put_dense_data", "put_device_data",
    "warp_images",
]
