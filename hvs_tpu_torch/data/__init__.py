"""Data: the letterbox, camera streaming, and the dataset held in device
memory with sampling and augmentation on the device (counterpart of the
parts of ``hvs_tpu/data`` that serving and ``train_chunked`` need; the COCO
data module is not ported yet)."""

from .dataset import letterbox, letterbox_geometry, letterbox_raw_batch
from .device_pipeline import (AugmentConfig, AugmentDraws, DenseData, DeviceData, apply_augment,
                              dense_batch, draw_augment, eval_batch, load_coco_arrays,
                              put_dense_data, put_device_data, warp_images)
from .streaming import Frame, MultiCameraManager, RoboticCameraStream, StreamConfig, StreamType

__all__ = [
    "letterbox", "letterbox_geometry", "letterbox_raw_batch", "Frame", "MultiCameraManager",
    "RoboticCameraStream", "StreamConfig", "StreamType", "AugmentConfig", "AugmentDraws",
    "DeviceData", "DenseData", "apply_augment", "dense_batch", "draw_augment", "eval_batch",
    "load_coco_arrays", "put_dense_data", "put_device_data", "warp_images",
]
