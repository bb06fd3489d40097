"""Data: the letterbox and camera streaming (counterpart of the parts of
``hvs_tpu/data`` that serving needs; the COCO data module is not ported yet)."""

from .dataset import letterbox, letterbox_geometry, letterbox_raw_batch
from .streaming import Frame, MultiCameraManager, RoboticCameraStream, StreamConfig, StreamType

__all__ = [
    "letterbox", "letterbox_geometry", "letterbox_raw_batch", "Frame", "MultiCameraManager",
    "RoboticCameraStream", "StreamConfig", "StreamType",
]
