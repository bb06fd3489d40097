"""Image preprocessing, video streaming, and camera management.

Counterpart of ``hvs_tpu/inference/preprocessing.py``:

  * :class:`ImagePreprocessor` — letterbox + normalize with FAST/ACCURATE
    modes; normalization runs on the card inside the engine's serve graphs,
    and the ACCURATE letterbox is the port's torch letterbox (on the CPU
    here, numpy in and out). A shape-keyed cache keeps letterbox geometry.
  * :class:`VideoStreamer` — per-camera capture threads with bounded
    oldest-drop buffers and frame stats (reference :357-587), built on
    :class:`hvs_tpu_torch.data.streaming.RoboticCameraStream`.
  * :class:`CameraManager` — camera discovery, chessboard calibration via
    cv2.calibrateCamera, undistortion, synchronized multi-camera reads
    (reference :589-866).
"""

from __future__ import annotations

import enum
import glob
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import IMAGENET_MEAN, IMAGENET_STD
from ..data.dataset import letterbox
from ..data.streaming import MultiCameraManager, RoboticCameraStream, StreamConfig, StreamType


class PreprocessMode(str, enum.Enum):
    FAST = "fast"  # nearest resize, skip color fidelity
    ACCURATE = "accurate"  # bilinear letterbox


def jpeg_dimensions(blob: bytes) -> Optional[Tuple[int, int]]:
    """(height, width) from a JPEG's SOF header without decoding the image.

    Walks the marker stream to the first start-of-frame segment (SOF0-SOF15,
    excluding DHT/JPG/DAC which share the 0xC0 nibble but carry no geometry).
    Costs a few microseconds vs milliseconds for a full decode; used to pick
    a DCT-domain reduced-decode factor before calling cv2. Returns None for
    anything that is not a parseable JPEG (caller falls back to full decode).
    """
    if len(blob) < 4 or blob[0] != 0xFF or blob[1] != 0xD8:
        return None
    i = 2
    n = len(blob)
    while i + 9 < n:
        if blob[i] != 0xFF:
            i += 1
            continue
        marker = blob[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:  # no-payload
            i += 2
            continue
        seg_len = (blob[i + 2] << 8) | blob[i + 3]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if seg_len >= 7:
                h = (blob[i + 5] << 8) | blob[i + 6]
                w = (blob[i + 7] << 8) | blob[i + 8]
                return (h, w)
            return None
        if marker == 0xDA:  # start of scan: SOF must precede it
            return None
        i += 2 + seg_len
    return None


def decode_jpeg(blob: bytes, target_size: Optional[int] = None) -> Optional[np.ndarray]:
    """Decode JPEG bytes to BGR uint8, using DCT-domain reduced decode when safe.

    When ``target_size`` is given and the frame's short side is at least
    2x/4x/8x the target (read from the SOF header, no decode), decodes with
    cv2.IMREAD_REDUCED_COLOR_{2,4,8}: libjpeg applies the scale during the
    IDCT, so the result is an exact area-downscale of the full decode — the
    letterbox was going to discard that resolution anyway. Guard is >= so the
    reduced frame never lands below the letterbox target (no upscaling ever).

    Non-JPEG bytes (PNG etc.) fall back to a plain cv2.imdecode. Returns
    None for undecodable input.
    """
    import cv2

    arr = np.frombuffer(blob, np.uint8)
    flag = cv2.IMREAD_COLOR
    if target_size is not None and target_size > 0:
        dims = jpeg_dimensions(blob)
        if dims is not None:
            short = min(dims)
            for k, f in (
                (8, cv2.IMREAD_REDUCED_COLOR_8),
                (4, cv2.IMREAD_REDUCED_COLOR_4),
                (2, cv2.IMREAD_REDUCED_COLOR_2),
            ):
                if short >= k * target_size:
                    flag = f
                    break
    return cv2.imdecode(arr, flag)


@dataclass
class PreprocessResult:
    image: np.ndarray  # [S, S, 3] uint8 letterboxed RGB
    scale: float
    pad: Tuple[int, int]
    original_hw: Tuple[int, int]


class ImagePreprocessor:
    """Host-side decode/letterbox; normalization stays on the card."""

    def __init__(
        self,
        image_size: int = 416,
        mode: PreprocessMode = PreprocessMode.ACCURATE,
        bgr_to_rgb: bool = True,
        pad_color: int = 114,
        cache_size: int = 8,
    ):
        self.image_size = image_size
        self.mode = PreprocessMode(mode)
        self.bgr_to_rgb = bgr_to_rgb
        self.pad_color = pad_color
        self._geom_cache: Dict[Tuple[int, int], Tuple[float, Tuple[int, int]]] = {}
        self._cache_size = cache_size

    def process(self, image: np.ndarray) -> PreprocessResult:
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        if self.bgr_to_rgb:
            image = image[..., ::-1]
        orig_hw = image.shape[:2]
        if self.mode == PreprocessMode.FAST:
            import cv2

            # direct resize (no aspect preservation) — fastest path
            resized = cv2.resize(
                image, (self.image_size, self.image_size),
                interpolation=cv2.INTER_NEAREST,
            )
            return PreprocessResult(
                np.ascontiguousarray(resized),
                self.image_size / max(orig_hw),
                (0, 0),
                orig_hw,
            )
        padded, scale, pad = letterbox(
            np.ascontiguousarray(image), self.image_size, self.pad_color
        )
        if len(self._geom_cache) < self._cache_size:
            self._geom_cache[orig_hw] = (scale, pad)
        return PreprocessResult(padded, scale, pad, orig_hw)

    def process_batch(self, images: Sequence[np.ndarray]) -> Tuple[np.ndarray, List[PreprocessResult]]:
        results = [self.process(im) for im in images]
        batch = np.stack([r.image for r in results])
        return batch, results

    @staticmethod
    def normalize_device(images_u8, dtype=None):
        """/255 + ImageNet normalization of a uint8 tensor, on its device."""
        import torch

        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images_u8.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images_u8.device)
        x = (images_u8.float() / 255.0 - mean) / std
        return x.to(dtype) if dtype is not None else x

    @staticmethod
    def attention_mask(batch: np.ndarray, pad_color: int = 114) -> np.ndarray:
        """Mask of non-padding pixels (reference: preprocessing.py:317-355)."""
        return (batch != pad_color).any(axis=-1).astype(np.float32)


class VideoStreamer:
    """Multi-source capture with per-camera threads
    (reference: VideoStreamer, src/inference/preprocessing.py:357-587)."""

    def __init__(self, sources: Sequence[Any], target_fps: float = 30.0,
                 buffer_size: int = 4):
        self.streams: Dict[str, RoboticCameraStream] = {}
        for i, src in enumerate(sources):
            stype = StreamType.USB
            if isinstance(src, str):
                if src.startswith("rtsp"):
                    stype = StreamType.RTSP
                elif src.startswith("http"):
                    stype = StreamType.HTTP
                elif src == "synthetic":
                    stype = StreamType.SYNTHETIC
                else:
                    stype = StreamType.FILE
            cfg = StreamConfig(
                source=src, stream_type=stype, target_fps=target_fps,
                buffer_size=buffer_size, name=f"camera{i}",
            )
            self.streams[cfg.name] = RoboticCameraStream(cfg)

    def start(self) -> "VideoStreamer":
        for s in self.streams.values():
            s.start()
        return self

    def stop(self) -> None:
        for s in self.streams.values():
            s.stop()

    def read(self, camera: Optional[str] = None, timeout: float = 1.0):
        if camera is None:
            camera = next(iter(self.streams))
        return self.streams[camera].read(timeout=timeout)

    def latest(self, camera: Optional[str] = None):
        if camera is None:
            camera = next(iter(self.streams))
        return self.streams[camera].latest()

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {name: s.stats() for name, s in self.streams.items()}


@dataclass
class CameraCalibration:
    camera_matrix: np.ndarray
    dist_coeffs: np.ndarray
    rms_error: float


class CameraManager:
    """Discovery, calibration, undistortion, synchronized reads
    (reference: CameraManager, src/inference/preprocessing.py:589-866)."""

    def __init__(self, max_cameras: int = 4):
        self.max_cameras = max_cameras
        self.calibrations: Dict[str, CameraCalibration] = {}
        self.manager: Optional[MultiCameraManager] = None

    @staticmethod
    def discover_cameras(max_index: int = 4) -> List[int]:
        """Probe USB camera indices (reference discovery loop)."""
        import cv2

        found = []
        for i in range(max_index):
            cap = cv2.VideoCapture(i)
            if cap.isOpened():
                ok, _ = cap.read()
                if ok:
                    found.append(i)
            cap.release()
        return found

    def open(self, configs: List[StreamConfig]) -> "CameraManager":
        self.manager = MultiCameraManager(configs).start_all()
        return self

    def close(self) -> None:
        if self.manager is not None:
            self.manager.stop_all()
            self.manager = None

    def read_synchronized(self, timeout: float = 1.0):
        assert self.manager is not None
        frames = self.manager.read_synchronized(timeout=timeout)
        if frames is None:
            return None
        out = {}
        for name, f in frames.items():
            img = f.image
            if name in self.calibrations:
                img = self.undistort(name, img)
            out[name] = img
        return out

    # ------------------------------------------------------------------
    def calibrate_from_images(
        self, name: str, images: Sequence[np.ndarray],
        board_size: Tuple[int, int] = (9, 6), square_mm: float = 25.0,
    ) -> Optional[CameraCalibration]:
        """Chessboard calibration (reference: preprocessing.py chessboard
        cv2.calibrateCamera path)."""
        import cv2

        objp = np.zeros((board_size[0] * board_size[1], 3), np.float32)
        objp[:, :2] = (
            np.mgrid[0 : board_size[0], 0 : board_size[1]].T.reshape(-1, 2) * square_mm
        )
        obj_points, img_points = [], []
        shape = None
        for img in images:
            gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img
            shape = gray.shape[::-1]
            ok, corners = cv2.findChessboardCorners(gray, board_size, None)
            if ok:
                obj_points.append(objp)
                img_points.append(corners)
        if len(obj_points) < 3 or shape is None:
            return None
        rms, mtx, dist, _, _ = cv2.calibrateCamera(
            obj_points, img_points, shape, None, None
        )
        calib = CameraCalibration(mtx, dist, float(rms))
        self.calibrations[name] = calib
        return calib

    def undistort(self, name: str, image: np.ndarray) -> np.ndarray:
        import cv2

        c = self.calibrations[name]
        return cv2.undistort(image, c.camera_matrix, c.dist_coeffs)
