"""Robot camera streaming: typed stream configs, per-camera threads, multi-cam sync.

Counterpart of ``hvs_tpu/data/streaming.py``, host-only and unchanged:

  * :class:`StreamType` / :class:`StreamConfig` — typed source descriptors
    (USB index, file path, RTSP/HTTP URL, synthetic test pattern).
  * :class:`RoboticCameraStream` — one capture thread per camera with bounded
    oldest-drop buffering, FPS throttling, auto-reconnect with backoff, and
    frame statistics.
  * :class:`MultiCameraManager` — N streams with synchronized reads (closest
    timestamps within a sync window).

The ``synthetic`` stream type is a hardware-free backend for tests; cv2 is
imported only when a real camera or file is opened.
"""

from __future__ import annotations

import enum
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class StreamType(str, enum.Enum):
    USB = "usb"
    FILE = "file"
    RTSP = "rtsp"
    HTTP = "http"
    SYNTHETIC = "synthetic"


@dataclass
class StreamConfig:
    source: Any = 0
    stream_type: StreamType = StreamType.USB
    width: int = 640
    height: int = 480
    target_fps: float = 30.0
    buffer_size: int = 4
    reconnect: bool = True
    reconnect_backoff_s: float = 1.0
    name: str = "camera0"


@dataclass
class Frame:
    image: np.ndarray
    timestamp: float
    index: int
    camera: str


class _SyntheticCapture:
    """Deterministic moving-gradient test pattern (no hardware)."""

    def __init__(self, config: StreamConfig):
        self.config = config
        self.i = 0
        self.opened = True

    def isOpened(self):
        return self.opened

    def read(self):
        h, w = self.config.height, self.config.width
        yy, xx = np.mgrid[0:h, 0:w]
        img = ((xx + yy + self.i * 7) % 256).astype(np.uint8)
        self.i += 1
        return True, np.stack([img, img[::-1], img[:, ::-1]], axis=-1)

    def release(self):
        self.opened = False


class RoboticCameraStream:
    """Single-camera capture thread (the reference's missing class)."""

    def __init__(self, config: StreamConfig):
        self.config = config
        self.buffer: "queue.Queue[Frame]" = queue.Queue(maxsize=config.buffer_size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.frames_captured = 0
        self.frames_dropped = 0
        self.reconnects = 0
        self.last_frame_time = 0.0

    # ------------------------------------------------------------------
    def _open(self):
        if self.config.stream_type == StreamType.SYNTHETIC:
            return _SyntheticCapture(self.config)
        import cv2

        cap = cv2.VideoCapture(self.config.source)
        if cap.isOpened() and self.config.stream_type == StreamType.USB:
            cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.config.width)
            cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self.config.height)
        return cap

    def start(self) -> "RoboticCameraStream":
        def loop():
            cap = self._open()
            min_interval = (
                1.0 / self.config.target_fps if self.config.target_fps > 0 else 0.0
            )
            last = 0.0
            while not self._stop.is_set():
                if not cap.isOpened():
                    if not self.config.reconnect:
                        return
                    time.sleep(self.config.reconnect_backoff_s)
                    cap = self._open()
                    self.reconnects += 1
                    continue
                ok, frame = cap.read()
                if not ok:
                    cap.release()
                    if not self.config.reconnect:
                        return
                    time.sleep(self.config.reconnect_backoff_s)
                    cap = self._open()
                    self.reconnects += 1
                    continue
                now = time.time()
                if now - last < min_interval:
                    continue
                last = now
                self.frames_captured += 1
                self.last_frame_time = now
                item = Frame(frame, now, self.frames_captured, self.config.name)
                if self.buffer.full():
                    try:
                        self.buffer.get_nowait()
                        self.frames_dropped += 1
                    except queue.Empty:
                        pass
                self.buffer.put(item)
            cap.release()

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def read(self, timeout: float = 1.0) -> Optional[Frame]:
        try:
            return self.buffer.get(timeout=timeout)
        except queue.Empty:
            return None

    def latest(self) -> Optional[Frame]:
        """Drain the buffer, return the newest frame."""
        frame = None
        while True:
            try:
                frame = self.buffer.get_nowait()
            except queue.Empty:
                return frame

    @property
    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stats(self) -> Dict[str, float]:
        return {
            "frames_captured": self.frames_captured,
            "frames_dropped": self.frames_dropped,
            "reconnects": self.reconnects,
            "buffer_fill": self.buffer.qsize(),
            "seconds_since_last_frame": (
                time.time() - self.last_frame_time if self.last_frame_time else -1.0
            ),
        }


class MultiCameraManager:
    """N synchronized camera streams (the reference's missing class)."""

    def __init__(self, configs: List[StreamConfig], sync_window_s: float = 0.05):
        names = [c.name for c in configs]
        assert len(set(names)) == len(names), "camera names must be unique"
        self.streams: Dict[str, RoboticCameraStream] = {
            c.name: RoboticCameraStream(c) for c in configs
        }
        self.sync_window_s = sync_window_s

    def start_all(self) -> "MultiCameraManager":
        for s in self.streams.values():
            s.start()
        return self

    def stop_all(self) -> None:
        for s in self.streams.values():
            s.stop()

    def read_synchronized(self, timeout: float = 1.0) -> Optional[Dict[str, Frame]]:
        """Newest frame from every camera; None unless all timestamps fall
        within the sync window."""
        frames: Dict[str, Frame] = {}
        deadline = time.time() + timeout
        for name, s in self.streams.items():
            remaining = max(deadline - time.time(), 0.01)
            f = s.read(timeout=remaining)
            if f is None:
                return None
            frames[name] = f
        times = [f.timestamp for f in frames.values()]
        if max(times) - min(times) > self.sync_window_s:
            return None  # out of sync — caller retries
        return frames

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {name: s.stats() for name, s in self.streams.items()}
