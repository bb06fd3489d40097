"""Detection visualization, performance overlays, and debug figures.

Counterpart of ``hvs_tpu/inference/visualizer.py``, host-only and copied
unchanged (cv2 and matplotlib imported where they draw): box/label drawing with an
HSV-derived class palette, FPS/latency overlay with a mini time-series strip,
feature-map and mHC-activation debug figures, and a windowed
:class:`PerformanceMonitor`.
"""

from __future__ import annotations

import colorsys
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import COCO_CLASSES


def class_palette(n: int = 80, scheme: str = "hsv") -> List[Tuple[int, int, int]]:
    """Distinct BGR colors per class (reference: visualizer.py:73-120)."""
    colors = []
    for i in range(n):
        if scheme == "hsv":
            r, g, b = colorsys.hsv_to_rgb((i * 0.61803398875) % 1.0, 0.8, 0.95)
        else:
            rng = np.random.default_rng(i)
            r, g, b = rng.uniform(0.2, 1.0, 3)
        colors.append((int(b * 255), int(g * 255), int(r * 255)))
    return colors


class DetectionVisualizer:
    """Draw detections on BGR frames (reference: DetectionVisualizer,
    src/inference/visualizer.py:73-366)."""

    def __init__(
        self,
        class_names: Sequence[str] = COCO_CLASSES,
        box_thickness: int = 2,
        font_scale: float = 0.5,
        show_scores: bool = True,
        palette: str = "hsv",
    ):
        self.class_names = list(class_names)
        self.box_thickness = box_thickness
        self.font_scale = font_scale
        self.show_scores = show_scores
        self.colors = class_palette(max(len(self.class_names), 1), palette)

    def draw_detections(
        self,
        frame: np.ndarray,
        boxes: np.ndarray,
        scores: np.ndarray,
        classes: np.ndarray,
        track_ids: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        import cv2

        img = frame.copy()
        for i in range(len(boxes)):
            x1, y1, x2, y2 = [int(v) for v in boxes[i]]
            cls = int(classes[i])
            color = self.colors[cls % len(self.colors)]
            cv2.rectangle(img, (x1, y1), (x2, y2), color, self.box_thickness)
            label = (
                self.class_names[cls] if 0 <= cls < len(self.class_names) else str(cls)
            )
            if self.show_scores:
                label = f"{label} {float(scores[i]):.2f}"
            if track_ids is not None and i < len(track_ids):
                label = f"#{int(track_ids[i])} {label}"
            (tw, th), _ = cv2.getTextSize(
                label, cv2.FONT_HERSHEY_SIMPLEX, self.font_scale, 1
            )
            cv2.rectangle(img, (x1, y1 - th - 6), (x1 + tw + 2, y1), color, -1)
            cv2.putText(
                img, label, (x1 + 1, y1 - 4), cv2.FONT_HERSHEY_SIMPLEX,
                self.font_scale, (0, 0, 0), 1, cv2.LINE_AA,
            )
        return img

    def draw_performance_overlay(
        self, frame: np.ndarray, fps: float, latency_ms: float,
        latency_history: Optional[Sequence[float]] = None,
    ) -> np.ndarray:
        """FPS/latency text + mini latency strip chart
        (reference: visualizer.py:368-468)."""
        import cv2

        img = frame.copy()
        cv2.putText(
            img, f"FPS {fps:.1f}  lat {latency_ms:.1f}ms", (8, 22),
            cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 0), 2, cv2.LINE_AA,
        )
        if latency_history:
            hist = np.asarray(list(latency_history)[-60:], np.float32)
            if len(hist) >= 2:
                strip_w, strip_h, x0, y0 = 120, 30, 8, 30
                norm = hist / max(hist.max(), 1e-3)
                pts = [
                    (x0 + int(i * strip_w / len(hist)), y0 + strip_h - int(v * strip_h))
                    for i, v in enumerate(norm)
                ]
                for a, b in zip(pts[:-1], pts[1:]):
                    cv2.line(img, a, b, (0, 255, 255), 1)
        return img


class PerformanceMonitor:
    """Windowed FPS/latency tracker with p95 summaries
    (reference: PerformanceMonitor, src/inference/visualizer.py:646-796)."""

    def __init__(self, window: int = 120):
        self.frame_times: deque = deque(maxlen=window)
        self.latencies: deque = deque(maxlen=window)
        self._last = None

    def tick(self, latency_ms: Optional[float] = None) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.frame_times.append(now - self._last)
        self._last = now
        if latency_ms is not None:
            self.latencies.append(latency_ms)

    @property
    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return 1.0 / (sum(self.frame_times) / len(self.frame_times))

    def summary(self) -> Dict[str, float]:
        lat = np.asarray(self.latencies) if self.latencies else np.zeros(1)
        return {
            "fps": self.fps,
            "latency_mean_ms": float(lat.mean()),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "frames_tracked": len(self.frame_times),
        }


class DebugVisualizer:
    """Feature-map / activation-histogram / attention debug figures
    (reference: DebugVisualizer, src/inference/visualizer.py:570-944)."""

    @staticmethod
    def feature_map_grid(feature_map: np.ndarray, max_channels: int = 16,
                         path: Optional[str] = None):
        """Tile the first channels of an [H, W, C] map into one image."""
        import cv2

        fm = np.asarray(feature_map, np.float32)
        if fm.ndim == 4:
            fm = fm[0]
        c = min(fm.shape[-1], max_channels)
        cols = int(np.ceil(np.sqrt(c)))
        rows = int(np.ceil(c / cols))
        h, w = fm.shape[:2]
        canvas = np.zeros((rows * h, cols * w), np.uint8)
        for i in range(c):
            ch = fm[..., i]
            rng_ = ch.max() - ch.min()
            norm = (ch - ch.min()) / (rng_ + 1e-9)
            r, col = divmod(i, cols)
            canvas[r * h : (r + 1) * h, col * w : (col + 1) * w] = (norm * 255).astype(
                np.uint8
            )
        if path:
            cv2.imwrite(path, canvas)
        return canvas

    @staticmethod
    def activation_histogram(activations: np.ndarray, path: str) -> Optional[str]:
        """mHC activation histogram (reference :798-944); matplotlib-gated."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        fig, ax = plt.subplots(figsize=(5, 3))
        ax.hist(np.asarray(activations, np.float32).ravel(), bins=80)
        ax.set_title("activation distribution")
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return path

    @staticmethod
    def attention_heatmap(attention: np.ndarray, frame: np.ndarray) -> np.ndarray:
        """Overlay an attention/objectness map on the frame."""
        import cv2

        att = np.asarray(attention, np.float32)
        att = (att - att.min()) / (att.max() - att.min() + 1e-9)
        att = cv2.resize(att, (frame.shape[1], frame.shape[0]))
        heat = cv2.applyColorMap((att * 255).astype(np.uint8), cv2.COLORMAP_JET)
        return cv2.addWeighted(frame, 0.6, heat, 0.4, 0)
