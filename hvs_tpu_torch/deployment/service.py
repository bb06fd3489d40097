"""The request-to-response core shared by the REST and gRPC servers.

Nothing here needs a web or RPC framework: the servers decode the image
bytes and call in with arrays, and get plain dicts back. It holds

  * :func:`detect_sync` — one image through the micro-batcher when it runs
    (admission control, cross-request batching), else ``engine.infer``;
  * :func:`response_dict` — the REST response, with exactly the keys and
    types of ``DetectionResponseModel.model_dump()``;
  * :class:`DetectionService` — the gRPC service's detect fields and its
    commands (``ping``, ``get_status``, ``switch_model``, ``update_config``,
    ``stop_stream``), with its counters;
  * :func:`source_hw` and :func:`in_source_pixels` — the repair of the
    reference's coordinate fault: a large JPEG is decoded reduced
    (``decode_jpeg``), and its boxes and image size are mapped back to the
    client's original pixels, axis by axis.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..inference.engine import Detections
from ..inference.preprocessing import jpeg_dimensions

REDUCED_DECODE_FACTORS = (1, 2, 4, 8)


def detect_sync(engine, image: np.ndarray) -> Detections:
    """One decoded image through the micro-batcher when it runs, else
    ``engine.infer``. The batcher may raise ``EngineOverloaded``."""
    if engine._batcher is not None:
        return engine.submit(image).result()
    return engine.infer(image)


def source_hw(blob: bytes, image: np.ndarray) -> Tuple[int, int]:
    """The (h, w) of the image the client sent: the JPEG header's size when
    ``image`` is a reduced decode of it (each side ceil(side / k) for one k
    in 1, 2, 4, 8; the header's sides in either order, as a decoder may
    apply an EXIF rotation), else the decoded size."""
    decoded = tuple(image.shape[:2])
    header = jpeg_dimensions(blob)
    if header is not None:
        for hw in (header, header[::-1]):
            if any(decoded == (-(-hw[0] // k), -(-hw[1] // k)) for k in REDUCED_DECODE_FACTORS):
                return (int(hw[0]), int(hw[1]))
    return (int(decoded[0]), int(decoded[1]))


def in_source_pixels(det: Detections, original_hw: Tuple[int, int]) -> Detections:
    """``det`` (boxes in the decoded image's pixels) with its boxes scaled
    per axis by original over decoded size and ``image_size`` the original."""
    h, w = det.image_size
    oh, ow = original_hw
    if (h, w) == (oh, ow):
        return det
    scale = np.array([ow / w, oh / h, ow / w, oh / h], np.float32)
    return dataclasses.replace(det, boxes=det.boxes * scale, image_size=(oh, ow))


def response_dict(det: Detections, request_id: str,
                  annotated: Optional[str] = None) -> Dict[str, Any]:
    """The REST detect response: ``detections`` (box, score, class_id,
    class_name), ``latency_ms``, ``image_size`` [h, w], ``request_id``,
    ``annotated_image_base64``."""
    return {
        "detections": [
            {"box": [float(v) for v in det.boxes[i]], "score": float(det.scores[i]),
             "class_id": int(det.classes[i]), "class_name": str(det.class_names[i])}
            for i in range(len(det))
        ],
        "latency_ms": float(det.latency_ms),
        "image_size": [int(v) for v in det.image_size],
        "request_id": str(request_id),
        "annotated_image_base64": annotated,
    }


def detect_fields(det: Detections, request_id: str, score_threshold: float,
                  latency_ms: float) -> Dict[str, Any]:
    """The fields of a gRPC ``DetectResponse``: the detections at or above
    ``score_threshold`` (x1, y1, x2, y2, score, class_id, class_name),
    ``request_id``, ``latency_ms``, ``image_height``, ``image_width``."""
    return {
        "detections": [
            {"x1": float(det.boxes[i][0]), "y1": float(det.boxes[i][1]),
             "x2": float(det.boxes[i][2]), "y2": float(det.boxes[i][3]),
             "score": float(det.scores[i]), "class_id": int(det.classes[i]),
             "class_name": str(det.class_names[i])}
            for i in range(len(det)) if det.scores[i] >= score_threshold
        ],
        "request_id": request_id,
        "latency_ms": float(latency_ms),
        "image_height": int(det.image_size[0]),
        "image_width": int(det.image_size[1]),
    }


class DetectionService:
    """The gRPC service's state and logic over one ``InferenceEngine``:
    requests served, errors, open streams, and the commands."""

    def __init__(self, engine):
        self.engine = engine
        self.requests_served = 0
        self.errors = 0
        self.streams_active = 0
        self.stop_streams = threading.Event()
        self.started_at = time.time()

    def detect(self, image: Optional[np.ndarray], original_hw: Optional[Tuple[int, int]],
               request_id: str = "", score_threshold: float = 0.0,
               t0: Optional[float] = None) -> Dict[str, Any]:
        """One decoded image (None: the bytes did not decode) -> the
        ``DetectResponse`` fields, or ``{"request_id", "error"}``. ``t0``
        (``time.perf_counter``) is when the request arrived, before decode."""
        t0 = time.perf_counter() if t0 is None else t0
        if image is None:
            self.errors += 1
            return {"request_id": request_id, "error": "cannot decode image"}
        det = self.engine.infer(image)
        if original_hw is not None:
            det = in_source_pixels(det, original_hw)
        self.requests_served += 1
        return detect_fields(det, request_id, score_threshold or 0.0,
                             (time.perf_counter() - t0) * 1e3)

    def command(self, command: str, params: Dict[str, str]) -> Dict[str, Any]:
        """A ``CommandRequest`` -> the ``CommandResponse`` fields (success,
        message, data)."""
        if command == "ping":
            return {"success": True, "message": "pong"}
        if command == "get_status":
            stats = self.engine.get_performance_stats()
            return {
                "success": True,
                "message": "ok",
                "data": {
                    "requests_served": str(self.requests_served),
                    "errors": str(self.errors),
                    "streams_active": str(self.streams_active),
                    "uptime_s": f"{time.time() - self.started_at:.1f}",
                    **{k: f"{v:.4g}" for k, v in stats.items()},
                },
            }
        if command == "switch_model":
            path = params.get("checkpoint_path", "")
            try:
                self.engine.reload(self.engine.load_checkpoint(path))
                return {"success": True, "message": f"loaded {path}"}
            except Exception as e:
                return {"success": False, "message": str(e)}
        if command == "update_config":
            updated = []
            pp = self.engine.config.postprocessing
            for key in ("score_threshold", "iou_threshold"):
                if key in params:
                    setattr(pp, key, float(params[key]))
                    updated.append(key)
            # The thresholds are baked into the captured graphs: drop them
            # under the engine's lock; the next call recaptures.
            self.engine.rebuild_serve_fns()
            return {"success": True, "message": f"updated {updated}"}
        if command == "stop_stream":
            self.stop_streams.set()
            return {"success": True, "message": "streams stopping"}
        return {"success": False, "message": f"unknown command: {command}"}


def batch_responses(engine, images: Sequence[np.ndarray],
                    original_hws: Sequence[Tuple[int, int]]) -> List[Dict[str, Any]]:
    """``engine.infer_batch`` of decoded images -> one REST response each
    (request ids "0", "1", ...), in the original pixels."""
    results = engine.infer_batch(list(images))
    return [response_dict(in_source_pixels(r, hw), str(i))
            for i, (r, hw) in enumerate(zip(results, original_hws))]
