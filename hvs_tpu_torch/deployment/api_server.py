"""REST API server on aiohttp with pydantic request/response models.

Counterpart of ``hvs_tpu/deployment/api_server.py``, with the same routes:

  * POST /detect            (multipart file | base64 JSON | URL)
  * POST /detect/batch      (synchronous, or a background job whose results
                             land in a JSON file)
  * GET  /batch_results/{job_id}
  * GET  /health
  * GET  /metrics           Prometheus exposition (engine stats as JSON
                             without prometheus_client)
  * GET  /models, POST /models/switch   hot model swap
  * GET  /stream/{camera_id}  MJPEG live-detection stream
  * GET  /ping, POST /invocations   /health and /detect under the names a
                             SageMaker endpoint calls (not in the reference)

Request counting and latency middleware, CORS headers, a 429 before the
body is read when the micro-batcher's queue is full, inference in a thread
pool, and a warm-up at start-up (every bucket's graph, plus the raw-frame
graphs of the configured camera shapes). The request-to-response logic is
``service.py``'s. One deliberate difference from the reference: boxes and
``image_size`` are in the client's original pixels even when a large JPEG
is decoded reduced, and ``/detect/batch`` decodes through the same
``decode_jpeg``.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from pydantic import BaseModel, Field

from .service import batch_responses, detect_sync, in_source_pixels, response_dict, source_hw


class DetectRequestModel(BaseModel):
    image_base64: Optional[str] = None
    image_url: Optional[str] = None
    score_threshold: Optional[float] = Field(None, ge=0.0, le=1.0)
    return_annotated: bool = False


class DetectionModel(BaseModel):
    box: List[float]
    score: float
    class_id: int
    class_name: str


class DetectionResponseModel(BaseModel):
    detections: List[DetectionModel]
    latency_ms: float
    image_size: List[int]
    request_id: str
    annotated_image_base64: Optional[str] = None


def _decode(data: bytes, target_size: int
            ) -> Tuple[Optional[np.ndarray], Optional[Tuple[int, int]]]:
    """Image bytes -> (BGR image, the client's (h, w)); (None, None) if they
    do not decode."""
    from ..inference.preprocessing import decode_jpeg

    image = decode_jpeg(data, target_size)
    if image is None:
        return None, None
    return image, source_hw(data, image)


class VisionAPIServer:
    def __init__(self, engine, config=None, enable_cors: bool = True,
                 results_dir: str = "batch_results"):
        from aiohttp import web

        self.engine = engine
        self.config = config
        self.results_dir = results_dir
        self.enable_cors = enable_cors
        self.executor = ThreadPoolExecutor(max_workers=2)
        self.started_at = time.time()
        self.request_count = 0
        self.error_count = 0
        self._background_jobs: Dict[str, str] = {}
        self._cameras: Dict[str, Any] = {}

        self._init_prometheus()

        @web.middleware
        async def tracking_middleware(request, handler):
            t0 = time.perf_counter()
            self.request_count += 1
            try:
                response = await handler(request)
                status = response.status
            except Exception:
                self.error_count += 1
                status = 500
                raise
            finally:
                if self.registry:
                    self.req_counter.labels(request.path, str(status)).inc()
                    self.latency_hist.labels(request.path).observe(time.perf_counter() - t0)
            if self.enable_cors:
                response.headers["Access-Control-Allow-Origin"] = "*"
            response.headers["X-Process-Time-Ms"] = f"{(time.perf_counter() - t0) * 1e3:.2f}"
            return response

        self.app = web.Application(middlewares=[tracking_middleware], client_max_size=32 * 2**20)
        self.app.router.add_post("/detect", self.handle_detect)
        self.app.router.add_post("/detect/batch", self.handle_detect_batch)
        self.app.router.add_get("/health", self.handle_health)
        # SageMaker's container contract: health at /ping, requests at /invocations.
        self.app.router.add_get("/ping", self.handle_health)
        self.app.router.add_post("/invocations", self.handle_detect)
        self.app.router.add_get("/metrics", self.handle_metrics)
        self.app.router.add_get("/models", self.handle_models)
        self.app.router.add_post("/models/switch", self.handle_model_switch)
        self.app.router.add_get("/stream/{camera_id}", self.handle_stream)
        self.app.router.add_get("/batch_results/{job_id}", self.handle_batch_result)
        self.app.on_startup.append(self._on_startup)

    def _init_prometheus(self):
        try:
            from prometheus_client import CollectorRegistry, Counter, Histogram

            self.registry = CollectorRegistry()
            self.req_counter = Counter(
                "hvs_requests_total", "Total API requests", ["endpoint", "status"],
                registry=self.registry,
            )
            self.latency_hist = Histogram(
                "hvs_request_latency_seconds", "Request latency", ["endpoint"],
                registry=self.registry,
            )
            self.det_counter = Counter(
                "hvs_detections_total", "Total detections returned", registry=self.registry,
            )
        except Exception:
            self.registry = None

    async def _on_startup(self, app):
        """Warm-up: every bucket's letterboxed graph, and the raw-frame graphs
        of the configured camera shapes."""
        loop = asyncio.get_event_loop()
        shapes = self.engine.config.performance.warmup_raw_shapes
        await loop.run_in_executor(self.executor, lambda: self.engine.warmup(src_shapes=shapes))

    async def _get_image(self, request):
        """(image, the client's (h, w)) from a multipart part, base64 JSON or
        a URL; (None, None) when the request carries none."""
        size = self.engine.image_size
        ctype = request.headers.get("Content-Type", "")
        if "multipart" in ctype:
            reader = await request.multipart()
            async for part in reader:
                if part.name in ("file", "image"):
                    return _decode(await part.read(), size)
            return None, None
        body = await request.json()
        req = DetectRequestModel(**body)
        if req.image_base64:
            return _decode(base64.b64decode(req.image_base64), size)
        if req.image_url:
            import aiohttp

            async with aiohttp.ClientSession() as session:
                async with session.get(req.image_url) as resp:
                    data = await resp.read()
            return _decode(data, size)
        return None, None

    def _response_for(self, det, request_id: str, annotated: Optional[str] = None
                      ) -> Dict[str, Any]:
        if self.registry:
            self.det_counter.inc(len(det))
        return DetectionResponseModel(**response_dict(det, request_id, annotated)).model_dump()

    # ---------------- endpoints ----------------
    async def handle_detect(self, request):
        from aiohttp import web

        from ..inference.engine import EngineOverloaded

        # 429 before the body is read or decoded: shedding must not cost a
        # decode on the host (the predicate submit() itself uses).
        if self.engine._batcher is not None and not self.engine.accepting():
            return web.json_response(
                {"error": "overloaded", "detail": "admission queue full"},
                status=429, headers={"Retry-After": "1"},
            )
        image, original_hw = await self._get_image(request)
        if image is None:
            return web.json_response({"error": "no image provided"}, status=400)
        loop = asyncio.get_event_loop()
        try:
            det = await loop.run_in_executor(self.executor, detect_sync, self.engine, image)
        except EngineOverloaded as e:
            return web.json_response(
                {"error": "overloaded", "detail": str(e)},
                status=429, headers={"Retry-After": "1"},
            )

        annotated_b64 = None
        if request.query.get("annotated") == "1":
            import cv2

            from ..inference.visualizer import DetectionVisualizer

            vis = DetectionVisualizer(class_names=self.engine.class_names)
            drawn = vis.draw_detections(image, det.boxes, det.scores, det.classes)
            ok, buf = cv2.imencode(".jpg", drawn)
            if ok:
                annotated_b64 = base64.b64encode(buf.tobytes()).decode()
        det = in_source_pixels(det, original_hw)
        return web.json_response(self._response_for(det, str(uuid.uuid4()), annotated_b64))

    async def handle_detect_batch(self, request):
        """A list response, or a background job (``"background": true``)."""
        from aiohttp import web

        body = await request.json()
        images_b64 = body.get("images_base64", [])
        if not images_b64:
            return web.json_response({"error": "images_base64 required"}, status=400)
        images, original_hws = [], []
        for b64 in images_b64:
            image, hw = _decode(base64.b64decode(b64), self.engine.image_size)
            if image is None:
                return web.json_response({"error": "undecodable image"}, status=400)
            images.append(image)
            original_hws.append(hw)

        loop = asyncio.get_event_loop()
        if body.get("background"):
            job_id = str(uuid.uuid4())
            os.makedirs(self.results_dir, exist_ok=True)
            path = os.path.join(self.results_dir, f"{job_id}.json")
            self._background_jobs[job_id] = path

            def run_job():
                results = self.engine.infer_batch(images)
                with open(path, "w") as f:
                    json.dump([in_source_pixels(r, hw).to_dict()
                               for r, hw in zip(results, original_hws)], f)

            loop.run_in_executor(self.executor, run_job)
            return web.json_response({"job_id": job_id, "status": "processing"})

        responses = await loop.run_in_executor(
            self.executor, batch_responses, self.engine, images, original_hws)
        if self.registry:
            self.det_counter.inc(sum(len(r["detections"]) for r in responses))
        return web.json_response(
            {"results": [DetectionResponseModel(**r).model_dump() for r in responses]})

    async def handle_batch_result(self, request):
        from aiohttp import web

        job_id = request.match_info["job_id"]
        path = self._background_jobs.get(job_id)
        if path is None:
            return web.json_response({"error": "unknown job"}, status=404)
        if not os.path.exists(path):
            return web.json_response({"job_id": job_id, "status": "processing"})
        with open(path) as f:
            return web.json_response({"job_id": job_id, "status": "done",
                                      "results": json.load(f)})

    async def handle_health(self, request):
        from aiohttp import web

        stats = self.engine.get_performance_stats()
        healthy = stats.get("error_rate", 0.0) < 0.5
        return web.json_response(
            {
                "status": "healthy" if healthy else "degraded",
                "uptime_s": time.time() - self.started_at,
                "requests": self.request_count,
                "errors": self.error_count,
                "model_loaded": self.engine.model is not None,
            },
            status=200 if healthy else 503,
        )

    async def handle_metrics(self, request):
        from aiohttp import web

        if self.registry is None:
            return web.json_response(self.engine.get_performance_stats())
        from prometheus_client import generate_latest

        return web.Response(body=generate_latest(self.registry), content_type="text/plain")

    async def handle_models(self, request):
        from aiohttp import web

        return web.json_response(
            {
                "current": {
                    "num_classes": len(self.engine.class_names),
                    "image_size": self.engine.image_size,
                    "stability": self.engine.get_stability_report(),
                },
            }
        )

    async def handle_model_switch(self, request):
        """Hot model swap from a checkpoint of the port's trainer (or
        ``ModelExporter.export_weights``)."""
        from aiohttp import web

        body = await request.json()
        path = body.get("checkpoint_path")
        if not path:
            return web.json_response({"error": "checkpoint_path required"}, status=400)
        loop = asyncio.get_event_loop()
        try:
            def swap():
                self.engine.reload(self.engine.load_checkpoint(path))

            await loop.run_in_executor(self.executor, swap)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"status": "switched", "checkpoint": path})

    async def handle_stream(self, request):
        """MJPEG live-detection stream (``?max_frames=N`` stops after N)."""
        from aiohttp import web

        from ..data.streaming import RoboticCameraStream, StreamConfig, StreamType

        camera_id = request.match_info["camera_id"]
        if camera_id not in self._cameras:
            source: Any = camera_id
            stype = StreamType.SYNTHETIC
            if camera_id.isdigit():
                source, stype = int(camera_id), StreamType.USB
            stream = RoboticCameraStream(
                StreamConfig(source=source, stream_type=stype, target_fps=15.0,
                             name=f"api_{camera_id}")
            ).start()
            self._cameras[camera_id] = stream
        stream = self._cameras[camera_id]

        response = web.StreamResponse(
            status=200,
            headers={"Content-Type": "multipart/x-mixed-replace; boundary=frame"},
        )
        await response.prepare(request)
        import cv2

        from ..inference.visualizer import DetectionVisualizer

        vis = DetectionVisualizer(class_names=self.engine.class_names)
        loop = asyncio.get_event_loop()
        max_frames = int(request.query.get("max_frames", 0)) or None
        sent = 0
        try:
            while max_frames is None or sent < max_frames:
                frame = stream.read(timeout=2.0)
                if frame is None:
                    break
                det = await loop.run_in_executor(self.executor, detect_sync, self.engine,
                                                 frame.image)
                drawn = vis.draw_detections(frame.image, det.boxes, det.scores, det.classes)
                ok, buf = cv2.imencode(".jpg", drawn)
                if not ok:
                    continue
                await response.write(
                    b"--frame\r\nContent-Type: image/jpeg\r\n\r\n" + buf.tobytes() + b"\r\n"
                )
                sent += 1
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        return response

    def shutdown(self) -> None:
        for stream in self._cameras.values():
            stream.stop()
        self._cameras.clear()
        self.executor.shutdown(wait=False)


def run_server(engine, host: str = "0.0.0.0", port: int = 8000, config=None) -> None:
    """Serve ``engine`` over REST until interrupted."""
    from aiohttp import web

    server = VisionAPIServer(engine, config=config)
    try:
        web.run_app(server.app, host=host, port=port)
    finally:
        server.shutdown()
