"""End-to-end pipeline: camera -> engine -> postprocess -> visualize -> robot.

Counterpart of ``hvs_tpu/inference/integration_demo.py``: the pipeline
composes the port's components (the engine on the card unless the configs
say ``device="cpu"``); a synthetic camera backend makes it runnable without
camera hardware.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from ..config.inference import InferenceConfig
from ..config.model import ModelConfig
from .engine import InferenceEngine
from .postprocessing import DetectionTracker
from .robot_interface import (
    CommandHandler,
    RobotCommunication,
    RobotConfig,
    commands_from_detections,
)
from .visualizer import DetectionVisualizer, PerformanceMonitor
from ..data.streaming import RoboticCameraStream, StreamConfig, StreamType


class CompleteInferencePipeline:
    """(reference: CompleteInferencePipeline, integration_demo.py:30-360)"""

    def __init__(
        self,
        model_config: Optional[ModelConfig] = None,
        inference_config: Optional[InferenceConfig] = None,
        robot_config: Optional[RobotConfig] = None,
        camera_source: Any = "synthetic",
        enable_robot: bool = False,
        enable_tracking: bool = True,
    ):
        self.engine = InferenceEngine(model_config, inference_config)
        self.visualizer = DetectionVisualizer(class_names=self.engine.class_names)
        self.perf = PerformanceMonitor()
        self.tracker = DetectionTracker() if enable_tracking else None

        stype = StreamType.SYNTHETIC if camera_source == "synthetic" else (
            StreamType.USB if isinstance(camera_source, int) else StreamType.FILE
        )
        self.camera = RoboticCameraStream(
            StreamConfig(source=camera_source, stream_type=stype, target_fps=30.0)
        )

        self.robot: Optional[RobotCommunication] = None
        self.command_handler: Optional[CommandHandler] = None
        if enable_robot:
            self.robot = RobotCommunication(robot_config or RobotConfig())
            if self.robot.start():
                self.command_handler = CommandHandler(self.robot)
            else:
                self.robot = None  # robot offline: perception-only mode

    # ------------------------------------------------------------------
    def process_frame(self, frame: np.ndarray) -> Dict[str, Any]:
        det = self.engine.infer(frame)
        self.perf.tick(det.latency_ms)
        result: Dict[str, Any] = {"detections": det}

        if self.tracker is not None:
            tracks = self.tracker.update(det.boxes, det.scores, det.classes)
            result["tracks"] = tracks

        if self.robot is not None:
            self.robot.safety.update_from_detections(det)
            for cmd in commands_from_detections(det):
                if cmd.action == "follow" and self.command_handler:
                    self.command_handler.execute(
                        "follow", bearing_rad=cmd.bearing_rad,
                        distance_m=cmd.distance_m,
                    )
                elif cmd.action == "avoid" and self.command_handler:
                    self.command_handler.execute("avoid", bearing_rad=cmd.bearing_rad)
            result["robot_commands"] = commands_from_detections(det)

        annotated = self.visualizer.draw_detections(
            frame, det.boxes, det.scores, det.classes
        )
        annotated = self.visualizer.draw_performance_overlay(
            annotated, self.perf.fps, det.latency_ms,
            [l for l in self.perf.latencies],
        )
        result["annotated"] = annotated
        return result

    # ------------------------------------------------------------------
    def run_realtime(
        self, max_frames: Optional[int] = None, display: bool = False
    ) -> Dict[str, Any]:
        """Realtime loop (reference: integration_demo.py:198-268)."""
        self.camera.start()
        frames = 0
        try:
            while max_frames is None or frames < max_frames:
                f = self.camera.read(timeout=2.0)
                if f is None:
                    break
                result = self.process_frame(f.image)
                frames += 1
                if display:
                    import cv2

                    cv2.imshow("hvs_tpu_torch", result["annotated"])
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        break
        finally:
            self.camera.stop()
        return {"frames": frames, **self.perf.summary()}

    def process_video(self, path: str, output_path: Optional[str] = None,
                      max_frames: Optional[int] = None) -> Dict[str, Any]:
        """Video-file processing (reference: integration_demo.py:270-342)."""
        import cv2

        cap = cv2.VideoCapture(path)
        writer = None
        frames = 0
        try:
            while cap.isOpened() and (max_frames is None or frames < max_frames):
                ok, frame = cap.read()
                if not ok:
                    break
                result = self.process_frame(frame)
                if output_path:
                    if writer is None:
                        h, w = result["annotated"].shape[:2]
                        writer = cv2.VideoWriter(
                            output_path, cv2.VideoWriter_fourcc(*"mp4v"),
                            cap.get(cv2.CAP_PROP_FPS) or 30, (w, h),
                        )
                    writer.write(result["annotated"])
                frames += 1
        finally:
            cap.release()
            if writer is not None:
                writer.release()
        return {"frames": frames, **self.perf.summary()}

    def shutdown(self) -> None:
        self.camera.stop()
        if self.robot is not None:
            self.robot.stop()
