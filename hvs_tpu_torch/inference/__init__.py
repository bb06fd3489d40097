"""Inference pipeline of the port (counterpart of ``hvs_tpu/inference``):
``InferenceEngine`` (one CUDA graph per batch bucket, micro-batcher, hot
swap), the single-call ``Detector``, and the host-side pre/postprocessing,
visualization and robot interface."""

from .engine import AsyncInferenceEngine, Detections, EngineOverloaded, InferenceEngine
from .integration_demo import CompleteInferencePipeline
from .postprocessing import (
    AppearanceTracker,
    DetectionPostprocessor,
    DetectionTracker,
    NMSFilter,
    Track,
)
from .preprocessing import (
    CameraCalibration,
    CameraManager,
    ImagePreprocessor,
    PreprocessMode,
    PreprocessResult,
    VideoStreamer,
    decode_jpeg,
    jpeg_dimensions,
)
from .robot_interface import (
    CommandHandler,
    DetectionCommand,
    Protocol,
    RobotCommand,
    RobotCommunication,
    RobotConfig,
    SafetyMonitor,
    commands_from_detections,
    decode_message,
    encode_message,
)
from .serve import Detector
from .visualizer import DebugVisualizer, DetectionVisualizer, PerformanceMonitor, class_palette

__all__ = [
    "InferenceEngine", "AsyncInferenceEngine", "EngineOverloaded", "Detections", "Detector",
    "ImagePreprocessor", "PreprocessMode", "PreprocessResult", "VideoStreamer",
    "CameraManager", "CameraCalibration", "jpeg_dimensions", "decode_jpeg",
    "DetectionPostprocessor", "NMSFilter", "DetectionTracker", "AppearanceTracker", "Track",
    "DetectionVisualizer", "PerformanceMonitor", "DebugVisualizer", "class_palette",
    "Protocol", "RobotConfig", "DetectionCommand", "RobotCommand", "RobotCommunication",
    "SafetyMonitor", "CommandHandler", "commands_from_detections", "encode_message",
    "decode_message", "CompleteInferencePipeline",
]
