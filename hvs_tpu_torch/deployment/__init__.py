"""Deployment: REST and gRPC servers, export, the model repository, health
checks (counterpart of ``hvs_tpu/deployment``, without the cloud bundle).

Names are imported on first use, so ``import hvs_tpu_torch.deployment`` and
its framework-free modules (``service``, ``model_server``,
``health_check``) work where aiohttp, grpc, protobuf, pydantic, cv2,
psutil and prometheus_client are not installed.
"""

from importlib import import_module

_EXPORTS = {
    "VisionAPIServer": "api_server",
    "run_server": "api_server",
    "DetectRequestModel": "api_server",
    "DetectionModel": "api_server",
    "DetectionResponseModel": "api_server",
    "RobotVisionService": "grpc_server",
    "RobotGRPCServer": "grpc_server",
    "RobotVisionClient": "grpc_server",
    "SERVICE_NAME": "grpc_server",
    "ModelExporter": "model_server",
    "ModelServerManager": "model_server",
    "RegistryGate": "model_server",
    "ServingModelConfig": "model_server",
    "HealthChecker": "health_check",
    "HealthStatus": "health_check",
    "CheckResult": "health_check",
    "ModelHealthChecker": "health_check",
    "SystemHealthChecker": "health_check",
    "APIChecker": "health_check",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(import_module(f".{module}", __name__), name)
