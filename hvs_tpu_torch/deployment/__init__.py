"""Deployment: REST and gRPC servers, export, the model repository, health
checks, cloud bundles for H100 hosts (counterpart of ``hvs_tpu/deployment``),
and the container and cluster files (``container/``, ``kubernetes/``) with
the container's health probe (``probe``).

Names are imported on first use, so ``import hvs_tpu_torch.deployment`` and
its framework-free modules (``service``, ``model_server``,
``health_check``, ``cloud_codegen``, ``probe``) work where aiohttp, grpc,
protobuf, pydantic, cv2, psutil and prometheus_client are not installed.
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
    "CloudDeployConfig": "cloud_codegen",
    "generate_cloud_bundle": "cloud_codegen:generate",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, _, attr = target.partition(":")
    return getattr(import_module(f".{module}", __name__), attr or name)
