"""Typed config system (counterpart of ``hvs_tpu/config``)."""

from .base import (
    BaseConfig,
    DeviceType,
    Precision,
    create_default_configs,
    from_dict,
    load_config,
    merge_configs,
)
from .inference import (
    APIConfig,
    GRPCConfig,
    InferenceConfig,
    PerformanceConfig,
    PostprocessingConfig,
    PreprocessingConfig,
    VisualizationConfig,
)
from .model import (
    BackboneConfig,
    DetectionHeadConfig,
    FusionConfig,
    MHCConfig,
    ModelConfig,
    QuantizationConfig,
    RAGConfig,
    ViTConfig,
)
from .training import (
    AugmentationConfig,
    DatasetConfig,
    DistributedConfig,
    LossConfig,
    OptimizerConfig,
    SchedulerConfig,
    TrainingConfig,
)

__all__ = [
    "BaseConfig", "Precision", "DeviceType", "from_dict",
    "merge_configs", "load_config", "create_default_configs",
    "MHCConfig", "BackboneConfig", "ViTConfig", "FusionConfig",
    "DetectionHeadConfig", "RAGConfig", "QuantizationConfig", "ModelConfig",
    "PreprocessingConfig", "PostprocessingConfig", "VisualizationConfig",
    "APIConfig", "GRPCConfig", "PerformanceConfig", "InferenceConfig",
    "DatasetConfig", "AugmentationConfig", "OptimizerConfig", "SchedulerConfig",
    "LossConfig", "DistributedConfig", "TrainingConfig",
]
