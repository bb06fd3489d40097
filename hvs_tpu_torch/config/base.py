"""Typed configuration: dataclasses with YAML/JSON round-trip and merge.

Counterpart of ``hvs_tpu/config/base.py`` (``Precision``, ``DeviceType``,
``BaseConfig``, ``from_dict``, ``merge_configs``, ``load_config``,
``create_default_configs``). Two differences: ``device="auto"`` resolves to
``cuda`` and raises without a card, as every entry point of the port does
(``device.resolve_device``), and ``dtype()`` returns a torch dtype. ``yaml``
is imported only where a YAML file is read or written.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch


class Precision(str, enum.Enum):
    FP32 = "fp32"
    BF16 = "bf16"
    FP16 = "fp16"
    INT8 = "int8"


class DeviceType(str, enum.Enum):
    AUTO = "auto"
    CUDA = "cuda"
    CPU = "cpu"


def _resolve_device(device: str) -> str:
    """``auto`` -> ``cuda``; a CUDA device raises when no card is present
    (pass ``device="cpu"`` to run on the CPU)."""
    from ..device import resolve_device

    return resolve_device(None if device == DeviceType.AUTO.value else device).type


@dataclass
class BaseConfig:
    """Root experiment config."""

    seed: int = 42
    device: str = "auto"
    precision: str = Precision.BF16.value
    batch_size: int = 8
    gradient_accumulation_steps: int = 1
    output_dir: str = "outputs"
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"

    def __post_init__(self):
        self.device = _resolve_device(self.device)
        self.validate()

    def validate(self) -> None:
        assert self.batch_size >= 1, "batch_size must be >= 1"
        assert self.gradient_accumulation_steps >= 1
        assert self.precision in {p.value for p in Precision}, self.precision

    def create_directories(self) -> None:
        for d in (self.output_dir, self.checkpoint_dir, self.log_dir):
            os.makedirs(d, exist_ok=True)

    # ---------------- serialization ----------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        data = self.to_dict()
        with open(path, "w") as f:
            if path.endswith(".json"):
                json.dump(data, f, indent=2, default=str)
            else:
                import yaml

                yaml.safe_dump(data, f, sort_keys=False)

    @classmethod
    def load(cls, path: str):
        return from_dict(cls, _read(path))

    def dtype(self) -> torch.dtype:
        return {
            "fp32": torch.float32,
            "bf16": torch.bfloat16,
            "fp16": torch.float16,
            "int8": torch.int8,
        }[self.precision]

    def display(self) -> str:
        lines = [f"{type(self).__name__}:"]
        for f_ in dataclasses.fields(self):
            lines.append(f"  {f_.name}: {getattr(self, f_.name)}")
        return "\n".join(lines)


def _read(path: str) -> Dict[str, Any]:
    with open(path) as f:
        if path.endswith(".json"):
            data = json.load(f)
        else:
            import yaml

            data = yaml.safe_load(f)
    return data or {}


def from_dict(cls, data: Dict[str, Any]):
    """Build a (possibly nested) dataclass from a plain dict, ignoring unknown
    keys."""
    if not dataclasses.is_dataclass(cls):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in (data or {}).items():
        if key not in fields:
            continue
        ftype = fields[key].type
        if isinstance(value, dict) and dataclasses.is_dataclass(_resolve(ftype)):
            kwargs[key] = from_dict(_resolve(ftype), value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def _resolve(tp):
    """Resolve string annotations to the class when possible."""
    if isinstance(tp, str):
        return None
    return tp


def merge_configs(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge, override wins."""
    out = dict(base)
    for key, value in (override or {}).items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = merge_configs(out[key], value)
        else:
            out[key] = value
    return out


def load_config(path: str, config_type: Optional[str] = None):
    """Load a base, model or inference config file, the type guessed from
    the file name when not given. (Training configs are not ported yet.)"""
    from .inference import InferenceConfig
    from .model import ModelConfig

    data = _read(path)
    if config_type is None:
        name = os.path.basename(path).lower()
        if "train" in name:
            config_type = "training"
        elif "infer" in name or "deploy" in name:
            config_type = "inference"
        elif "model" in name or "base" in name:
            config_type = "model"
        else:
            config_type = "base"
    if config_type == "training":
        raise NotImplementedError(
            "training configs are not ported yet (ROADMAP queue 1, item 4)")
    mapping = {"base": BaseConfig, "model": ModelConfig, "inference": InferenceConfig}
    return from_dict(mapping[config_type], data)


def create_default_configs(directory: str) -> None:
    """Write the default model and inference configs as YAML."""
    from .inference import InferenceConfig
    from .model import ModelConfig

    os.makedirs(directory, exist_ok=True)
    ModelConfig().save(os.path.join(directory, "model.yaml"))
    InferenceConfig().save(os.path.join(directory, "inference.yaml"))
