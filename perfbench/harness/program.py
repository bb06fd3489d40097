"""The system under test, built from a configuration file: the port's
serving engine (``hvs_tpu_torch.inference.InferenceEngine``) with the
benchmark's weights. This is the one module of the harness that imports
the program."""

from __future__ import annotations

import dataclasses
import typing
from typing import Dict, Sequence

import torch


def model_config(cfg, device: str):
    """The port's ``ModelConfig`` for a configuration file: from its
    ``model`` block where it has one (the dataclass's fields, nested as
    ``configs/model.yaml`` lays them out), else from the hybrid's flat
    keys."""
    from hvs_tpu_torch.config.model import ModelConfig

    if "model" in cfg:
        fields = _fields(ModelConfig, cfg["model"])
        # The run sets these: its device, and the precision from ``dtype``.
        for key in ("device", "precision"):
            if key in fields:
                raise ValueError(f"model block: {key!r} is set by the run, not by the block")
        return ModelConfig(device=device, precision=cfg["dtype"], **fields)
    return ModelConfig(
        device=device, precision=cfg["dtype"], feature_dim=cfg["feature_dim"],
        mhc={"sinkhorn_iterations": cfg["sinkhorn_iterations"]},
        backbone={"base_channels": cfg["base_channels"],
                  "stage_blocks": tuple(cfg["stage_blocks"]),
                  "stage_channels": tuple(cfg["stage_channels"])},
        vit={"enabled": cfg["use_vit"], "dim": cfg["vit_dim"], "depth": cfg["vit_depth"],
             "num_heads": cfg["vit_heads"]},
        fusion={"fpn_channels": cfg["fpn_channels"],
                "out_channels": tuple(cfg["fusion_out_channels"])},
        detection={"num_classes": cfg["num_classes"], "num_anchors": cfg["num_anchors"],
                   "head_channels": cfg["head_channels"]})


def _fields(cls, block, where: str = ""):
    """``block``'s keys as fields of the dataclass ``cls``: an object as the
    field's own dataclass, a list as a tuple where the field is one. A key
    that names no field raises ``ValueError`` with its dotted path (the
    port's ``from_dict`` would drop it without a word)."""
    if not isinstance(block, dict):
        raise ValueError(f"model block: {where or 'model'!r} must be an object")
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    out = {}
    for key, value in block.items():
        path = f"{where}.{key}" if where else key
        if key not in names:
            raise ValueError(f"model block: {path!r} is not a field of the port's {cls.__name__}")
        hint = hints[key]
        if dataclasses.is_dataclass(hint):
            value = hint(**_fields(hint, value, path))
        elif isinstance(value, list) and _is_tuple(hint):
            value = tuple(value)
        out[key] = value
    return out


def _is_tuple(hint) -> bool:
    """A tuple annotation, or an optional one."""
    return tuple in (typing.get_origin(hint), *map(typing.get_origin, typing.get_args(hint)))


def inference_config(cfg, image_size: int, buckets: Sequence[int], device: str):
    """The port's ``InferenceConfig``: the configuration's thresholds, the
    cell's input size and batch buckets, every other field at its default."""
    from hvs_tpu_torch.config.inference import InferenceConfig

    return InferenceConfig(
        device=device,
        preprocessing={"image_size": image_size},
        postprocessing={k: cfg[k] for k in ("nms_method", "score_threshold", "iou_threshold",
                                            "max_detections", "pre_nms_top_k",
                                            "min_box_size", "max_aspect_ratio")},
        performance={"batch_buckets": tuple(buckets)})


def build_engine(cfg, weights: Dict[str, torch.Tensor], image_size: int,
                 buckets: Sequence[int], device: torch.device):
    """An engine serving ``weights`` (its ``variables``, by parameter name)."""
    from hvs_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(model_config(cfg, device.type),
                           inference_config(cfg, image_size, buckets, device.type),
                           variables=weights, device=device)


def engine_overloaded():
    """The exception ``submit`` raises when admission control refuses."""
    from hvs_tpu_torch.inference.engine import EngineOverloaded

    return EngineOverloaded
