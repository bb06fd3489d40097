"""The system under test, built from a configuration file: the port's
serving engine (``hvs_tpu_torch.inference.InferenceEngine``) with the
benchmark's weights. This is the one module of the harness that imports
the program."""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def model_config(cfg, device: str):
    """The port's ``ModelConfig`` for a configuration file."""
    from hvs_tpu_torch.config.model import ModelConfig

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
