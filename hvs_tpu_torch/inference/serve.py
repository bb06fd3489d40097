"""The serve entry point: normalized NHWC images in, fixed-K detections out.

Counterpart of the serve program that ``bench.py`` measures: the flagship
forward with the mHC constraints computed once at load, on-device decode,
class-aware fixed-shape NMS, and fixed-K boxes, scores and classes. The
bucketed engine with its letterbox is ``inference/engine.py``; the network
servers and the exported program are ``deployment/``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import Tree, load_flax_params
from ..device import DeviceLike, pin_matmul_precision, resolve_device
from ..models.constraints import compute_constraints, load_constraints, param_tree
from ..models.hybrid import detect


class Detector:
    """Serves a detection model on one device.

    Args:
        model: a ``HybridVisionSystem`` (usually ``ProductionHybridVision``).
        params: optional flax ``params`` tree (nested dicts of numpy arrays)
            loaded into the model; without it the model keeps its weights.
        device: where to serve; the CUDA card unless ``"cpu"`` is passed. The
            model is moved there.
    At load the mHC constraints are computed once (``model.sk_iters``
    Sinkhorn iterations) and installed on the model, and the process's matmul
    precision flags are pinned (``device.pin_matmul_precision``). Postprocessing uses the
    serve program's settings: score threshold 0.25, IoU 0.45, 512 candidates
    before NMS, 100 detections out.
    """

    score_threshold = 0.25
    iou_threshold = 0.45
    max_detections = 100

    def __init__(self, model: nn.Module, params: Optional[Tree] = None, *,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        pin_matmul_precision()  # process-wide: fp32 accumulation, as the reference
        self.model = model.to(self.device).eval()
        if params is not None:
            load_flax_params(self.model, params)
        self.constraints = compute_constraints(param_tree(self.model), model.sk_iters)
        load_constraints(self.model, self.constraints)

    @torch.inference_mode()
    def __call__(self, images) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``images`` [B, H, W, 3] normalized floats (tensor or numpy) ->
        (boxes [B, K, 4] normalized xyxy, scores [B, K], classes [B, K] int32);
        empty slots have score -1 and class -1."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        det, _ = detect(self.model, images.to(self.device), self.score_threshold,
                        self.iou_threshold, self.max_detections)
        return det.boxes, det.scores, det.classes
