"""The multi-task model's train step and evaluation on the device.

Counterpart of the step and of ``evaluate`` in ``scripts/train_multitask.py``
(its ``batch_from``, ``loss_fn`` and ``evaluate``). The train step is
``TrainChunk``'s with another batch and loss: uniform random indices from
the trainer's generator, the gathered rows normalized (no augmentation),
``build_targets`` at strides 8/16/32, the forward with task "multi_task"
(dropout from the same generator), ``multi_task_loss`` plus the manifold
regulariser, the optimizer; one CUDA graph per chunk step, replayed K times
with one metrics pull per chunk. The evaluation is ``ValChunk``'s with the
script's metrics: one captured batch replayed over the split, its sums
pulled once.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Tuple

import numpy as np
import torch

from ..data.device_pipeline import DenseData, dense_batch
from .chunk import TrainChunk, ValChunk
from .losses import at_head_stride, multi_task_loss

if TYPE_CHECKING:
    from .trainer import ManifoldConstrainedTrainer, TrainerConfig

Tensor = torch.Tensor
EVAL_KEYS = ("detection_loss", "segmentation_loss", "depth_loss", "seg_pixel_acc",
             "depth_abs_rel")


class MultiTaskChunk(TrainChunk):
    """K multi-task train steps on batches of ``batch_size`` rows of
    ``data`` at its own size; captured, replayed and pulled as
    ``TrainChunk`` (the warm-up's effect on the train state undone)."""

    task = "multi_task"

    def __init__(self, trainer: "ManifoldConstrainedTrainer", data: DenseData, batch_size: int,
                 chunk_steps: int, pool=None):
        super().__init__(trainer, data, int(data.images.shape[1]), batch_size, chunk_steps,
                         pool=pool)

    def draw(self) -> Tensor:
        """``batch_size`` uniform row indices."""
        return torch.randint(0, self.data.images.shape[0], (self.batch_size,),
                             generator=self.trainer.generator, device=self.device)

    def batch_of(self, idx: Tensor) -> Dict[str, Tensor]:
        return dense_batch(self.data, idx)


@torch.no_grad()
def eval_values(model: torch.nn.Module, config: "TrainerConfig", batch: Dict[str, Tensor],
                seg_classes: int) -> Tensor:
    """One evaluation batch as the script's ``evaluate`` body computes it, in
    eval mode: the detection, segmentation and depth losses of
    ``multi_task_loss``, the pixel accuracy and the depth abs-rel at the
    heads' stride, then the intersection and the union of prediction and
    label for each of ``seg_classes`` classes (pixel counts). fp32 [5 + 2k]."""
    from .trainer import _targets

    model.eval()
    images = batch["images"]
    out = model(images, task="multi_task")
    _, metrics = multi_task_loss(out, {**batch, "targets": _targets(config, images, batch)},
                                 config.num_classes)
    logits = out["segmentation"].float()
    _, h, w, _ = logits.shape
    labels = at_head_stride(batch["seg_labels"], h, w)
    pred = logits.argmax(dim=-1)
    acc = (pred == labels).float().mean()
    dpred = out["depth"].float()[..., 0]
    dgt = at_head_stride(batch["depth"].float(), dpred.shape[1], dpred.shape[2])
    abs_rel = ((dpred - dgt).abs() / (dgt + 1e-3)).mean()
    classes = torch.arange(seg_classes, device=images.device)
    p, lab = pred[..., None] == classes, labels[..., None] == classes
    inter = (p & lab).sum(dim=(0, 1, 2)).float()
    union = (p | lab).sum(dim=(0, 1, 2)).float()
    losses = torch.stack([metrics["detection_loss"], metrics["segmentation_loss"],
                          metrics["depth_loss"], acc, abs_rel]).float()
    return torch.cat([losses, inter, union])


class MultiTaskEval(ValChunk):
    """The script's ``evaluate`` over the contiguous batches of ``data``
    (floor(N / batch_size) of them, at the images' size) with the model's
    own weights: ``run()`` returns ({``EVAL_KEYS``: mean over the batches,
    ``seg_miou``}, the IoU of each class). The pixel counts are summed in
    fp32, exact up to 2^24 pixels per class over the split."""

    def __init__(self, trainer: "ManifoldConstrainedTrainer", data: DenseData, batch_size: int,
                 pool=None):
        # The segmentation head's classes: the detector's and the background.
        self.seg_classes = trainer.config.num_classes + 1
        self.n_totals = len(EVAL_KEYS) + 2 * self.seg_classes
        super().__init__(trainer, data, batch_size, int(data.images.shape[1]),
                         int(data.images.shape[0]) // batch_size, pool=pool)

    def batch(self) -> None:
        t = self.trainer
        idx = self.start + torch.arange(self.batch_size, device=self.device)
        self.total.add_(eval_values(t.model, t.config, dense_batch(self.data, idx),
                                    self.seg_classes))
        self.start.add_(self.batch_size)

    def summarize(self, totals: np.ndarray) -> Tuple[Dict[str, float], np.ndarray]:
        k, n = self.seg_classes, len(EVAL_KEYS)
        means = {key: float(v) / self.n_batches for key, v in zip(EVAL_KEYS, totals[:n])}
        iou = totals[n:n + k] / np.maximum(totals[n + k:], 1.0)
        means["seg_miou"] = float(np.mean(iou))
        return means, iou
