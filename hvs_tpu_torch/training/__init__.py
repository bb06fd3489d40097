"""Training: losses, the manifold-aware optimizer, schedules, stability
monitoring, the trainer, the captured steps of its on-device loop and the
multi-task step and evaluation (counterpart of ``hvs_tpu/training``)."""

from .chunk import TrainChunk, ValChunk
from .losses import (LossWeights, bce_with_smoothing, build_targets, focal_bce,
                     iter_h_res_leaves, manifold_regularization_loss, mhc_yolo_loss,
                     multi_task_loss)
from .multitask import MultiTaskChunk, MultiTaskEval
from .optimizer import (ManifoldAwareOptimizer, doubly_stochastic_projection, is_mhc_path,
                        partition_label)
from .schedule import (ManifoldAwareScheduler, PlateauSchedulerWithReset,
                       cosine_annealing_with_warmup)
from .stability import (StabilityMonitor, StabilityThresholds, TrainingStabilityMetrics,
                        make_eig_telemetry)
from .trainer import (ManifoldConstrainedTrainer, TrainerConfig, TrainState, eval_step,
                      global_norm, prepare_images, step_on_device, train_step)

__all__ = [
    "LossWeights", "build_targets", "focal_bce", "bce_with_smoothing", "mhc_yolo_loss",
    "iter_h_res_leaves", "manifold_regularization_loss", "multi_task_loss",
    "MultiTaskChunk", "MultiTaskEval", "ManifoldAwareOptimizer",
    "doubly_stochastic_projection", "is_mhc_path", "partition_label", "cosine_annealing_with_warmup",
    "PlateauSchedulerWithReset", "ManifoldAwareScheduler", "StabilityThresholds",
    "StabilityMonitor", "TrainingStabilityMetrics", "make_eig_telemetry", "TrainerConfig",
    "TrainState", "global_norm", "prepare_images", "train_step", "step_on_device", "eval_step",
    "ManifoldConstrainedTrainer", "TrainChunk", "ValChunk",
]
