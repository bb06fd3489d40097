"""Training configuration: dataset, augmentation, optimizer, scheduler, loss
and distributed sub-configs, EMA and early stopping.

Counterpart of ``hvs_tpu/config/training.py`` with the same fields and
defaults. ``TrainingConfig.trainer_config`` builds the port's
``TrainerConfig``. ``device="auto"`` resolves to ``cuda`` and raises without
a card, as for every config of the port (``config/base.py``); the
``distributed`` block joins the processes and shapes the mesh
(``parallel.setup``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from .base import BaseConfig, from_dict


@dataclass
class DatasetConfig:
    """The COCO-format dataset and its host loader."""

    name: str = "coco"
    root: str = "data/coco"
    train_split: str = "train2017"
    val_split: str = "val2017"
    image_size: int = 416
    max_boxes: int = 64
    num_workers: int = 2
    max_samples: Optional[int] = None
    class_filter: Optional[Tuple[str, ...]] = None


@dataclass
class AugmentationConfig:
    """Host augmentation probabilities and strengths (``MHCTransformComposer``)."""

    horizontal_flip: float = 0.5
    color_jitter: float = 0.4
    random_crop: float = 0.3
    rotation_degrees: float = 5.0
    mosaic: float = 0.5
    mixup: float = 0.1
    random_erasing: float = 0.2
    adaptive_decay_epochs: int = 0  # >0 enables strength decay


@dataclass
class OptimizerConfig:
    """The manifold-aware AdamW and its clipping and projection."""

    name: str = "manifold_adamw"
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    mhc_lr_factor: float = 0.5
    clip_regular: float = 1.0
    clip_mhc: float = 0.5
    project_every: int = 100
    backbone_lr_factor: float = 0.1  # LR factor of the backbone group


@dataclass
class SchedulerConfig:
    """Cosine warm-up schedule and the optional LR controllers."""

    name: str = "cosine_warmup"
    warmup_steps: int = 1000
    total_steps: int = 100_000
    min_lr_ratio: float = 0.01
    plateau_patience: int = 5
    plateau_factor: float = 0.5
    plateau: bool = False          # reduce-on-plateau lr_scale controller
    manifold_aware: bool = False   # stability-driven lr_scale controller


@dataclass
class LossConfig:
    """Loss weights."""

    lambda_coord: float = 5.0
    lambda_obj: float = 1.0
    lambda_noobj: float = 0.5
    lambda_cls: float = 1.0
    label_smoothing: float = 0.05
    manifold_alpha: float = 0.01
    focal_gamma: float = 2.0


@dataclass
class DistributedConfig:
    """Multi-process data and tensor parallelism: ``enabled`` joins
    ``num_processes`` processes at ``coordinator_address`` as
    ``process_id`` (else torchrun's environment, if any, is read);
    ``data_parallel`` (-1: all processes) and ``model_parallel`` (the
    processes that split the rule-matched parameters) size the mesh
    (``parallel.setup`` reads it)."""

    enabled: bool = False
    data_parallel: int = -1  # -1 = all devices
    model_parallel: int = 1
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclass
class TrainingConfig(BaseConfig):
    """Root training config."""

    epochs: int = 100
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    ema_decay: float = 0.0  # 0 disables EMA
    early_stopping_patience: int = 10
    stability_check_every: int = 100
    checkpoint_every_epochs: int = 5
    checkpoint_every_steps: int = 0
    metrics_log: Optional[str] = None
    resume_from: Optional[str] = None
    wandb_project: Optional[str] = None

    def __post_init__(self):
        for name, cls in (
            ("dataset", DatasetConfig),
            ("augmentation", AugmentationConfig),
            ("optimizer", OptimizerConfig),
            ("scheduler", SchedulerConfig),
            ("loss", LossConfig),
            ("distributed", DistributedConfig),
        ):
            value = getattr(self, name)
            if isinstance(value, dict):
                setattr(self, name, from_dict(cls, value))
        super().__post_init__()

    def trainer_config(self, num_classes: int = 80):
        """The port's runtime ``TrainerConfig`` with these settings."""
        from ..training.trainer import TrainerConfig

        return TrainerConfig(
            num_classes=num_classes,
            learning_rate=self.optimizer.learning_rate,
            weight_decay=self.optimizer.weight_decay,
            warmup_steps=self.scheduler.warmup_steps,
            total_steps=self.scheduler.total_steps,
            manifold_reg_alpha=self.loss.manifold_alpha,
            clip_regular=self.optimizer.clip_regular,
            clip_mhc=self.optimizer.clip_mhc,
            mhc_lr_factor=self.optimizer.mhc_lr_factor,
            project_every=self.optimizer.project_every,
            stability_check_every=self.stability_check_every,
            checkpoint_every_epochs=self.checkpoint_every_epochs,
            early_stopping_patience=self.early_stopping_patience,
            checkpoint_dir=self.checkpoint_dir,
            max_boxes=self.dataset.max_boxes,
            ema_decay=self.ema_decay,
            backbone_lr_factor=self.optimizer.backbone_lr_factor,
            use_plateau=self.scheduler.plateau,
            plateau_patience=self.scheduler.plateau_patience,
            plateau_factor=self.scheduler.plateau_factor,
            use_manifold_schedule=self.scheduler.manifold_aware,
            metrics_log=self.metrics_log,
            checkpoint_every_steps=self.checkpoint_every_steps,
        )
