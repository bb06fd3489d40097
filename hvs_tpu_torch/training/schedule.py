"""Learning-rate schedules: warmup-cosine, plateau-with-reset, manifold-aware.

Counterpart of ``hvs_tpu/training/schedule.py``. The warmup-cosine schedule
is a function of the step: of a Python int in fp64 on the host, or of a
0-dim integer tensor in fp32 on that tensor's device (as the JAX schedule
computes under ``jit``), so a captured train step can read the step count
from the card. The plateau and manifold-aware schedulers are host-side
controllers that emit a multiplicative ``lr_scale`` for the trainer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Union

import torch

Schedule = Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]


def cosine_annealing_with_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                                 min_lr_ratio: float = 0.01) -> Schedule:
    """Linear warmup from 0, then cosine decay to ``min_lr_ratio·base_lr``."""

    def schedule(step):
        if isinstance(step, torch.Tensor):
            s = step.float()
            warm = base_lr * s / max(warmup_steps, 1)
            progress = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                                   0.0, 1.0)
            cos = base_lr * (min_lr_ratio + (1 - min_lr_ratio) * 0.5
                             * (1 + torch.cos(math.pi * progress)))
            return torch.where(s < warmup_steps, warm, cos)
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        progress = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return base_lr * (min_lr_ratio + (1 - min_lr_ratio) * 0.5 * (1 + math.cos(math.pi * progress)))

    return schedule


@dataclass
class PlateauSchedulerWithReset:
    """Reduce-on-plateau with optional warm restarts: a multiplicative factor;
    call :meth:`step` with the monitored metric."""

    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-3
    min_scale: float = 1e-3
    reset_after: Optional[int] = None  # reductions before a warm restart

    scale: float = 1.0
    best: float = float("inf")
    bad_epochs: int = 0
    num_reductions: int = 0

    def step(self, metric: float) -> float:
        if metric < self.best - self.threshold:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            self.num_reductions += 1
            if self.reset_after and self.num_reductions >= self.reset_after:
                self.scale = 1.0
                self.num_reductions = 0
                self.best = float("inf")
            else:
                self.scale = max(self.scale * self.factor, self.min_scale)
        return self.scale


@dataclass
class ManifoldAwareScheduler:
    """Scale the LR down when a stability threshold is exceeded (gradient
    norm, Sinkhorn error, eigenvalue excess); recover slowly when healthy."""

    grad_norm_threshold: float = 10.0
    sk_error_threshold: float = 0.01
    eigenvalue_threshold: float = 1.1
    reduction_factor: float = 0.7
    recovery_factor: float = 1.02
    min_scale: float = 1e-3
    max_scale: float = 1.0

    scale: float = 1.0
    history: list = field(default_factory=list)

    def step(self, metrics: Dict[str, float]) -> float:
        unstable = (metrics.get("grad_norm", 0.0) > self.grad_norm_threshold
                    or metrics.get("ds_error_max", 0.0) > self.sk_error_threshold
                    or metrics.get("max_eigenvalue", 0.0) > self.eigenvalue_threshold)
        if unstable:
            self.scale = max(self.scale * self.reduction_factor, self.min_scale)
        else:
            self.scale = min(self.scale * self.recovery_factor, self.max_scale)
        self.history.append(self.scale)
        return self.scale
