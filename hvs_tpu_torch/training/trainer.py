"""ManifoldConstrainedTrainer: the train and eval steps and the host loop.

Counterpart of ``hvs_tpu/training/trainer.py`` (``TrainerConfig``,
``global_norm``, ``_prepare_images``, ``make_train_step``,
``make_eval_step``, ``ManifoldConstrainedTrainer`` with ``train_chunked``;
the bodies of ``make_train_chunk`` and ``make_val_chunk`` are in
``chunk.py``). One train step: the model forward in train mode (dropout,
mHC telemetry), the YOLO loss (``multi_task_loss`` for the multi-task
model) plus ``manifold_reg_alpha`` times the manifold regulariser,
autograd, the manifold-aware optimizer, the update scaled by ``lr_scale``,
and the optional parameter EMA; nothing in it reads
a value back to the host, so it can be captured in a CUDA graph. Validation
runs the model in eval mode without autograd, where the eligible mHC sites
launch the unfolded block. The host loops keep the JAX trainer's stability
checks (window maxima between checks in ``train_epoch``, chunk maxima in
``train_chunked``), LR corrections, plateau and manifold-aware controllers,
early stopping and checkpoints (``torch.save``).

The model and every tensor of the state live on one device: the CUDA card
unless ``device="cpu"`` is passed. Over a ``(data x model)`` mesh of
processes the data axis splits the batch and the model axis splits the
rule-matched parameters (``parallel/tensor.py``); checkpoints hold whole
tensors either way.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..data.device_pipeline import AugmentConfig, DeviceData, normalize
from ..device import DeviceLike, pin_matmul_precision, resolve_device
from ..models.layers import set_dropout_generator
from ..parallel.mesh import Mesh, shard_batch
from ..parallel.tensor import gather_tensors, shard_parameters, shard_tensors
from .losses import build_targets, manifold_regularization_loss, mhc_yolo_loss, \
    multi_task_loss
from .optimizer import ManifoldAwareOptimizer, global_norm  # noqa: F401 (re-exported)
from .schedule import (ManifoldAwareScheduler, PlateauSchedulerWithReset,
                       cosine_annealing_with_warmup)
from .stability import StabilityMonitor, StabilityThresholds

Tensor = torch.Tensor
Batch = Dict[str, Any]


@dataclass
class TrainerConfig:
    """Hyperparameters; the same fields and defaults as the JAX trainer's."""

    num_classes: int = 80
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    warmup_steps: int = 1000
    total_steps: int = 100_000
    manifold_reg_alpha: float = 0.01
    clip_regular: float = 1.0
    clip_mhc: float = 0.5
    mhc_lr_factor: float = 0.5
    project_every: int = 100
    sk_iters: int = 20
    stability_check_every: int = 100
    checkpoint_every_epochs: int = 5
    early_stopping_patience: int = 10
    checkpoint_dir: str = "checkpoints"
    max_boxes: int = 64
    ema_decay: float = 0.0  # 0 disables EMA
    cls_mode: str = "bce"
    cls_pos_weight: float = 1.0
    backbone_lr_factor: float = 1.0
    use_plateau: bool = False
    plateau_patience: int = 5
    plateau_factor: float = 0.5
    use_manifold_schedule: bool = False
    metrics_log: Optional[str] = None
    checkpoint_every_steps: int = 0  # 0 disables
    # Alert threshold on the PRE-clip global gradient norm (see the JAX config).
    grad_explosion_threshold: float = 2000.0


@dataclass
class TrainState:
    """What the step changes besides the model's parameters and the
    optimizer's state: the step count, the host-set LR multiplier, and the
    parameter EMA (None when disabled)."""

    step: int = 0
    lr_scale: float = 1.0
    ema_params: Optional[Dict[str, Tensor]] = None


def prepare_images(images: Tensor) -> Tensor:
    """uint8 batches are normalized on the device (ImageNet mean and std);
    float batches pass through (already normalized)."""
    if images.dtype == torch.uint8:
        return normalize(images.float() / 255.0)
    return images


def batch_to(batch: Batch, device: torch.device) -> Dict[str, Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(v, Tensor) else v).to(device)
            for k, v in batch.items()}


def _targets(config: TrainerConfig, images: Tensor, batch: Dict[str, Tensor]):
    h, w = images.shape[1], images.shape[2]
    grids = [(h // 8, w // 8), (h // 16, w // 16), (h // 32, w // 32)]
    return build_targets(batch["boxes"], batch["labels"], batch["box_mask"], grids,
                         config.num_classes)


def task_loss(config: TrainerConfig, task: str, outputs: Dict[str, Any],
              batch: Dict[str, Tensor], targets, mesh: Optional[Mesh] = None
              ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The loss a step of ``task`` minimises before the regulariser, with its
    metrics: the YOLO loss for ``"detection"`` (``detection_loss``), and
    ``multi_task_loss`` over the heads that ran for ``"multi_task"`` (its
    dense labels are ``batch["seg_labels"]`` and ``batch["depth"]``).
    A data-parallel ``mesh`` sums the batch statistics over its processes."""
    if task == "multi_task":
        return multi_task_loss(outputs, {**batch, "targets": targets}, config.num_classes,
                               mesh=mesh)
    loss, metrics = mhc_yolo_loss(outputs["detection"]["raw"], targets, config.num_classes,
                                  cls_mode=config.cls_mode, cls_pos_weight=config.cls_pos_weight,
                                  mesh=mesh)
    return loss, {**metrics, "detection_loss": loss}


# Metrics equal on every data-parallel process (functions of the parameters,
# of global counts, or of the summed gradients); the others are each
# process's share of a global sum, except signal_ratio_mean, a mean.
SHARED_METRICS = ("grad_norm", "lr", "num_positives", "manifold_ds", "manifold_spectral",
                  "manifold_smooth", "ds_error_max")


def _sum_gradients(grads: Dict[str, Tensor], mesh: Mesh) -> Dict[str, Tensor]:
    """The gradients summed over the processes of ``mesh``: one all-reduce
    of all of them flattened into one fp32 buffer."""
    import torch.distributed as dist

    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1).float() for n in names])
    dist.all_reduce(flat, group=mesh.group)
    out, offset = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[offset:offset + g.numel()].view(g.shape).to(g.dtype)
        offset += g.numel()
    return out


def _reduce_metrics(metrics: Dict[str, Tensor], mesh: Mesh) -> Dict[str, Tensor]:
    """The global batch's metrics from each process's: the shares summed
    (one all-reduce), the shared ones kept. ``signal_ratio_mean``, telemetry
    and a ratio of mean norms, is averaged over the processes: close to the
    global batch's value, not equal to it."""
    keys = [k for k in metrics if k not in SHARED_METRICS]
    total = mesh.all_sum(torch.stack([metrics[k].float().reshape(()) for k in keys]))
    out = dict(metrics)
    for i, k in enumerate(keys):
        out[k] = total[i] / mesh.data if k == "signal_ratio_mean" else total[i]
    return out


def step_on_device(model: nn.Module, tx: ManifoldAwareOptimizer, config: TrainerConfig,
                   batch: Dict[str, Tensor], lr_scale: Union[float, Tensor] = 1.0,
                   ema_params: Optional[Dict[str, Tensor]] = None, task: str = "detection",
                   mesh: Optional[Mesh] = None
                   ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """The device work of one optimizer step on ``batch``: updates the
    model's parameters, ``tx`` (its count included) and ``ema_params`` in
    place and changes nothing on the host, so a CUDA graph can capture it.
    ``task`` ("detection" or "multi_task") is the forward's task and picks
    the loss (``task_loss``). Returns (metrics as 0-dim tensors, the
    gradients by parameter name); the metrics include ``lr``, the schedule's
    rate at this step.

    Data parallelism (``mesh`` with a process group): ``batch`` is this
    process's share of the global batch. JAX's step sees the global batch,
    so its loss divides by global counts; here the counts are summed over the
    processes before the division (``task_loss`` with the ``mesh``), so each
    process's loss is its share of the global loss, the regulariser (a
    function of the parameters alone) is added on the first process only,
    and the gradients are summed. Every process then clips by the same
    global norm and applies the same update: the processes together take
    the one-process step on the global batch. The metrics are the global
    batch's (``_reduce_metrics``)."""
    model.train()
    dp = mesh is not None and mesh.distributed
    images = prepare_images(batch["images"])
    targets = _targets(config, images, batch)
    params = dict(model.named_parameters())
    outputs = model(images, task=task)
    main_loss, main_metrics = task_loss(config, task, outputs, batch, targets,
                                        mesh if dp else None)
    reg_loss, reg_metrics = manifold_regularization_loss(params, sk_iters=config.sk_iters)
    reg_weight = config.manifold_reg_alpha if not dp or mesh.rank == 0 else 0.0
    loss = main_loss + reg_weight * reg_loss
    # Parameters the loss does not reach (the feature head) get zeros, as in JAX.
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                 materialize_grads=True)))
    if dp:
        grads = _sum_gradients(grads, mesh)

    grad_norm = tx.global_norm(grads)
    lr = tx.lr(tx.count)
    if not isinstance(lr, Tensor):
        lr = torch.full((), lr, dtype=torch.float32, device=loss.device)
    tx.step(grads, lr_scale)
    if config.ema_decay > 0.0 and ema_params is not None:
        d = config.ema_decay
        names = list(ema_params)
        ema = [ema_params[n] for n in names]
        with torch.no_grad():
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [params[n].to(e.dtype) for n, e in zip(names, ema)],
                                alpha=1.0 - d)

    metrics = {**main_metrics, **reg_metrics, "loss": loss, "grad_norm": grad_norm, "lr": lr}
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    stability = outputs.get("stability", {})
    if stability:
        metrics["ds_error_max"] = torch.stack([m["ds_error"] for m in stability.values()]).max()
        metrics["signal_ratio_mean"] = torch.stack(
            [m["signal_ratio"] for m in stability.values()]).mean()
    if dp:
        metrics = _reduce_metrics(metrics, mesh)
    return metrics, grads


def train_step(model: nn.Module, tx: ManifoldAwareOptimizer, config: TrainerConfig,
               state: TrainState, batch: Dict[str, Tensor], task: str = "detection",
               mesh: Optional[Mesh] = None) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """One optimizer step on ``batch`` (tensors on the model's device; this
    process's share under data parallelism) for ``task`` (as
    ``step_on_device``).

    Updates the model's parameters, ``tx`` and ``state`` in place; returns
    (metrics as 0-dim tensors, the gradients by parameter name).
    """
    out = step_on_device(model, tx, config, batch, state.lr_scale, state.ema_params, task,
                         mesh)
    state.step += 1
    return out


@torch.no_grad()
def eval_step(model: nn.Module, config: TrainerConfig, batch: Dict[str, Tensor],
              params: Optional[Dict[str, Tensor]] = None) -> Dict[str, Tensor]:
    """Validation loss on ``batch``: the model in eval mode (deterministic,
    no autograd), optionally with other ``params`` (the EMA) swapped in."""
    model.eval()
    images = prepare_images(batch["images"])
    targets = _targets(config, images, batch)
    if params is None:
        outputs = model(images)
    else:
        outputs = torch.func.functional_call(model, params, (images,))
    loss, metrics = mhc_yolo_loss(outputs["detection"]["raw"], targets, config.num_classes,
                                  cls_mode=config.cls_mode, cls_pos_weight=config.cls_pos_weight)
    return {"val_loss": loss, **{f"val_{k}": torch.as_tensor(v) for k, v in metrics.items()}}


def _host(metrics: Dict[str, Tensor]) -> Dict[str, float]:
    """All metrics to the host in one transfer."""
    keys = list(metrics)
    values = torch.stack([metrics[k].float().reshape(()) for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


class ManifoldConstrainedTrainer:
    """Host-side training loop for a ``HybridVisionSystem``.

    ``seed`` seeds the dropout generator (the model's own init is seeded at
    construction). The model is moved to ``device``.

    ``mesh`` (``parallel.setup``'s; None: this process alone) with a
    process group makes the trainer data-parallel, one process per card,
    each on the device ``setup`` returned: ``init_state`` broadcasts
    the first process's parameters, each step takes this process's share of
    the global batch (``step_on_device``), the process at rank r draws from
    the stream ``seed + r``, and the first process alone writes the metrics
    log and the checkpoints, which every process can load.

    A mesh with ``model > 1`` (tensor parallelism; its processes joined):
    ``init_state`` broadcasts the first process's parameters and then keeps
    this process's block of each rule-matched one
    (``parallel.tensor.shard_parameters``); the processes of a model group
    take the same batch and draw from the same stream (``seed`` plus the
    data rank), so their dropout masks agree, and compute one step together.
    Checkpoints gather the parameters, the EMA and the optimizer's moments
    into the one-process layout, and loading one keeps this process's
    blocks. The captured loops (``train_chunked``, the multi-task chunks)
    cannot capture the collectives of the sharded layers and raise.
    """

    def __init__(self, model: nn.Module, config: TrainerConfig = TrainerConfig(),
                 device: DeviceLike = None, seed: int = 0, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else Mesh(data=1)
        if self.mesh.model > 1 and not self.mesh.sharded:
            raise ValueError(f"a mesh with model={self.mesh.model} needs its processes joined "
                             f"(parallel.setup): it has no model group")
        pin_matmul_precision()  # process-wide: fp32 accumulation, as the reference
        self.model = model.to(self.device)
        self.config = config
        self.generator = torch.Generator(device=self.device).manual_seed(seed + self.mesh.rank)
        set_dropout_generator(self.model, self.generator)
        self.monitor = StabilityMonitor(
            StabilityThresholds(grad_explosion=config.grad_explosion_threshold))
        self.history: Dict[str, list] = {"train_loss": [], "val_loss": []}
        self.best_val_loss = float("inf")
        self.epochs_without_improvement = 0
        # lr_scale = stability corrections x plateau x manifold-aware.
        self._stab_scale = 1.0
        self.plateau = (PlateauSchedulerWithReset(factor=config.plateau_factor,
                                                  patience=config.plateau_patience)
                        if config.use_plateau else None)
        self.manifold_sched = ManifoldAwareScheduler() if config.use_manifold_schedule else None
        # Max since the last check, so a spike between checks is not missed.
        self._window_max: Dict[str, float] = {}
        self._metrics_fh = None
        self.schedule = cosine_annealing_with_warmup(config.learning_rate, config.warmup_steps,
                                                     config.total_steps)
        self.tx: Optional[ManifoldAwareOptimizer] = None
        self.state: Optional[TrainState] = None
        # The split axis of each parameter held as a block (tensor parallelism).
        self.sharded: Dict[str, int] = {}

    def params(self) -> Dict[str, Tensor]:
        return dict(self.model.named_parameters())

    # ------------------------------------------------------------------
    def init_state(self, sample_batch: Optional[Batch] = None) -> TrainState:
        """A fresh optimizer and train state for the model's current
        parameters (the model is initialised at construction, so the sample
        batch the JAX trainer needs for ``init`` is not used)."""
        del sample_batch
        c = self.config
        if self.mesh.distributed or self.mesh.sharded:
            import torch.distributed as dist

            with torch.no_grad():
                if not self.sharded:  # whole parameters, from the first process to all
                    for p in self.params().values():
                        dist.broadcast(p.data, src=0)
                elif self.mesh.distributed:  # blocks, from the first of each data group
                    src = dist.get_global_rank(self.mesh.group, 0)
                    for p in self.params().values():
                        dist.broadcast(p.data, src=src, group=self.mesh.group)
            if self.mesh.sharded and not self.sharded:
                self.sharded = shard_parameters(self.model, self.mesh)
        self.tx = ManifoldAwareOptimizer(
            self.params(), self.schedule, weight_decay=c.weight_decay,
            mhc_lr_factor=c.mhc_lr_factor, clip_regular=c.clip_regular, clip_mhc=c.clip_mhc,
            project_every=c.project_every, sk_iters=c.sk_iters,
            backbone_lr_factor=c.backbone_lr_factor, sharded=self.sharded, mesh=self.mesh)
        ema = ({k: v.detach().clone() for k, v in self.params().items()}
               if c.ema_decay > 0.0 else None)
        self.state = TrainState(step=0, lr_scale=1.0, ema_params=ema)
        # state.lr_scale on the device, for the captured steps of
        # train_chunked; written from the host between chunks.
        self.lr_scale_t = torch.ones((), dtype=torch.float32, device=self.device)
        return self.state

    def state_tensors(self) -> list:
        """Every tensor a train step changes in place: the parameters, the
        optimizer's count and moments, and the EMA."""
        tensors = list(self.params().values()) + [self.tx.count]
        for group in (self.tx.mu, self.tx.nu, self.tx.trace, self.state.ema_params or {}):
            tensors += list(group.values())
        return tensors

    def train_step(self, batch: Batch) -> Dict[str, Tensor]:
        """One step. Under data parallelism a batch of host (numpy) arrays
        is the global batch, of which this process takes its slice
        (``shard_batch``, as the JAX trainer does); a batch of tensors is
        this process's share already (``ShardedDataLoader`` yields those)."""
        assert self.state is not None, "call init_state first"
        host = not any(isinstance(v, Tensor) for v in batch.values())
        if self.mesh.distributed and host:
            batch = shard_batch(self.mesh, batch, self.device)
        metrics, _ = train_step(self.model, self.tx, self.config, self.state,
                                batch_to(batch, self.device), mesh=self.mesh)
        return metrics

    @property
    def is_writer(self) -> bool:
        """Whether this process writes logs and checkpoints (the first)."""
        return self.mesh.process_index == 0

    # ------------------------------------------------------------------
    def train_epoch(self, loader: Iterable, epoch: int) -> Dict[str, float]:
        """One epoch with periodic stability checks and corrections; the
        check reads the maximum since the last check of the spike-prone
        scalars. Returns the epoch means of the step metrics."""
        agg: Dict[str, float] = {}
        n = 0
        for batch in loader:
            host = _host(self.train_step(batch))
            for k in ("grad_norm", "loss", "ds_error_max", "signal_ratio_mean"):
                if k in host and np.isfinite(host[k]):
                    self._window_max[k] = max(self._window_max.get(k, 0.0), host[k])
            step = self.state.step
            self._log_step_metrics(step, host)
            if step % self.config.stability_check_every == 0:
                check = dict(host)
                for k in ("grad_norm", "ds_error_max", "signal_ratio_mean"):
                    if k in self._window_max:
                        check[k] = self._window_max[k]
                report = self.monitor.check_stability(check, params=self.params())
                self._window_max = {}
                if self.manifold_sched is not None:
                    self.manifold_sched.step(check)
                    self._sync_lr_scale()
                if not report["is_stable"]:
                    self._apply_stability_corrections(report)
                elif self._stab_scale < 1.0:
                    # Corrections are a brake, not a ratchet: recover after clean checks.
                    self._stab_scale = min(self._stab_scale * 1.25, 1.0)
                    self._sync_lr_scale()
            if self.config.checkpoint_every_steps and \
                    step % self.config.checkpoint_every_steps == 0:
                self.save_checkpoint(f"step_{step}")
            n += 1
            for k, v in host.items():
                agg[k] = agg.get(k, 0.0) + v
        return {k: v / max(n, 1) for k, v in agg.items()}

    def _log_step_metrics(self, step: int, host: Dict[str, float]) -> None:
        if self.config.metrics_log is None or not self.is_writer:
            return
        if self._metrics_fh is None:
            self._metrics_fh = open(self.config.metrics_log, "a", buffering=1)
        row = {"step": step, "time": time.time(), "lr_scale": self.state.lr_scale}
        for k in ("loss", "grad_norm", "detection_loss", "ds_error_max", "signal_ratio_mean",
                  "reg_loss", "lr"):
            if k in host:
                row[k] = host[k]
        self._metrics_fh.write(json.dumps(row) + "\n")

    def close(self) -> None:
        """Close the per-step metrics log, if one is open."""
        if self._metrics_fh is not None:
            self._metrics_fh.close()
            self._metrics_fh = None

    def _sync_lr_scale(self) -> None:
        scale = self._stab_scale
        if self.plateau is not None:
            scale *= self.plateau.scale
        if self.manifold_sched is not None:
            scale *= self.manifold_sched.scale
        # The JAX trainer keeps lr_scale as an fp32 array.
        self.state.lr_scale = float(np.float32(max(scale, 1e-3)))

    def _apply_stability_corrections(self, report: Dict[str, Any]) -> None:
        """Halve the LR multiplier on instability."""
        self._stab_scale = max(self._stab_scale * 0.5, 1e-3)
        self._sync_lr_scale()
        self.monitor.record_correction(self.state.lr_scale)

    # ------------------------------------------------------------------
    def train_chunked(self, data: DeviceData, total_steps: int, batch_size: int = 16,
                      out_sizes: Sequence[int] = (416,),
                      batch_sizes: Optional[Dict[int, int]] = None, chunk_steps: int = 100,
                      aug: Optional[AugmentConfig] = None, val_data: Optional[DeviceData] = None,
                      val_out_size: Optional[int] = None, val_batch_size: int = 8,
                      val_every_chunks: int = 10, eig_every_chunks: int = 10,
                      progress_fn: Optional[Callable[[Dict[str, Any]], None]] = None
                      ) -> Dict[str, Any]:
        """The on-device training loop: ``data`` lives in device memory
        (``put_device_data``), each step draws and augments its batch on the
        device, and the host sees one [chunk_steps, n_metrics] block per
        chunk.

        One captured step per entry of ``out_sizes`` (batch from
        ``batch_sizes``, else ``batch_size``), all in one graph memory pool,
        cycled round-robin per chunk (``self.chunks``; the validation graph
        is ``self.val_chunk``). Per chunk, on the host: the per-step JSONL
        rows, the stability check on the chunk maxima of ``grad_norm``,
        ``ds_error_max`` and ``signal_ratio_mean`` and the chunk mean of
        ``loss`` (NaN if a step's loss is not finite), the eigenvalue
        telemetry every ``eig_every_chunks``, the manifold scheduler and the
        LR corrections (reaching the step through ``lr_scale_t``),
        validation with a best checkpoint every ``val_every_chunks``, and a
        checkpoint every ``config.checkpoint_every_steps``. Arguments and the
        returned dict are the JAX trainer's.
        """
        from .chunk import TrainChunk, ValChunk
        from .stability import make_eig_telemetry

        assert self.state is not None, "call init_state first"
        aug = aug if aug is not None else AugmentConfig()
        batch_sizes = dict(batch_sizes or {})
        pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.chunks = {o: TrainChunk(self, data, o, self._share(batch_sizes.get(o, batch_size)),
                                     chunk_steps, aug, pool=pool) for o in out_sizes}
        self.val_chunk = None
        if val_data is not None:
            self.val_chunk = ValChunk(self, val_data, val_batch_size,
                                      val_out_size or max(out_sizes),
                                      int(val_data.images.shape[0]) // val_batch_size, pool=pool)
        eig_fn = make_eig_telemetry(self.config.sk_iters)

        n_chunks = total_steps // chunk_steps
        t_start = time.time()
        last_eig: Dict[str, float] = {}
        for ci in range(n_chunks):
            o = out_sizes[ci % len(out_sizes)]
            self.lr_scale_t.fill_(self.state.lr_scale)
            host = self.chunks[o].run()  # one pull per chunk
            first_step = self.state.step + 1
            self.state.step += chunk_steps
            step_now = self.state.step

            if self.config.metrics_log is not None:
                for i in range(chunk_steps):
                    self._log_step_metrics(first_step + i,
                                           {k: float(v[i]) for k, v in host.items()})

            check = {"loss": float(np.nanmean(host["loss"])),
                     "grad_norm": float(np.nanmax(host["grad_norm"]))}
            for k in ("ds_error_max", "signal_ratio_mean"):
                if k in host:
                    check[k] = float(np.nanmax(host[k]))
            if not np.all(np.isfinite(host["loss"])):
                check["loss"] = float("nan")
            if eig_every_chunks and ci % eig_every_chunks == 0:
                last_eig = _host(eig_fn(self.params()))
                check.update(last_eig)
            report = self.monitor.check_stability(check)
            if self.manifold_sched is not None:
                self.manifold_sched.step(check)
                self._sync_lr_scale()
            if not report["is_stable"]:
                self._apply_stability_corrections(report)
            elif self._stab_scale < 1.0:
                self._stab_scale = min(self._stab_scale * 1.25, 1.0)
                self._sync_lr_scale()

            val_loss = None
            if self.val_chunk is not None and (ci + 1) % val_every_chunks == 0:
                val_loss = self.val_chunk.run()
                self.history["val_loss"].append(val_loss)
                if val_loss < self.best_val_loss:
                    self.best_val_loss = val_loss
                    self.save_checkpoint("best")
            every = self.config.checkpoint_every_steps
            if every and step_now // every > first_step // every:
                self.save_checkpoint(f"step_{step_now}")
            self.history["train_loss"].append(float(np.nanmean(host["loss"])))

            if progress_fn is not None:
                progress_fn({
                    "chunk": ci, "step": step_now, "out_size": o, "loss": check["loss"],
                    "grad_norm_max": check["grad_norm"],
                    "ds_error_max": check.get("ds_error_max"), "val_loss": val_loss,
                    "lr_scale": self.state.lr_scale,
                    "steps_per_sec": step_now / max(time.time() - t_start, 1e-9),
                    **{f"eig_{k}": v for k, v in last_eig.items()},
                })
        return {"history": self.history, "best_val_loss": self.best_val_loss,
                "steps_per_sec": n_chunks * chunk_steps / max(time.time() - t_start, 1e-9)}

    def _share(self, global_batch: int) -> int:
        """This process's share of a global batch."""
        if global_batch % self.mesh.data:
            raise ValueError(f"a global batch of {global_batch} does not split over "
                             f"{self.mesh.data} data-parallel processes")
        return global_batch // self.mesh.data

    # ------------------------------------------------------------------
    def eval_params(self, use_ema: bool = True) -> Optional[Dict[str, Tensor]]:
        """The EMA weights when maintained, else None (the model's own)."""
        if use_ema and self.state is not None and self.state.ema_params is not None:
            return self.state.ema_params
        return None

    def validate(self, loader: Iterable, use_ema: bool = True) -> Dict[str, float]:
        params = self.eval_params(use_ema)
        agg: Dict[str, float] = {}
        n = 0
        for batch in loader:
            metrics = _host(eval_step(self.model, self.config, batch_to(batch, self.device),
                                      params))
            n += 1
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + v
        return {k: v / max(n, 1) for k, v in agg.items()}

    # ------------------------------------------------------------------
    def train(self, train_loader_fn: Callable[[], Iterable],
              val_loader_fn: Optional[Callable[[], Iterable]] = None, epochs: int = 1,
              resume_from: Optional[str] = None) -> Dict[str, Any]:
        """Epochs with validation, early stopping and checkpoints."""
        if self.state is None:
            self.init_state()
        if resume_from:
            self.load_checkpoint(resume_from)
        for epoch in range(epochs):
            train_metrics = self.train_epoch(train_loader_fn(), epoch)
            self.history["train_loss"].append(train_metrics.get("loss", float("nan")))
            if val_loader_fn is not None:
                val_metrics = self.validate(val_loader_fn())
                self.history["val_loss"].append(val_metrics["val_loss"])
                if self.plateau is not None:
                    self.plateau.step(val_metrics["val_loss"])
                    self._sync_lr_scale()
                if val_metrics["val_loss"] < self.best_val_loss:
                    self.best_val_loss = val_metrics["val_loss"]
                    self.epochs_without_improvement = 0
                    self.save_checkpoint("best")
                else:
                    self.epochs_without_improvement += 1
                if self.epochs_without_improvement >= self.config.early_stopping_patience:
                    break
            if (epoch + 1) % self.config.checkpoint_every_epochs == 0:
                self.save_checkpoint(f"epoch_{epoch + 1}")
        return {"history": self.history, "best_val_loss": self.best_val_loss}

    # ------------------------------------------------------------------
    def _path(self, name: str) -> str:
        if os.path.isabs(name):
            return name
        return os.path.abspath(os.path.join(self.config.checkpoint_dir, name))

    def _whole(self, tensors: Optional[Dict[str, Tensor]]) -> Optional[Dict[str, Tensor]]:
        """Tensors keyed by parameter name in the one-process layout: the
        blocks gathered over the model group (every process of it calls)."""
        if tensors is None or not self.sharded:
            return tensors
        return gather_tensors(tensors, self.sharded, self.mesh)

    def _blocks(self, tensors: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """This process's blocks of tensors in the one-process layout."""
        return shard_tensors(tensors, self.sharded, self.mesh) if self.sharded else tensors

    def save_checkpoint(self, name: str) -> str:
        """The full train state (parameters, optimizer state, step, lr_scale,
        EMA) with ``torch.save``, and the history beside it as JSON, in the
        one-process layout. Over several processes the first writes (the
        whole state is the same on every process once the blocks are
        gathered) and the others wait until it has."""
        path = self._path(name)
        opt = self.tx.state_dict()
        state = {"params": self._whole({k: v.detach() for k, v in self.params().items()}),
                 "opt_state": {"count": opt["count"],
                               **{k: self._whole(opt[k]) for k in ("mu", "nu", "trace")}},
                 "step": self.state.step, "lr_scale": self.state.lr_scale,
                 "ema_params": self._whole(self.state.ema_params)}
        joined = self.mesh.distributed or self.mesh.sharded
        if joined and not self.is_writer:
            self._barrier()
            return path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(state, path + ".pt")
        with open(path + ".history.json", "w") as f:
            json.dump(self.history, f)
        if joined:
            self._barrier()
        return path

    def _barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier()

    def load_checkpoint(self, name_or_path: str) -> None:
        """Restore a state written by ``save_checkpoint`` onto the live model
        and optimizer (``init_state`` first); a process of a model group
        keeps its blocks."""
        assert self.state is not None, "init_state before load_checkpoint"
        path = self._path(name_or_path)
        ckpt = torch.load(path + ".pt", map_location=self.device)
        with torch.no_grad():
            params = self._blocks(ckpt["params"])
            for name, p in self.params().items():
                p.copy_(params[name])
        opt = ckpt["opt_state"]
        self.tx.load_state_dict({"count": opt["count"],
                                 **{k: self._blocks(opt[k]) for k in ("mu", "nu", "trace")}})
        ema = ckpt.get("ema_params")
        if ema is not None and self.state.ema_params is not None:
            ema = self._blocks(ema)
            for name, e in self.state.ema_params.items():
                e.copy_(ema[name])
        self.state.step = int(ckpt["step"])
        self.state.lr_scale = float(ckpt["lr_scale"])
        hist = path + ".history.json"
        if os.path.exists(hist):
            with open(hist) as f:
                self.history = json.load(f)

