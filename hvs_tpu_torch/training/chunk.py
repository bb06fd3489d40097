"""The steps of the on-device training loop: a train step that draws and
augments its own batch, and a validation batch, each captured once in a CUDA
graph and replayed.

Counterpart of the bodies of ``make_train_chunk`` and ``make_val_chunk``
(``hvs_tpu/training/trainer.py``). JAX compiles a ``lax.scan`` over K steps
into one program; here one train step (draw → augment → ``step_on_device``:
forward, loss, backward, optimizer, EMA → its metrics row) is captured once
per (resolution, batch) and replayed K times with no host sync between
replays. Every value that changes from step to step lives on the device and
is updated inside the graph: the parameters, the optimizer's state and
count (from which the learning rate, Adam's bias corrections and the
projection test are computed), the EMA, the generator's offset (registered
with the graph, so each replay draws new indices, augmentations and dropout
masks) and the row the metrics go to. The host writes ``lr_scale`` and
resets the row between chunks, and pulls the [K, n_metrics] block once per
chunk.

On the CPU the same step runs eagerly, step by step.

Under data parallelism (the trainer's ``mesh`` holds a process group) each
process holds the whole dataset, as JAX's ``put_device_data`` replicates
it, draws its share of the global batch from its own generator stream, and
the step's all-reduces (the loss's counts, the gradients, the metrics) are
captured in the graph with the rest: NCCL collectives replay like any other
kernel. JAX's ``train_chunked`` puts no sharding constraint on its sampled
batch; the split by process is the explicit form of the same data
parallelism. Validation runs replicated, the whole split on every process
(the parameters are equal, so is the result).

Kernel launch counters (``ops/sinkhorn.py``, ``ops/mhc_block.py``) count
when the host launches a kernel, so they advance at capture and not at a
replay; each object records the counts of its captured step
(``launches``), and its launches on a path are those times ``replays``.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, List, Optional

import numpy as np
import torch

from ..data.device_pipeline import (AugmentConfig, AugmentDraws, DeviceData, apply_augment,
                                    draw_augment, eval_batch)
from ..ops import mhc_block as _mhc_mod
from ..ops import sinkhorn as _sink_mod

if TYPE_CHECKING:
    from .trainer import ManifoldConstrainedTrainer

Tensor = torch.Tensor
WARMUP_STEPS = 2  # eager steps before a capture (kernels loaded, constants cached)


def _refuse_sharded(trainer: "ManifoldConstrainedTrainer") -> None:
    """A CUDA graph cannot capture the collectives of the sharded layers
    (gloo's in particular): tensor parallelism trains through the eager
    ``train`` loop."""
    if trainer.mesh.model > 1:
        raise NotImplementedError(
            f"the captured train and validation steps under tensor parallelism (a mesh with "
            f"model={trainer.mesh.model}) are not written (ROADMAP item 6b's remainder); "
            f"train through ManifoldConstrainedTrainer.train")


def kernel_counts() -> Dict[str, int]:
    """The package's kernel launch counters."""
    return {"mhc_block": _mhc_mod.launches, "mhc_block_unfolded": _mhc_mod.launches_unfolded,
            "sinkhorn_forward": _sink_mod.launches_forward,
            "sinkhorn_backward": _sink_mod.launches_backward}


def _captured(fn, device: torch.device, pool, generator: Optional[torch.Generator] = None
              ) -> "tuple[torch.cuda.CUDAGraph, Dict[str, int]]":
    """Capture ``fn`` into a CUDA graph (in ``pool``); returns the graph and
    the kernel launches made while capturing (one call's)."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError("this torch cannot register a generator with a CUDA graph "
                               "(CUDAGraph.register_generator_state); the captured train step "
                               "needs it to draw anew on every replay")
        graph.register_generator_state(generator)
    before = kernel_counts()
    with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool):
        fn()
    after = kernel_counts()
    return graph, {k: after[k] - before[k] for k in after}


def _warm_up(fn, device: torch.device, calls: int) -> None:
    """``calls`` eager calls of ``fn`` on a side stream, as a capture needs."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(calls):
            fn()
    current.wait_stream(side)


class TrainChunk:
    """K train steps at one (``out_size``, ``batch_size``), drawing their
    batches from ``data`` with ``trainer.generator``.

    On the card the step is captured at construction, after
    ``WARMUP_STEPS`` eager steps whose effect on the train state (the
    parameters, the optimizer's state and count, the EMA and the generator)
    is undone, so the state afterwards is the state before. ``pool`` is the
    memory pool the graphs of one loop share (they never replay at once).
    """

    task = "detection"  # the forward's task, which picks the loss (``trainer.task_loss``)

    def __init__(self, trainer: "ManifoldConstrainedTrainer", data: DeviceData, out_size: int,
                 batch_size: int, chunk_steps: int, aug: AugmentConfig = AugmentConfig(),
                 pool=None):
        _refuse_sharded(trainer)
        self.trainer = trainer
        self.data, self.out_size, self.batch_size = data, out_size, batch_size
        self.chunk_steps, self.aug = chunk_steps, aug
        self.device = trainer.device
        self.pos = torch.zeros((), dtype=torch.long, device=self.device)
        self.keys: List[str] = []
        self.metrics: Optional[Tensor] = None  # [chunk_steps, len(keys)] fp32
        self.last_draws: Optional[AugmentDraws] = None
        self.last_batch: Optional[Dict[str, Tensor]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self.peak_gb = 0.0  # the device's peak allocation once captured (since its last reset)
        self.replays = 0
        self.pulls = 0
        self.timings: List[Dict[str, float]] = []  # per chunk: wall and device ms
        if self.device.type == "cuda":
            self._capture(pool)

    def draw(self):
        """The random numbers of one batch, from the trainer's generator."""
        return draw_augment(self.trainer.generator, self.batch_size, self.data.images.shape[0],
                            self.aug, self.device)

    def batch_of(self, draws) -> Dict[str, Tensor]:
        """The batch that ``draws`` pick and augment."""
        return apply_augment(self.data, draws, self.out_size, self.aug)

    def step(self, draws=None) -> None:
        """One train step, run eagerly: ``draws`` (default: ``draw()``), its
        batch, ``step_on_device``, and its metrics at row ``pos`` of
        ``metrics``; ``pos`` advances. Nothing waits on the host."""
        from .trainer import step_on_device

        t = self.trainer
        if draws is None:
            draws = self.draw()
        batch = self.batch_of(draws)
        metrics, _ = step_on_device(t.model, t.tx, t.config, batch, t.lr_scale_t,
                                    t.state.ema_params, task=self.task, mesh=t.mesh)
        if self.metrics is None:
            self.keys = list(metrics)
            self.metrics = torch.zeros(self.chunk_steps, len(self.keys), dtype=torch.float32,
                                       device=self.device)
        row = torch.stack([metrics[k].float().reshape(()) for k in self.keys])
        self.metrics.index_copy_(0, self.pos.view(1), row.view(1, -1))
        self.pos.add_(1)
        self.last_draws, self.last_batch = draws, batch

    def _first_row_step(self) -> None:
        self.pos.zero_()
        self.step()

    def _capture(self, pool) -> None:
        t0 = time.perf_counter()
        state = self.trainer.state_tensors()
        saved = [x.detach().clone() for x in state]
        gen_state = self.trainer.generator.get_state()
        _warm_up(self._first_row_step, self.device, WARMUP_STEPS)
        with torch.no_grad():
            for x, v in zip(state, saved):
                x.copy_(v)
        self.trainer.generator.set_state(gen_state)
        self.pos.zero_()
        del saved
        self.graph, self.launches = _captured(self.step, self.device, pool,
                                              self.trainer.generator)
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.peak_gb = torch.cuda.max_memory_allocated(self.device) / 1e9

    def replay(self) -> None:
        """One captured step (on the card)."""
        self.graph.replay()
        self.replays += 1

    def run(self) -> Dict[str, np.ndarray]:
        """``chunk_steps`` steps, then one pull of their metrics: {name:
        [chunk_steps] values}. On the card the replays run with torch's
        sync debug mode set to "error": a host sync among them raises."""
        self.pos.zero_()
        t0 = time.perf_counter()
        if self.graph is None:
            for _ in range(self.chunk_steps):
                self.step()
            host = self.pull()
            self.timings.append({"wall_ms": (time.perf_counter() - t0) * 1e3})
            return host
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        previous = torch.cuda.get_sync_debug_mode()
        start.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(self.chunk_steps):
                self.replay()
        finally:
            torch.cuda.set_sync_debug_mode(previous)
        end.record()
        host = self.pull()
        self.timings.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                             "device_ms": start.elapsed_time(end)})
        return host

    def pull(self) -> Dict[str, np.ndarray]:
        """The metrics block to the host, in one copy."""
        block = self.metrics.cpu().numpy().copy()
        self.pulls += 1
        return {k: block[:, i] for i, k in enumerate(self.keys)}


class ValChunk:
    """The validation loss over ``n_batches`` contiguous batches of
    ``data`` (``eval_batch`` → ``eval_step`` on the trainer's evaluation
    weights, the EMA when it is kept), summed on the device and pulled once.
    On the card one batch is captured (the start row is a device counter)
    and replayed ``n_batches`` times."""

    n_totals = 1  # values each batch adds to ``total``

    def __init__(self, trainer: "ManifoldConstrainedTrainer", data, batch_size: int,
                 out_size: int, n_batches: int, pool=None):
        _refuse_sharded(trainer)
        if n_batches < 1:
            raise ValueError(f"validation needs at least one batch of {batch_size} images, "
                             f"got {data.images.shape[0]} images")
        self.trainer = trainer
        self.data, self.batch_size, self.out_size, self.n_batches = \
            data, batch_size, out_size, n_batches
        self.device = trainer.device
        self.start = torch.zeros((), dtype=torch.long, device=self.device)
        self.total = torch.zeros(self.n_totals, dtype=torch.float32, device=self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self.replays = 0
        self.pulls = 0
        self.timings: List[Dict[str, float]] = []
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            _warm_up(self._first_batch, self.device, WARMUP_STEPS)
            self.graph, self.launches = _captured(self.batch, self.device, pool)
            torch.cuda.synchronize(self.device)
            self.capture_s = time.perf_counter() - t0

    def batch(self) -> None:
        """One validation batch, run eagerly: adds its loss to ``total``."""
        from .trainer import eval_step

        t = self.trainer
        batch = eval_batch(self.data, self.start, self.batch_size, self.out_size)
        self.total.add_(eval_step(t.model, t.config, batch, t.eval_params())["val_loss"])
        self.start.add_(self.batch_size)

    def _first_batch(self) -> None:
        self.start.zero_()
        self.batch()

    def summarize(self, totals: np.ndarray):
        """The result from ``total`` summed over the split: the mean loss."""
        return float(totals[0]) / self.n_batches

    def run(self):
        """Every batch of the split, then one pull: ``summarize``'s result."""
        self.start.zero_()
        self.total.zero_()
        t0 = time.perf_counter()
        for _ in range(self.n_batches):
            if self.graph is None:
                self.batch()
            else:
                self.graph.replay()
                self.replays += 1
        result = self.summarize(self.total.cpu().numpy())
        self.pulls += 1
        self.timings.append({"wall_ms": (time.perf_counter() - t0) * 1e3})
        return result
