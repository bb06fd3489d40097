"""Serving engine: one captured CUDA graph per batch bucket, letterbox on the
card, a deadline-flush micro-batcher with admission control, and hot swap.

Counterpart of ``hvs_tpu/inference/engine.py`` with its public methods and
semantics. Where the JAX engine compiles one serve program per bucket (and
per raw source shape) and caches it to disk, this engine captures one CUDA
graph per bucket (and per registered raw source shape):

  * a serve function takes uint8 NHWC frames, divides by 255 and normalizes,
    runs the flagship forward with the mHC constraints computed at load
    (kernel B at load, kernel A at every eligible mHC site), decodes, runs
    class-aware NMS (``postprocessing.nms_method``: hard, soft or matrix)
    over the top ``pre_nms_top_k`` candidates,
    optionally ROI-pools appearance embeddings, and packs everything into
    one fp32 [B, K, 7(+C)] tensor, so one device-to-host copy returns a
    batch;
  * the raw-frame graphs letterbox on the card inside the graph (BGR -> RGB,
    bilinear resize without antialias, centred pad); other shapes are
    letterboxed eagerly on the card, rounded to uint8, and served by the
    letterboxed graphs;
  * ``dispatch_batch`` / ``finalize_batch`` split enqueueing from waiting, so
    the micro-batcher assembles batch N+1 while batch N runs.

While a ``torch.profiler`` runs in the process, the engine records spans of
its own work into ``engine.spans`` (``utils/tracing.py``): per batch
``engine.dispatch`` (children ``engine.ring_wait``, ``engine.stage``,
``engine.letterbox_eager``, ``engine.launch``) and ``engine.finalize``
(``engine.copyout_wait``, ``engine.postprocess``), ``engine.capture`` per
graph, the batcher's ``batcher.wait`` and ``batcher.assemble``, and per
request ``request.queued`` (submit to its batch's dispatch). Counters of
set-up and of the eager path are always kept (``get_performance_stats``).

On the CPU (``device="cpu"``) nothing is captured: the same serve functions
run eagerly, with the plain versions of the kernels.

With ``quantization.enabled`` the engine serves the int8 twin (W8A8,
``ops/quant.py``): its calibrated activation scales and its weights' int8
forms are device buffers that the graphs read in place, so a ``reload``
(new weights, or new scales) reaches every captured graph.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.inference import InferenceConfig
from ..config.model import ModelConfig
from ..constants import COCO_CLASSES, IMAGENET_MEAN, IMAGENET_STD
from ..convert import flatten, load_flax_quant, nest, to_port_layout
from ..data.dataset import letterbox, letterbox_geometry, letterbox_raw_batch
from ..device import DeviceLike, pin_matmul_precision, resolve_device
from ..models.constraints import compute_constraints, load_constraints, param_tree
from ..models.hybrid import detect
from ..models.layers import ManifoldHyperConnection
from ..models.quantize import load_quant_scales
from ..models.rag import roi_pool_bilinear
from ..ops.sinkhorn import doubly_stochastic_error, sinkhorn_log
from ..utils.metrics import InferenceMetrics
from ..utils.tracing import NO_SPAN, SpanRecorder, now_ns

WARMUP_CALLS = 3  # eager calls on a side stream before a capture


def _pack_outputs(det, emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(boxes, scores, classes, num_valid[, embeddings]) as ONE fp32 tensor
    [B, K, 7(+C)]: one device-to-host copy per batch."""
    b, k = det.scores.shape
    nv = det.num_valid.float()[:, None, None].expand(b, k, 1)
    parts = [det.boxes.float(), det.scores.float()[..., None], det.classes.float()[..., None],
             nv]
    if emb is not None:
        parts.append(emb.float())
    return torch.cat(parts, dim=-1)


def _unpack_outputs(packed: np.ndarray):
    """Host-side inverse of :func:`_pack_outputs`."""
    boxes = packed[..., :4]
    scores = packed[..., 4]
    classes = packed[..., 5].astype(np.int64)
    num_valid = packed[:, 0, 6].astype(np.int64)
    emb = packed[..., 7:] if packed.shape[-1] > 7 else None
    return boxes, scores, classes, num_valid, emb


def _roi_embeddings(model_out, boxes_norm: torch.Tensor) -> torch.Tensor:
    """Per-detection appearance embedding: the fused small scale ROI-pooled
    at the final boxes, L2-normalized (from the same forward)."""
    emb = roi_pool_bilinear(model_out["fused_features"]["fused_small"].float(), boxes_norm)
    return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-6)


@dataclass
class Detections:
    """Host-side detection result for one image (boxes in original pixels)."""

    boxes: np.ndarray  # [K, 4] xyxy pixels
    scores: np.ndarray  # [K]
    classes: np.ndarray  # [K] int
    class_names: List[str]
    latency_ms: float
    image_size: Tuple[int, int]  # (h, w)
    embeddings: Optional[np.ndarray] = None  # [K, C] L2-normalized (optional)

    def __len__(self) -> int:
        return len(self.boxes)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "boxes": self.boxes.tolist(),
            "scores": self.scores.tolist(),
            "classes": self.classes.tolist(),
            "class_names": self.class_names,
            "latency_ms": self.latency_ms,
        }


def checkpoint_params(path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The named weights of a checkpoint of the port's trainer (``<path>``
    or ``<path>.pt``): its EMA weights when ``use_ema`` is set and it has
    them, else its weights."""
    import os

    file = path if os.path.isfile(path) else path + ".pt"
    ckpt = torch.load(file, map_location="cpu")
    if use_ema and ckpt.get("ema_params") is not None:
        return ckpt["ema_params"]
    return ckpt.get("params", ckpt)


class _BucketServe:
    """One bucket's serve function over a fixed uint8 input buffer.

    On the card the function is captured once into a CUDA graph that reads
    ``static_in`` and writes ``static_out`` at fixed addresses. Every replay
    and copy runs on the engine's serve stream, under the engine's lock.
    On the CPU the function runs eagerly on ``static_in``.
    """

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], in_shape, device,
                 spans: SpanRecorder, stream=None, pool=None, staged: bool = False,
                 nms_method: str = "hard"):
        self.fn = fn
        self.device = device
        self.spans = spans
        # The NMS method is part of what the graph was captured for, as it is
        # part of the reference's program key.
        self.nms_method = nms_method
        self.static_in = torch.zeros(in_shape, dtype=torch.uint8, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_out: Optional[torch.Tensor] = None
        # Graph replays (eager calls on the CPU). The kernels' own counters
        # (ops/mhc_block.py) count launches at capture, not replays, so a
        # kernel's launches on this path are replays x its sites.
        self.replays = 0
        # Raw frames reach the card through a ring of two pinned buffers: the
        # host fills one while the other's copy may still be in flight, and a
        # buffer is refilled only after the copy that read it has finished.
        self._ring = [torch.zeros(in_shape, dtype=torch.uint8).pin_memory()
                      for _ in range(2)] if staged and device.type == "cuda" else []
        self._ring_read: List[Optional[torch.cuda.Event]] = [None, None]
        self._slot = 0
        self.capture_s = 0.0  # the warm-up calls and the capture
        if device.type == "cuda":
            t0 = time.perf_counter()
            with self.spans.span("engine.capture"):
                self._capture(stream, pool)
            self.capture_s = time.perf_counter() - t0

    def _capture(self, stream, pool) -> None:
        # Kernels are built and loaded, cuBLAS/cuDNN initialised and the
        # anchor grids cached by a few eager calls on a side stream first;
        # the capture itself must not load a module or copy from the host.
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side), torch.inference_mode():
            for _ in range(WARMUP_CALLS):
                self.fn(self.static_in)
        stream.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (the batcher, a reload) may use the card
        # while this thread captures. A failed capture raises: there is no
        # eager fallback on the card.
        with torch.inference_mode(), torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                                      capture_error_mode="thread_local"):
            self.static_out = self.fn(self.static_in)

    def serve_eager(self, images_u8: torch.Tensor) -> torch.Tensor:
        """The serve function run eagerly (not captured) on a full bucket."""
        with torch.inference_mode():
            return self.fn(images_u8)

    def stage(self, images: Sequence[np.ndarray], stream) -> None:
        """Copy host frames into ``static_in`` (rows past them zeroed). On
        the CPU there is no ring, and its wait is empty."""
        n = len(images)
        slot = self._slot
        self._slot ^= 1
        with self.spans.span("engine.ring_wait"):
            if self._ring_read[slot] is not None:
                self._ring_read[slot].synchronize()
        with self.spans.span("engine.stage"):
            if not self._ring:
                for i, img in enumerate(images):
                    self.static_in[i].copy_(torch.from_numpy(np.ascontiguousarray(img)))
                self.static_in[n:].zero_()
                return
            buf = self._ring[slot].numpy()
            for i, img in enumerate(images):
                buf[i] = img
            buf[n:] = 0
            self.static_in.copy_(self._ring[slot], non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
            self._ring_read[slot] = event

    def run(self, stream) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Replay (or call) the function on ``static_in``; returns the packed
        output on the host and, on the card, the event that marks it ready.

        The graph writes the same ``static_out`` on every replay, so right
        after the replay its output is copied, on the same stream, into a
        pinned host tensor of this call's own; the next replay is enqueued
        behind that copy. The graphs share one memory pool: one graph's
        intermediates may lie where another keeps its output, which is safe
        because every output is copied out before any other replay runs.
        """
        self.replays += 1
        if self.graph is None:
            return self.serve_eager(self.static_in), None
        self.graph.replay()
        host = torch.empty(self.static_out.shape, dtype=self.static_out.dtype, pin_memory=True)
        host.copy_(self.static_out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        return host, done


class InferenceEngine:
    """Single-model serving engine on one device.

    Args:
        model_config, inference_config: as the JAX engine's (defaults: the
            flagship and the default serving config).
        variables: weights, as a flax ``params`` tree (nested dicts of
            arrays, optionally under ``"params"``) or as the port's named
            parameters (``{dotted name: tensor}``, what ``load_checkpoint``
            returns). Without them, ``inference_config.checkpoint_path`` is
            read, else the model keeps its seeded random init (``rng_seed``).
        device: where to serve; default ``inference_config.device`` (the
            card unless ``"cpu"``). Raises without a card unless the CPU is
            asked for.

    The process's matmul precision flags are pinned (fp32 accumulation,
    ``device.pin_matmul_precision``).
    """

    def __init__(self, model_config: Optional[ModelConfig] = None,
                 inference_config: Optional[InferenceConfig] = None,
                 variables: Optional[Dict[str, Any]] = None, rng_seed: int = 0, *,
                 device: DeviceLike = None):
        t0 = time.perf_counter()
        self.config = inference_config or InferenceConfig()
        self.device = resolve_device(self.config.device if device is None else device)
        self.model_config = model_config or ModelConfig(device=self.device.type)
        if self.model_config.vitdet.enabled \
                and self.config.preprocessing.image_size != self.model_config.input_size:
            raise ValueError(
                f"the plain-ViT detector serves its input_size "
                f"({self.model_config.input_size}), which sizes its global relative position "
                f"tables; preprocessing.image_size is {self.config.preprocessing.image_size}")
        pin_matmul_precision()
        self.model = self.model_config.build_model(production=True, device=self.device,
                                                   seed=rng_seed).eval()
        self.image_size = self.config.preprocessing.image_size
        self.class_names = list(COCO_CLASSES[: self.model_config.detection.num_classes])
        self.metrics = InferenceMetrics(latency_target_ms=self.config.performance.latency_target_ms)
        self.kernel_sites = sum(1 for m in self.model.modules()
                                if isinstance(m, ManifoldHyperConnection) and m.fused)
        cuda = self.device.type == "cuda"
        # Every replay and copy runs on the serve stream (a thread's current
        # stream is the default one); weights for a swap are prepared on the
        # load stream. The graphs replay one at a time, so they share a pool.
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._load_stream = torch.cuda.Stream(self.device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self._mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=self.device)

        # One lock around capture, stage -> replay -> copy-out, and the
        # in-place weight copy of a swap: infer_batch, the batcher thread and
        # reload may run on different threads.
        self._serve_fns: Dict[Any, _BucketServe] = {}
        self._serve_lock = threading.RLock()
        self._batcher: Optional[_MicroBatcher] = None
        self._stability_report: Optional[Dict[str, Any]] = None
        self._service_time_s: Dict[int, float] = {}
        self._raw_shapes: set = set()
        self.spans = SpanRecorder()
        # Always-on counters (get_performance_stats): graphs captured and the
        # seconds their warm-up calls and captures took; batches served off
        # the raw-frame graphs (letterboxed eagerly); the whole construction.
        self.captures = 0
        self.capture_seconds = 0.0
        self.eager_batches = 0
        self.load_seconds = 0.0

        if variables is None and self.config.checkpoint_path:
            variables = self.load_checkpoint(self.config.checkpoint_path)
        if variables is None:
            scales = self._quant_scales({})
            with self._on(self._stream), torch.no_grad():
                load_constraints(self.model, self._constraints(param_tree(self.model)))
                if scales is not None:
                    load_quant_scales(self.model, scales)
        else:
            self.reload(variables)
        self._synchronize()
        self.load_seconds = time.perf_counter() - t0

    # ------------------------------------------------------------------
    @staticmethod
    def _on(stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _constraints(self, params) -> Dict[str, Any]:
        """The constraints tree of a parameter tree (kernel B on the card)."""
        return compute_constraints(params, self.model_config.mhc.sinkhorn_iterations)

    def _quant_scales(self, variables: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The int8 model's calibrated scales (None when quantization is off):
        those embedded in ``variables["quant"]`` (a flax ``quant`` tree or the
        port's ``{site: scale}``), else the sidecar at
        ``quantization.scales_path`` (``torch.save``, as ``python -m
        hvs_tpu_torch.quantize`` writes it), else a ValueError."""
        qcfg = self.model_config.quantization
        if not qcfg.enabled:
            return None
        if "quant" in variables:
            quant = variables["quant"]
            if any(isinstance(v, dict) for v in quant.values()):
                return load_flax_quant(self.model, quant)
            return dict(quant)
        if qcfg.scales_path:
            return torch.load(qcfg.scales_path, map_location="cpu")
        raise ValueError(
            "quantization.enabled requires calibrated scales: set "
            "quantization.scales_path (python -m hvs_tpu_torch.quantize) or pass "
            "a variables tree containing the 'quant' collection")

    def _prepare_variables(self, variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Weights as new {parameter name: fp32 tensor on the device},
        checked against the model's parameters by name and shape."""
        params = variables.get("params", variables)
        if "params" not in variables:
            params = {k: v for k, v in params.items() if k != "quant"}
        if any(isinstance(v, dict) for v in params.values()):
            flat = {name: to_port_layout(name, a) for name, a in flatten(params).items()}
        else:
            flat = params
        named = dict(self.model.named_parameters())
        missing, extra = sorted(set(named) - set(flat)), sorted(set(flat) - set(named))
        if missing or extra:
            raise KeyError(f"weights do not match the model: missing {missing[:8]}, "
                           f"unexpected {extra[:8]}")
        out = {}
        for name, p in named.items():
            value = flat[name]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value, np.float32))
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)} does not match the "
                                 f"model's {tuple(p.shape)}; a structurally different model "
                                 "needs a new engine")
            out[name] = value.to(device=self.device, dtype=p.dtype, copy=True)
        return out

    def load_checkpoint(self, path: str) -> Dict[str, Any]:
        """Weights from a checkpoint of the port's trainer
        (``ManifoldConstrainedTrainer.save_checkpoint``: ``<path>`` or
        ``<path>.pt``), its EMA weights when ``use_ema`` is set and it has
        them. A checkpoint of the JAX package (an orbax directory or a flax
        msgpack file) is first converted to this format by
        ``scripts/torch_import_checkpoint.py``."""
        return {"params": checkpoint_params(path, self.config.use_ema)}

    def reload(self, variables: Dict[str, Any]) -> None:
        """Hot model swap: new weights of the same structure (and, for an
        int8 model, their scales: ``variables["quant"]`` or the sidecar).

        The captured graphs read the parameters and the constrained matrices
        at fixed addresses, so the swap copies into them in place rather
        than rebinding (``ManifoldHyperConnection.set_constraints`` copies
        once its buffers exist). The new weights and their constraints are
        prepared on the load stream; then, under the serve lock, the copies
        are enqueued on the serve stream behind every replay already
        enqueued. Replays enqueued before see the old weights, those after
        see the new ones, and none sees a mixture. A structurally different
        model needs a new engine; changed thresholds need
        :meth:`rebuild_serve_fns`.
        """
        caller = torch.cuda.current_stream(self.device) if self._stream is not None else None
        if caller is not None:
            # The caller's tensors may still be being written on its stream;
            # and once copied, the caller may free them.
            self._load_stream.wait_stream(caller)
        scales = self._quant_scales(variables)
        with self._on(self._load_stream), torch.no_grad():
            params = self._prepare_variables(variables)
            constraints = self._constraints(nest(params))
        if caller is not None:
            caller.wait_stream(self._load_stream)
        with self._serve_lock, self._on(self._stream), torch.no_grad():
            if self._stream is not None:
                self._stream.wait_stream(self._load_stream)
            for name, p in self.model.named_parameters():
                p.copy_(params[name])
            load_constraints(self.model, constraints)
            if scales is not None:
                load_quant_scales(self.model, scales)
            if self._stream is not None:
                # The sources were allocated on the load stream: later work
                # there (which may reuse their memory) waits for the copies.
                self._load_stream.wait_stream(self._stream)
        self._stability_report = None

    def rebuild_serve_fns(self) -> None:
        """Drop every captured graph after a config change whose values are
        baked into them (thresholds, NMS settings); the next call recaptures.
        The recaptures go into a new memory pool: once the last graph of a
        pool is gone, torch does not let a capture reuse it."""
        with self._serve_lock:
            self._serve_fns = {}
            if self._pool is not None:
                self._pool = torch.cuda.graph_pool_handle()

    # ------------------------------------------------------------------
    def _make_serve(self, src_hw: Optional[Tuple[int, int]]):
        """The end-to-end serve function of the letterboxed (``src_hw``
        None) or raw-frame path. Thresholds and the NMS method are read now
        and stay fixed."""
        pre, pp = self.config.preprocessing, self.config.postprocessing
        model, mean, std, size = self.model, self._mean, self._std, self.image_size
        nms = (pp.score_threshold, pp.iou_threshold, pp.max_detections, pp.pre_nms_top_k,
               pp.nms_method)
        embeddings = pp.return_embeddings

        def serve(images_u8: torch.Tensor) -> torch.Tensor:
            if src_hw is None:
                x = images_u8.float() / 255.0
            else:
                x = letterbox_raw_batch(images_u8, size, pre.pad_color, pre.bgr_to_rgb)
            if pre.normalize:
                x = (x - mean) / std
            det, out = detect(model, x, *nms)
            emb = _roi_embeddings(out, det.boxes) if embeddings else None
            return _pack_outputs(det, emb)

        return serve

    def _entry(self, key, in_shape, src_hw) -> _BucketServe:
        entry = self._serve_fns.get(key)
        if entry is not None:
            return entry
        with self._serve_lock, self._on(self._stream):
            entry = self._serve_fns.get(key)
            if entry is None:
                entry = _BucketServe(self._make_serve(src_hw), in_shape, self.device,
                                     self.spans, self._stream, self._pool,
                                     staged=src_hw is not None,
                                     nms_method=self.config.postprocessing.nms_method)
                self.captures += entry.graph is not None
                self.capture_seconds += entry.capture_s
                self._serve_fns[key] = entry
            return entry

    def _serve_fn(self, batch: int) -> _BucketServe:
        """The letterboxed path's serve graph of one bucket (captured on first use)."""
        return self._entry(batch, (batch, self.image_size, self.image_size, 3), None)

    def _serve_fn_raw(self, batch: int, src_hw: Tuple[int, int]) -> _BucketServe:
        """The raw-frame path's serve graph of one (bucket, source shape)."""
        h, w = src_hw
        return self._entry((batch, (h, w)), (batch, h, w, 3), (h, w))

    def _bucket_for(self, n: int) -> int:
        for b in self.config.performance.batch_buckets:
            if n <= b:
                return b
        return self.config.performance.batch_buckets[-1]

    def warmup(self, src_shapes: Sequence[Tuple[int, int]] = ()) -> Dict[int, float]:
        """Capture (on the CPU: build) every bucket's letterboxed serve graph
        and, for each raw source shape (h, w) given, its raw-frame graphs;
        then measure each bucket's service time (seconds per batch:
        ``warmup_iterations`` replays with their copy-out, one wait) for the
        micro-batcher's admission queue. Returns that dict."""
        timings: Dict[int, float] = {}
        iters = max(1, self.config.performance.warmup_iterations)
        for b in self.config.performance.batch_buckets:
            entry = self._serve_fn(b)
            with self._serve_lock, self._on(self._stream):
                entry.run(self._stream)
                self._synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    entry.run(self._stream)
                self._synchronize()
                timings[b] = (time.perf_counter() - t0) / iters
        for hw in src_shapes:
            self.register_raw_shape((int(hw[0]), int(hw[1])))
        self._service_time_s = timings
        return timings

    def register_raw_shape(self, src_hw: Tuple[int, int],
                           buckets: Optional[Sequence[int]] = None) -> None:
        """Capture the raw-frame graphs of one source shape and admit it to
        the raw path (letterbox inside the graph). Camera sources have fixed
        shapes, so this runs once per stream at startup; other shapes are
        letterboxed eagerly and served by the letterboxed graphs."""
        src_hw = (int(src_hw[0]), int(src_hw[1]))
        for b in buckets or self.config.performance.batch_buckets:
            self._serve_fn_raw(b, src_hw)
        self._raw_shapes.add(src_hw)

    @property
    def replays(self) -> Dict[Any, int]:
        """Replays per captured graph (eager calls on the CPU), by key:
        bucket, or (bucket, (h, w)) for a raw-frame graph."""
        return {key: entry.replays for key, entry in self._serve_fns.items()}

    # ------------------------------------------------------------------
    def _postprocess_host(self, boxes, scores, classes, num_valid, scale, pad, orig_hw,
                          latency_s, embeddings=None) -> Detections:
        k = int(num_valid)
        b = np.asarray(boxes[:k], np.float32) * self.image_size
        px, py = pad
        b[:, [0, 2]] = (b[:, [0, 2]] - px) / scale
        b[:, [1, 3]] = (b[:, [1, 3]] - py) / scale
        h, w = orig_hw
        b[:, [0, 2]] = np.clip(b[:, [0, 2]], 0, w)
        b[:, [1, 3]] = np.clip(b[:, [1, 3]], 0, h)
        cls = np.asarray(classes[:k], np.int64)
        # Validity filter: degenerate boxes out.
        wh = np.stack([b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], 1)
        keep = (wh > self.config.postprocessing.min_box_size).all(1)
        ar = np.maximum(wh[:, 0], 1e-3) / np.maximum(wh[:, 1], 1e-3)
        keep &= (ar < self.config.postprocessing.max_aspect_ratio) & (
            ar > 1.0 / self.config.postprocessing.max_aspect_ratio)
        b, cls = b[keep], cls[keep]
        s = np.asarray(scores[:k], np.float32)[keep]
        names = [self.class_names[c] if 0 <= c < len(self.class_names) else str(c) for c in cls]
        emb = None
        if embeddings is not None:
            emb = np.asarray(embeddings[:k], np.float32)[keep]
        return Detections(boxes=b, scores=s, classes=cls, class_names=names,
                          latency_ms=latency_s * 1e3, image_size=orig_hw, embeddings=emb)

    # ------------------------------------------------------------------
    def infer(self, image: np.ndarray) -> Detections:
        """Single-image inference."""
        return self.infer_batch([image])[0]

    def infer_batch(self, images: Sequence[np.ndarray]) -> List[Detections]:
        """Batched inference with per-image results; requests larger than the
        biggest bucket are served in bucket-sized chunks."""
        max_b = self.config.performance.batch_buckets[-1]
        if len(images) > max_b:
            results: List[Detections] = []
            for i in range(0, len(images), max_b):
                results.extend(self.finalize_batch(self.dispatch_batch(images[i:i + max_b])))
            return results
        return self.finalize_batch(self.dispatch_batch(images))

    def dispatch_batch(self, images: Sequence[np.ndarray],
                       requests: Optional[Sequence[Tuple[int, int]]] = None) -> Dict[str, Any]:
        """Stage and enqueue one batch on the card without waiting for it.

        Uniform frames of a registered shape take the raw path (host frames
        staged through pinned memory, letterbox inside the graph); anything
        else is letterboxed eagerly on the card, rounded to uint8, and served
        by the bucket's letterboxed graph. ``requests`` (the micro-batcher's)
        gives each image's (submit stamp, request id): their latency then
        starts at submit. Returns a handle for :meth:`finalize_batch`.
        """
        with self.spans.span("engine.dispatch") as batch:
            t0 = now_ns()
            if batch is not None and requests:
                for submitted, rid in requests:
                    self.spans.record("request.queued", submitted, t0, rid, parent=batch)
            n = len(images)
            bucket = self._bucket_for(n)
            if n > bucket:
                raise ValueError(f"batch of {n} exceeds the largest bucket {bucket}; "
                                 "use infer_batch (it chunks) or add a bigger bucket")
            images = [np.asarray(img) for img in images]
            shapes = {im.shape for im in images}
            raw_ok = (len(shapes) == 1 and images[0].ndim == 3 and images[0].shape[2] == 3
                      and images[0].dtype == np.uint8
                      and tuple(images[0].shape[:2]) in self._raw_shapes)
            if raw_ok:
                h, w = images[0].shape[:2]
                scale, _, pad = letterbox_geometry(h, w, self.image_size)
                meta = [(scale, pad, (h, w))] * n
                entry = self._serve_fn_raw(bucket, (h, w))
            else:
                entry = self._serve_fn(bucket)
            with self._serve_lock, self._on(self._stream):
                if raw_ok:
                    entry.stage(images, self._stream)
                else:
                    self.eager_batches += 1
                    with self.spans.span("engine.letterbox_eager"):
                        meta = self._letterbox_into(entry.static_in, images)
                with self.spans.span("engine.launch"):
                    out, done = entry.run(self._stream)
        submitted = None if requests is None else [stamp for stamp, _ in requests]
        return {"t0": t0, "submitted": submitted, "batch": batch, "n": n, "meta": meta,
                "out": out, "done": done}

    def _letterbox_into(self, batch: torch.Tensor, images: Sequence[np.ndarray]):
        """Letterbox each image on the engine's device into the uint8 rows of
        ``batch`` (rows past them zeroed); returns (scale, pad, (h, w)) per
        image. The counterpart of the reference's host letterbox."""
        meta = []
        pre = self.config.preprocessing
        for i, img in enumerate(images):
            x = torch.from_numpy(np.ascontiguousarray(img))
            if self.device.type == "cuda":
                # Through pinned memory: a copy from pageable memory would wait
                # for the batches still queued on the serve stream.
                x = x.pin_memory().to(self.device, non_blocking=True)
            if pre.bgr_to_rgb and x.dim() == 3:
                x = x.flip(-1)
            boxed, scale, pad = letterbox(x, self.image_size, pre.pad_color)
            batch[i].copy_(boxed)
            meta.append((scale, pad, tuple(img.shape[:2])))
        batch[len(images):].zero_()
        return meta

    def finalize_batch(self, handle: Dict[str, Any]) -> List[Detections]:
        """Wait for a dispatched batch and split it into per-image results.
        Latency runs from each image's start (its submit, through the
        micro-batcher; else the dispatch): one metrics entry per batch of a
        direct call, one per request of the batcher."""
        with self.spans.span("engine.finalize", parent=handle["batch"]):
            with self.spans.span("engine.copyout_wait"):
                if handle["done"] is not None:
                    handle["done"].synchronize()
            with self.spans.span("engine.postprocess"):
                boxes, scores, classes, num_valid, emb = _unpack_outputs(handle["out"].numpy())
                now, n = now_ns(), handle["n"]
                if handle["submitted"] is None:
                    latency = [(now - handle["t0"]) / 1e9] * n
                    self.metrics.record(latency[0], batch_size=n)
                else:
                    latency = [(now - stamp) / 1e9 for stamp in handle["submitted"]]
                    for lat in latency:
                        self.metrics.record(lat)
                return [
                    self._postprocess_host(boxes[i], scores[i], classes[i], num_valid[i],
                                           *handle["meta"][i], latency[i],
                                           embeddings=None if emb is None else emb[i])
                    for i in range(n)
                ]

    # ------------------------------------------------------------------
    def start_batcher(self) -> None:
        """Start the continuous micro-batching thread."""
        if self._batcher is None:
            self._batcher = _MicroBatcher(self)
            self._batcher.start()

    def stop_batcher(self) -> None:
        if self._batcher is not None:
            self._batcher.stop()
            self._batcher = None

    def submit(self, image: np.ndarray) -> "Future[Detections]":
        """Queue an image for micro-batched inference; returns a Future."""
        assert self._batcher is not None, "call start_batcher() first"
        return self._batcher.submit(image)

    def accepting(self) -> bool:
        """Whether ``submit`` would be admitted right now: callers check it
        before paying per-request host work (such as a JPEG decode)."""
        if self._batcher is None:
            return False
        q = self._batcher.queue
        return q.qsize() < q.maxsize

    # ------------------------------------------------------------------
    def get_performance_stats(self) -> Dict[str, float]:
        stats = self.metrics.summary()
        if self._batcher is not None:
            stats.update({f"batcher_{k}": v for k, v in self._batcher.stats().items()})
        for b, t in self._service_time_s.items():
            stats[f"service_ms_b{b}"] = round(t * 1e3, 3)
        stats["raw_shapes_registered"] = len(self._raw_shapes)
        stats.update(captures=self.captures, capture_seconds=self.capture_seconds,
                     eager_batches=self.eager_batches, load_seconds=self.load_seconds)
        return stats

    def get_stability_report(self) -> Dict[str, Any]:
        """Constraint satisfaction of the loaded weights: every H_res_raw
        projected (Sinkhorn, 20 iterations; kernel B on the card), its worst
        doubly-stochastic error and the largest eigenvalue of its symmetric
        part."""
        if self._stability_report is None:
            worst_ds, worst_eig, n = 0.0, 0.0, 0
            with self._serve_lock, self._on(self._stream), torch.no_grad():
                for name, leaf in self.model.named_parameters():
                    if name.rsplit(".", 1)[-1] != "H_res_raw":
                        continue
                    h = sinkhorn_log(leaf.detach().float().contiguous(), 20)
                    worst_ds = max(worst_ds, float(doubly_stochastic_error(h)))
                    eig = float(torch.linalg.eigvalsh(0.5 * (h + h.T))[-1])
                    worst_eig = max(worst_eig, eig)
                    n += 1
            self._stability_report = {
                "num_mhc_layers": n,
                "max_ds_error": worst_ds,
                "max_eigenvalue": worst_eig,
                "eigenvalue_constraint_satisfied": worst_eig <= 1.0 + 1e-3,
            }
        return dict(self._stability_report)


class EngineOverloaded(RuntimeError):
    """Raised by ``submit`` when the admission-controlled queue is full and
    the overload policy is 'reject' (an API layer maps this to HTTP 429)."""


class _MicroBatcher:
    """Deadline-flush micro-batching thread with admission control.

    The queue is bounded: under overload requests are rejected or the
    oldest are shed, so accepted requests keep their latency."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        self.spans: SpanRecorder = engine.spans
        perf = engine.config.performance
        self.max_batch = max(perf.batch_buckets)
        depth = perf.max_queue_depth or self._sized_depth(perf)
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self.policy = perf.overload_policy
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.max_delay_s = perf.max_queue_delay_ms / 1e3
        # Counted from callers' threads: under a lock, so none is lost.
        self._count_lock = threading.Lock()
        self.submitted = 0
        self.rejected = 0
        self.shed = 0

    def _sized_depth(self, perf) -> int:
        """Queue depth from the latency budget: a request admitted behind D
        queued items waits ~D x per-item service time, so D ~ budget /
        per-item service time of the largest measured bucket; 2x the largest
        bucket when warmup has not run."""
        st = self.engine._service_time_s
        if not st:
            return 2 * self.max_batch
        b_star = max(st)
        per_item_s = st[b_star] / b_star
        budget_ms = perf.queue_budget_ms or perf.latency_target_ms
        return max(self.max_batch, int(budget_ms / 1e3 / max(per_item_s, 1e-6)))

    def submit(self, image: np.ndarray) -> "Future[Detections]":
        """Queue one image with its submit stamp and request id."""
        fut: "Future[Detections]" = Future()
        item = (image, fut, now_ns(), self.spans.new_id())
        with self._count_lock:
            self.submitted += 1
        while True:
            try:
                self.queue.put_nowait(item)
                return fut
            except queue.Full:
                if self.policy == "shed_oldest":
                    try:
                        old_fut = self.queue.get_nowait()[1]
                    except queue.Empty:
                        continue
                    with self._count_lock:
                        self.shed += 1
                    if not old_fut.done():
                        old_fut.set_exception(EngineOverloaded("request shed under overload"))
                else:
                    with self._count_lock:
                        self.rejected += 1
                    raise EngineOverloaded(
                        f"queue full ({self.queue.maxsize} pending); retry later")

    def stats(self) -> Dict[str, float]:
        with self._count_lock:
            counts = {"submitted": self.submitted, "rejected": self.rejected, "shed": self.shed}
        return {
            **counts,
            "queue_depth": self.queue.qsize(),
            "queue_capacity": self.queue.maxsize,
        }

    def start(self) -> None:
        def finalize(pending) -> None:
            items, handle = pending
            try:
                results = self.engine.finalize_batch(handle)
                for (_, fut, _, _), det in zip(items, results):
                    fut.set_result(det)
            except Exception as e:
                self.engine.metrics.record_error()
                for _, fut, _, _ in items:
                    if not fut.done():
                        fut.set_exception(e)

        def loop():
            # Double-buffered: batch N runs on the card while batch N+1 is
            # assembled on the host.
            pending = None
            spans = self.spans
            while not self._stop.is_set():
                try:
                    with spans.span("batcher.wait") if pending is None else NO_SPAN:
                        first = self.queue.get(timeout=0.02 if pending else 0.1)
                except queue.Empty:
                    if pending is not None:
                        finalize(pending)
                        pending = None
                    continue
                with spans.span("batcher.assemble"):
                    items = [first]
                    while len(items) < self.max_batch:
                        try:
                            items.append(self.queue.get_nowait())
                        except queue.Empty:
                            break
                    # Wait for stragglers only while a batch is in flight (that
                    # wait hides under the card's work); an idle card ships now.
                    if pending is not None:
                        deadline = time.perf_counter() + self.max_delay_s
                        while len(items) < self.max_batch:
                            remaining = deadline - time.perf_counter()
                            if remaining <= 0:
                                break
                            try:
                                items.append(self.queue.get(timeout=remaining))
                            except queue.Empty:
                                break
                try:
                    handle = self.engine.dispatch_batch(
                        [item[0] for item in items], [item[2:] for item in items])
                except Exception as e:
                    self.engine.metrics.record_error()
                    for _, fut, _, _ in items:
                        fut.set_exception(e)
                    continue
                if pending is not None:
                    finalize(pending)
                pending = (items, handle)
            if pending is not None:
                finalize(pending)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


class AsyncInferenceEngine:
    """asyncio facade over the micro-batcher."""

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        engine.start_batcher()

    async def infer(self, image: np.ndarray) -> Detections:
        import asyncio

        fut = self.engine.submit(image)
        return await asyncio.wrap_future(fut)

    async def infer_batch(self, images: Sequence[np.ndarray]) -> List[Detections]:
        import asyncio

        futs = [self.engine.submit(im) for im in images]
        return await asyncio.gather(*[asyncio.wrap_future(f) for f in futs])

    def close(self) -> None:
        self.engine.stop_batcher()
