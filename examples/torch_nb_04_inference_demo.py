# %% [markdown]
# # 04 — Inference demo (PyTorch/CUDA port)
#
# The port's counterpart of `examples/nb_04_inference_demo.py`: the serving
# `InferenceEngine` end to end (uint8 frame → letterbox → one CUDA graph per
# batch bucket: normalize + forward + decode + class-aware NMS on the card →
# boxes on the host), plus the micro-batcher that turns concurrent requests
# into bucketed device batches. On the card the serve graphs run kernel A at
# every fused mHC site, and the load projects the constraints in kernel B.
#
#     python examples/torch_nb_04_inference_demo.py [--device cpu]
#
# `HVS_NB_TINY=1` serves tiny widths at 64²; files go to `$HVS_NB_OUT`
# (default `outputs/torch_nb04`). The last line of standard output is one
# JSON object with the tour's numbers; the kernels' launch counters go to
# standard error as one `{"kernel_launches": ...}` line.

# %%
import argparse
import json
import os
import sys
import time

# Works as a script (repo/examples/) AND inside a notebook kernel
# (cwd = repo root, no __file__).
sys.path.insert(
    0,
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if "__file__" in globals() else os.getcwd(),
)

import numpy as np

from hvs_tpu_torch import resolve_device
from hvs_tpu_torch.training.chunk import kernel_counts

_parser = argparse.ArgumentParser()
_parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
DEVICE = resolve_device(_parser.parse_known_args()[0].device)
TINY = bool(int(os.environ.get("HVS_NB_TINY", "0")))
OUT = os.environ.get("HVS_NB_OUT", "outputs/torch_nb04")
os.makedirs(OUT, exist_ok=True)
print("device:", DEVICE)

# %% [markdown]
# ## Build the engine
#
# The engine captures one fixed-shape serve graph per batch bucket — no
# dynamic shapes, nothing traced at request time. A checkpoint can be
# supplied via `InferenceConfig.checkpoint_path` (EMA weights preferred when
# present).

# %%
from hvs_tpu_torch.config import InferenceConfig, ModelConfig
from hvs_tpu_torch.inference import InferenceEngine

mcfg = ModelConfig(device=DEVICE.type)
icfg = InferenceConfig(device=DEVICE.type)
icfg.postprocessing.score_threshold = 0.01  # untrained demo weights
if TINY:
    mcfg.backbone.stage_channels = (16, 24, 32, 40)
    mcfg.backbone.stage_blocks = (1, 1, 1, 1)
    mcfg.vit.dim = 16
    mcfg.vit.depth = 1
    mcfg.vit.num_heads = 2
    mcfg.fusion.fpn_channels = 16
    mcfg.detection.head_channels = 16
    mcfg.mhc.sinkhorn_iterations = 5
    icfg.preprocessing.image_size = 64
    icfg.performance.batch_buckets = (1, 2)
# Admission control: the micro-batcher rejects (EngineOverloaded) once this
# many requests are queued, so overload sheds instead of queueing into
# unbounded latency. Size it for the demo's burst below.
icfg.performance.max_queue_depth = 16

engine = InferenceEngine(mcfg, icfg)
engine.warmup()
print("warm. buckets:", icfg.performance.batch_buckets)

# %% [markdown]
# ## Single-frame inference

# %%
rng = np.random.default_rng(0)
frame = rng.integers(0, 255, (480, 640, 3), np.uint8)
det = engine.infer(frame)
print(f"{len(det)} detections, latency {det.latency_ms:.1f} ms")
if len(det):
    print("top:", det.boxes[0].round(1), f"score={det.scores[0]:.3f}",
          f"class={int(det.classes[0])}")

# %% [markdown]
# ## Visualize

# %%
import cv2

from hvs_tpu_torch.inference import DetectionVisualizer

vis = DetectionVisualizer(class_names=engine.class_names)
annotated = vis.draw_detections(frame, det.boxes, det.scores, det.classes)
path = os.path.join(OUT, "annotated.jpg")
if not cv2.imwrite(path, annotated):
    raise RuntimeError(f"could not write {path}")
print("wrote", path)

# %% [markdown]
# ## Batched inference (one graph, many frames)

# %%
frames = [rng.integers(0, 255, (480, 640, 3), np.uint8) for _ in range(4)]
t0 = time.perf_counter()
dets = engine.infer_batch(frames)
batch_ms = (time.perf_counter() - t0) * 1e3
print(f"batch of {len(frames)}: {batch_ms:.1f} ms total, "
      f"{batch_ms / len(frames):.1f} ms/frame")

# %% [markdown]
# ## Concurrent serving through the micro-batcher
#
# `submit()` returns a Future; a background thread coalesces queued requests
# into the largest fitting bucket (double-buffered: the next batch forms while
# the device runs the current one).

# %%
from hvs_tpu_torch.inference import EngineOverloaded

engine.start_batcher()
try:
    futures = [engine.submit(f) for f in frames * 2]
    results = [f.result(timeout=120) for f in futures]
    print(f"{len(results)} concurrent requests served")

    # Overload behavior: past max_queue_depth the engine REJECTS at submit
    # time (the API layer maps this to HTTP 429) — latency stays bounded under
    # overload because excess work is shed, never queued.
    rejected = 0
    burst = []
    for f in frames * 8:
        try:
            burst.append(engine.submit(f))
        except EngineOverloaded:
            rejected += 1
    served = sum(1 for b in burst if b.result(timeout=120) is not None)
finally:
    engine.stop_batcher()
print(f"burst of {len(frames) * 8}: {served} served, {rejected} rejected")

# %% [markdown]
# ## Performance counters

# %%
stats = engine.get_performance_stats()
for k, v in stats.items():
    print(f"{k}: {v:.2f}" if isinstance(v, float) else f"{k}: {v}")

# %% [markdown]
# ## Stability self-check
#
# The engine can verify its mHC constraint health on the serving weights —
# the same doubly-stochastic check training monitors (kernel B on the card).

# %%
stability = engine.get_stability_report()
print(stability)

# %%
print(json.dumps({"kernel_launches": kernel_counts()}), file=sys.stderr, flush=True)
print(json.dumps({
    "tour": "nb_04", "device": str(DEVICE), "image_size": engine.image_size,
    "single_ms": float(det.latency_ms), "detections": len(det),
    "batch": len(frames), "batch_ms": batch_ms, "concurrent_served": len(results),
    "burst": len(frames) * 8, "served": served, "rejected": rejected,
    "performance": stats, "replays": sum(engine.replays.values()),
    "kernel_sites": engine.kernel_sites, "ds_error_max": stability["max_ds_error"],
}, default=float), flush=True)
