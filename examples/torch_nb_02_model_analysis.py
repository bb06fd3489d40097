# %% [markdown]
# # 02 — Model analysis (PyTorch/CUDA port)
#
# The port's counterpart of `examples/nb_02_model_analysis.py`: build the
# hybrid CNN+ViT detector, count parameters per subsystem, check the mHC
# manifold constraints, and count what one forward costs
# (`ModelProfiler.cost_analysis`, the port's answer to XLA's cost analysis).
# On the card the constraints' Sinkhorn projections run in kernel B.
#
#     python examples/torch_nb_02_model_analysis.py [--device cpu]
#
# `HVS_NB_TINY=1` builds tiny widths at 64²; the flagship runs at 320². The
# last line of standard output is one JSON object with the tour's numbers;
# the kernels' launch counters go to standard error as one
# `{"kernel_launches": ...}` line.

# %%
import argparse
import json
import os
import sys

# Works as a script (repo/examples/) AND inside a notebook kernel
# (cwd = repo root, no __file__).
sys.path.insert(
    0,
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if "__file__" in globals() else os.getcwd(),
)

import numpy as np
import torch

from hvs_tpu_torch import resolve_device
from hvs_tpu_torch.training.chunk import kernel_counts

_parser = argparse.ArgumentParser()
_parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
DEVICE = resolve_device(_parser.parse_known_args()[0].device)
TINY = bool(int(os.environ.get("HVS_NB_TINY", "0")))
print("device:", DEVICE)

# %% [markdown]
# ## Build the flagship model
#
# `HybridVisionSystem` = CNN backbone (NHWC, GroupNorm, bottleneck mHC) →
# ViT encoder over the coarsest scale → FPN fusion → YOLO head, with
# manifold-hyper-connected residual streams throughout.

# %%
from hvs_tpu_torch.models import HybridVisionSystem

TINY_WIDTHS = dict(
    num_classes=8, base_channels=8, stage_channels=(16, 24, 32, 40),
    stage_blocks=(1, 1, 1, 1), vit_dim=16, vit_depth=1, vit_heads=2,
    fpn_channels=16, head_channels=16, feature_dim=32, sk_iters=5,
)
widths = TINY_WIDTHS if TINY else {}
size = 64 if TINY else 320
model = HybridVisionSystem(device=DEVICE, seed=0, **widths).eval()
images = torch.zeros((1, size, size, 3), dtype=torch.float32, device=DEVICE)

# %% [markdown]
# ## Parameters per subsystem (reference budget: 10–30M total, 2–5M backbone)

# %%
totals = {}
for name, p in model.named_parameters():
    top = name.split(".")[0]
    totals[top] = totals.get(top, 0) + p.numel()
width = max(len(k) for k in totals)
for k, v in sorted(totals.items(), key=lambda kv: -kv[1]):
    print(f"{k:>{width}}: {v / 1e6:7.3f} M")
print(f"{'TOTAL':>{width}}: {sum(totals.values()) / 1e6:7.3f} M")

# %% [markdown]
# ## Forward pass + output surfaces

# %%
with torch.no_grad():
    out = model(images)
shapes = {f"raw/{scale}": list(pred.shape) for scale, pred in out["detection"]["raw"].items()}
shapes["boxes"] = list(out["detection"]["boxes"].shape)
shapes["features"] = list(out["features"].shape)
for scale, pred in out["detection"]["raw"].items():
    print(f"{scale}: {tuple(pred.shape)}  (B, H, W, anchors, 5+C)")
print("decoded boxes:", tuple(out["detection"]["boxes"].shape))
print("features:", tuple(out["features"].shape))

# %% [markdown]
# ## mHC constraint health
#
# Every mHC layer's mixing matrix must stay doubly stochastic (Birkhoff
# polytope). `collect_stability_metrics` summarises a forward of the same
# weights with the per-layer telemetry on and reports the worst DS error.

# %%
from hvs_tpu_torch.models import collect_stability_metrics

mon_model = HybridVisionSystem(device=DEVICE, seed=0, monitor=True, **widths).eval()
mon_model.load_state_dict(model.state_dict())
with torch.no_grad():
    stab = collect_stability_metrics(mon_model(images)["stability"])
print("layers monitored:", stab["num_layers"])
print("worst DS error:  ", f"{stab['ds_error_max']:.3e}")

# %% [markdown]
# ## The math core in isolation: Sinkhorn on the device
#
# Log-domain Sinkhorn with fp32 potentials (kernel B on the card).

# %%
from hvs_tpu_torch.ops import doubly_stochastic_error, sinkhorn_log

m = torch.randn((64, 64), generator=torch.Generator().manual_seed(1)).to(DEVICE)
p = sinkhorn_log(m, n_iters=20)
ds_error_64 = float(doubly_stochastic_error(p))
print("row sums ~1:", p.sum(1)[:4].cpu().numpy().round(4))
print("col sums ~1:", p.sum(0)[:4].cpu().numpy().round(4))
print("DS error:", ds_error_64)

# %% [markdown]
# ## Cost of one forward
#
# The count (`ModelProfiler.cost_analysis`) follows one convention on the CPU
# and the card: `flops` are product flops, 2 per multiply-add of every
# matmul, convolution and attention (a SAME convolution's padded taps
# included; kernels A and C by their formulas); `transcendentals` are kernel
# B's exponentials; `bytes accessed` are every operator's inputs and outputs
# as if nothing were fused, views excluded. XLA's cost analysis counts
# differently (elementwise flops, its fused program's bytes): the numbers are
# not comparable with the JAX tour's.

# %%
from hvs_tpu_torch.utils import ModelProfiler


def forward(x):
    with torch.no_grad():
        return model(x)


prof = ModelProfiler(forward, images)
cost = prof.cost_analysis()
report = prof.profile(iters=5)
print("convention: product flops (SAME taps included), B's exponentials, "
      "unfused operator bytes without views")
print(f"flops:           {int(cost['flops']):,}")
print(f"transcendentals: {int(cost['transcendentals']):,}")
print(f"bytes accessed:  {int(cost['bytes accessed']):,}")
print(f"wall time:       {report.wall_time_ms:.2f} ms")
print(f"achieved TFLOPs: {report.achieved_tflops}")
for r in report.recommendations:
    print("  -", r)

# %%
print(json.dumps({"kernel_launches": kernel_counts()}), file=sys.stderr, flush=True)
print(json.dumps({
    "tour": "nb_02", "device": str(DEVICE), "image_size": size,
    "params_by_subsystem": totals, "params_total": sum(totals.values()),
    "output_shapes": shapes, "num_layers": stab["num_layers"],
    "ds_error_max": stab["ds_error_max"], "ds_error_64": ds_error_64,
    "flops": cost["flops"], "transcendentals": cost["transcendentals"],
    "bytes_accessed": cost["bytes accessed"], "wall_ms": report.wall_time_ms,
}), flush=True)
