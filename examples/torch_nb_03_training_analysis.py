# %% [markdown]
# # 03 — Training analysis (PyTorch/CUDA port)
#
# The port's counterpart of `examples/nb_03_training_analysis.py`: run a short
# manifold-constrained training, then analyze what the trainer records:
# per-step JSONL metrics, the stability monitor's report, the EMA weights and
# a checkpoint round trip, the same artifacts a real long run produces
# (`steps.jsonl`, summarized by `python -m hvs_tpu_torch.summarize_run`).
#
#     python examples/torch_nb_03_training_analysis.py [--device cpu]
#
# `HVS_NB_TINY=1` trains 8 steps instead of 60; files go to `$HVS_NB_OUT`
# (default `outputs/torch_nb03`). The last line of standard output is one
# JSON object with the tour's numbers; the kernels' launch counters go to
# standard error as one `{"kernel_launches": ...}` line.

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
OUT = os.environ.get("HVS_NB_OUT", "outputs/torch_nb03")
os.makedirs(OUT, exist_ok=True)
STEPS = 8 if TINY else 60
print("device:", DEVICE)

# %% [markdown]
# ## A tiny model + synthetic detection batches
#
# Training needs no real dataset to study *stability*: random images with
# random (valid) boxes exercise the full loss/optimizer/constraint path.

# %%
from hvs_tpu_torch.models import HybridVisionSystem
from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig

model = HybridVisionSystem(
    num_classes=8, base_channels=8, stage_channels=(16, 24, 32, 40),
    stage_blocks=(1, 1, 1, 1), vit_dim=16, vit_depth=1, vit_heads=2,
    fpn_channels=16, head_channels=16, feature_dim=32, sk_iters=5, device=DEVICE,
)
cfg = TrainerConfig(
    num_classes=8, sk_iters=5, learning_rate=1e-3,
    metrics_log=os.path.join(OUT, "steps.jsonl"),
    stability_check_every=5, ema_decay=0.99,
)
if os.path.exists(cfg.metrics_log):  # the log appends: start this run's afresh
    os.remove(cfg.metrics_log)
trainer = ManifoldConstrainedTrainer(model, cfg, device=DEVICE, seed=0)


def batches(n, batch=4, size=64, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield {
            "images": rng.standard_normal((batch, size, size, 3)).astype(np.float32),
            "boxes": np.clip(rng.uniform(0.2, 0.8, (batch, 8, 4)), 0, 1).astype(np.float32),
            "labels": rng.integers(0, 8, (batch, 8)).astype(np.int32),
            "box_mask": np.ones((batch, 8), np.float32),
        }


trainer.init_state(next(batches(1)))
print("params:", sum(p.numel() for p in trainer.params().values()))

# %% [markdown]
# ## Train and watch the curves

# %%
metrics = trainer.train_epoch(batches(STEPS), epoch=0)
trainer.close()  # flush the per-step log
print({k: round(v, 4) for k, v in metrics.items()})

# %% [markdown]
# ## Per-step metrics (what a long run writes to steps.jsonl)

# %%
with open(cfg.metrics_log) as f:
    rows = [json.loads(line) for line in f]
loss = np.asarray([r["loss"] for r in rows])
grad = np.asarray([r["grad_norm"] for r in rows])
all_finite = bool(np.isfinite(loss).all() and np.isfinite(grad).all())
print(f"steps logged: {len(rows)}")
print(f"loss:  first={loss[0]:.3f} last={loss[-1]:.3f} min={loss.min():.3f}")
print(f"grad norm: p50={np.percentile(grad, 50):.2f} max={grad.max():.2f}")
print(f"all finite: {all_finite}")

# %% [markdown]
# ## Stability monitor report
#
# The monitor consumes window *maxima* between periodic checks (a one-step
# spike cannot slip between samples) and applies LR corrections through the
# `lr_scale` multiplier.

# %%
report_path = os.path.join(OUT, "stability_report.json")
trainer.monitor.save_report(report_path)
with open(report_path) as f:
    rep = json.load(f)
print("alerts:", len(rep.get("alerts", [])))
print("corrections:", len(rep.get("corrections", [])))
print("lr_scale now:", float(trainer.state.lr_scale))

# %% [markdown]
# ## EMA weights
#
# `ema_params` update every step, persist in checkpoints, and serve eval —
# compare the EMA copy's distance from the live params.

# %%
ema_distance = None
if trainer.state.ema_params is not None:
    ema_distance = max(float((p.detach() - trainer.state.ema_params[name]).abs().max())
                       for name, p in trainer.params().items())
    print(f"max |param - ema| after {STEPS} steps: {ema_distance:.4f}")

# %% [markdown]
# ## Checkpoint round trip (params + optimizer state + step + EMA)
#
# The port's checkpoint is one `torch.save` file. One more step after the
# save moves every tensor; the load must bring back the saved ones bit for
# bit.

# %%
def snapshot():
    opt = trainer.tx.state_dict()
    tensors = {f"params/{k}": v.detach() for k, v in trainer.params().items()}
    tensors["opt/count"] = opt["count"]
    for key in ("mu", "nu", "trace"):
        tensors.update({f"opt/{key}/{k}": v for k, v in opt[key].items()})
    tensors.update({f"ema/{k}": v for k, v in (trainer.state.ema_params or {}).items()})
    return int(trainer.state.step), {k: v.detach().cpu().clone() for k, v in tensors.items()}


trainer.config.checkpoint_dir = os.path.join(OUT, "ckpt")
path = trainer.save_checkpoint("demo")
step_before, saved = snapshot()
trainer.train_step(next(batches(1, seed=1)))
_, moved = snapshot()
trainer.load_checkpoint(path)
step_after, restored = snapshot()
round_trip_bitwise = step_after == step_before and saved.keys() == restored.keys() and all(
    torch.equal(saved[k], restored[k]) for k in saved)
moved_by_step = sum(not torch.equal(saved[k], moved[k]) for k in saved)
print(f"checkpoint round trip at step {step_before}: bitwise {round_trip_bitwise} "
      f"({len(saved)} tensors, {moved_by_step} moved by the extra step)")

# %%
print(json.dumps({"kernel_launches": kernel_counts()}), file=sys.stderr, flush=True)
print(json.dumps({
    "tour": "nb_03", "device": str(DEVICE), "steps": STEPS,
    "epoch_metrics": metrics, "records": len(rows), "record_keys": sorted(rows[0]),
    "all_finite": all_finite, "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
    "alerts": len(rep.get("alerts", [])), "corrections": len(rep.get("corrections", [])),
    "lr_scale": float(trainer.state.lr_scale), "ema_distance": ema_distance,
    "checkpoint_step": step_before, "checkpoint_tensors": len(saved),
    "moved_by_step": moved_by_step, "round_trip_bitwise": round_trip_bitwise,
}), flush=True)
