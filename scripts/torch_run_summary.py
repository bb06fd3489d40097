#!/usr/bin/env python
"""Summary of a ``train_device`` run from its ``steps.jsonl``: the loss's
window means (``--window`` steps each, as ``STABILITY_r03.json``'s
``loss_window_means``: 2,500 steps), the first and last 1 % means, the
largest ``ds_error_max``, the grad norm's median and largest, the
stability monitor's LR cuts, the chunks' median ms per step (host clock) and their
validation losses. The step rows (the last of each step), their finiteness,
1 % means, loss minimum, grad-norm median and largest, and largest
``ds_error_max`` are ``python -m hvs_tpu_torch.summarize_run``'s.

    python scripts/torch_run_summary.py runs/trained [--window 2500]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hvs_tpu_torch.summarize_run import read_steps, summarize_steps  # noqa: E402


def _lr_cuts(run_dir: str):
    """The stability monitor's LR corrections (``stability_report.json``)."""
    path = os.path.join(run_dir, "stability_report.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return len(json.load(f)["corrections"])


def summarize(run_dir: str, window: int = 2500) -> dict:
    steps = read_steps(os.path.join(run_dir, "steps.jsonl"))
    base = summarize_steps(steps)  # python -m hvs_tpu_torch.summarize_run's numbers
    loss = np.array([s["loss"] for s in steps], np.float64)
    chunks = []
    path = os.path.join(run_dir, "chunks.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            chunks = [json.loads(line) for line in f]
    return {
        "steps": base["steps"],
        "all_finite": base["all_finite"],
        "loss_window_means": [round(float(loss[i:i + window].mean()), 3)
                              for i in range(0, len(loss), window)],
        "loss_first_1pct_mean": base["loss_first_1pct_mean"],
        "loss_last_1pct_mean": base["loss_last_1pct_mean"],
        "loss_min": base["loss_min"],
        "ds_error_max_overall": base["ds_error_max_overall"],
        "grad_norm_p50": base["grad_norm"]["p50"],
        "grad_norm_max": base["grad_norm"]["max"],
        "lr_cuts": _lr_cuts(run_dir),
        "ms_per_step_median": float(np.median([1e3 / c["steps_per_sec"] for c in chunks]))
        if chunks else None,
        "val_losses": [(c["step"], c["val_loss"]) for c in chunks if c.get("val_loss") is not None],
    }


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir")
    p.add_argument("--window", type=int, default=2500)
    a = p.parse_args()
    print(json.dumps(summarize(a.run_dir, a.window)))
