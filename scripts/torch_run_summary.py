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

With ``--multitask REPORT``, the report of ``python -m
hvs_tpu_torch.train_multitask`` instead: its ``before`` / ``after`` seg mIoU,
per-class IoU, pixel accuracy and depth abs-rel and its ``steps_per_sec``,
beside ``MULTITASK_r04.json``'s (the JAX package's run of the same protocol
on a TPU: a reference of accuracy, not of speed), and whether the port is
within the margins the trained check holds it to: seg mIoU within
``MIOU_MARGIN`` of the reference's, depth abs-rel at most ``ABS_REL_FACTOR``
times the reference's.

    python scripts/torch_run_summary.py --multitask runs/r4_multitask/report.json
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hvs_tpu_torch.summarize_run import read_steps, summarize_steps  # noqa: E402


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MULTITASK_REFERENCE = os.path.join(REPO, "MULTITASK_r04.json")
MULTITASK_KEYS = ("seg_miou", "seg_pixel_acc", "depth_abs_rel")
MIOU_MARGIN = 0.03
ABS_REL_FACTOR = 1.25


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


def summarize_multitask(report_path: str, reference_path: str = MULTITASK_REFERENCE) -> dict:
    """A multi-task report beside the reference's, and the trained check."""
    with open(report_path) as f:
        port = json.load(f)
    with open(reference_path) as f:
        ref = json.load(f)
    out = {"steps": [port["steps"], ref["steps"]], "image_size": [port["image_size"],
                                                                  ref["image_size"]],
           "steps_per_sec": [port["steps_per_sec"], ref["steps_per_sec"]],
           "device": port.get("device")}
    for when in ("before", "after"):
        out[when] = {k: [port[when][k], ref[when][k]] for k in MULTITASK_KEYS}
    out["after"]["seg_iou_per_class"] = [port["after"]["seg_iou_per_class"],
                                         ref["after"]["seg_iou_per_class"]]
    miou, abs_rel = port["after"]["seg_miou"], port["after"]["depth_abs_rel"]
    out["check"] = {
        "seg_miou_gap": miou - ref["after"]["seg_miou"],
        "seg_miou_within_margin": abs(miou - ref["after"]["seg_miou"]) <= MIOU_MARGIN,
        "depth_abs_rel_ratio": abs_rel / ref["after"]["depth_abs_rel"],
        "depth_abs_rel_within_factor": abs_rel <= ABS_REL_FACTOR * ref["after"]["depth_abs_rel"],
    }
    out["check"]["passed"] = (out["check"]["seg_miou_within_margin"]
                              and out["check"]["depth_abs_rel_within_factor"])
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", nargs="?")
    p.add_argument("--window", type=int, default=2500)
    p.add_argument("--multitask", metavar="REPORT",
                   help="a train_multitask report, beside MULTITASK_r04.json")
    a = p.parse_args()
    if a.multitask:
        print(json.dumps(summarize_multitask(a.multitask)))
    elif a.run_dir:
        print(json.dumps(summarize(a.run_dir, a.window)))
    else:
        p.error("give a run directory or --multitask REPORT")
