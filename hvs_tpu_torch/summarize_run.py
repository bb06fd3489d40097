"""Summary of a training run's step log: the stability artifact.

Counterpart of ``scripts/summarize_run.py``, with its flags, logic and keys:
from the trainer's per-step JSONL (``TrainerConfig.metrics_log``: ``step``,
``time``, ``loss``, ``grad_norm``, ``lr_scale`` and ``ds_error_max``, as
``ManifoldConstrainedTrainer`` and ``train_device``'s ``steps.jsonl``
write them) the step count, finiteness, the loss's trend (20 window means,
the first and last 1 %), the gradient norm's p50, p95 and largest, the
largest ``ds_error_max``, the LR scale, steps/s and whether the run
diverged. A resumed run logs some steps twice: the last row of each step
counts. A chunked run logs a chunk's rows with one timestamp, and then the
rate is taken over the whole span. ``--chunks`` (``train_device``'s
``chunks.jsonl``) adds the eigenvalue telemetry (``eig_max_eigenvalue``,
``eig_ds_error_max_proj``); ``--report`` (``stability_report.json``) the
monitor's alerts and corrections. Reads files only; no device::

    python -m hvs_tpu_torch.summarize_run --steps runs/device_run/steps.jsonl \\
        --chunks runs/device_run/chunks.jsonl \\
        --report runs/device_run/stability_report.json --output STABILITY.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Summarize a training run's step log")
    p.add_argument("--steps", default="logs/shapes/steps.jsonl")
    p.add_argument("--report", default=None, help="StabilityMonitor JSON report")
    p.add_argument("--chunks", default=None,
                   help="train_device chunks.jsonl (eigenvalue telemetry)")
    p.add_argument("--output", default="STABILITY.json")
    return p.parse_args(argv)


def read_steps(path: str) -> List[Dict[str, Any]]:
    """The step log's rows, the last row of each step, in step order."""
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    by_step = {}
    for r in rows:
        by_step[r["step"]] = r
    return [by_step[s] for s in sorted(by_step)]


def summarize_steps(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The summary of step rows (as ``read_steps`` returns them)."""
    loss = np.asarray([r["loss"] for r in rows], np.float64)
    grad = np.asarray([r["grad_norm"] for r in rows], np.float64)
    lr = np.asarray([r.get("lr_scale", 1.0) for r in rows], np.float64)
    t = np.asarray([r["time"] for r in rows], np.float64)
    ds = np.asarray([r["ds_error_max"] for r in rows if "ds_error_max" in r], np.float64)

    n = len(rows)
    k = max(n // 20, 1)
    window_means = [float(loss[i:i + k].mean()) for i in range(0, n - k + 1, k)]
    gaps = np.diff(t)
    stepping = gaps[gaps < 5.0]  # validation and checkpoint pauses out
    # A chunked run logs a chunk's rows with one timestamp: per-row gaps
    # then mean nothing, and the rate is taken over the span.
    chunked = stepping.size and np.median(stepping) < 1e-4
    span = max(t[-1] - t[0], 1e-9)
    rate = (n - 1) / span if chunked else float(1.0 / np.median(stepping))
    one_pct = max(n // 100, 1)
    return {
        "steps": n,
        "all_finite": bool(np.isfinite(loss).all() and np.isfinite(grad).all()),
        "loss_first_1pct_mean": float(loss[:one_pct].mean()),
        "loss_last_1pct_mean": float(loss[-one_pct:].mean()),
        "loss_min": float(loss.min()),
        "loss_window_means": [round(v, 3) for v in window_means],
        "grad_norm": {
            "p50": float(np.percentile(grad, 50)),
            "p95": float(np.percentile(grad, 95)),
            "max": float(grad.max()),
        },
        "ds_error_max_overall": float(ds.max()) if ds.size else None,
        "lr_scale_final": float(lr[-1]),
        "lr_scale_min": float(lr.min()),
        "steps_per_sec_median": float(rate),
        "wall_hours": float((t[-1] - t[0]) / 3600),
        "diverged": bool(not np.isfinite(loss).all()
                         or loss[-one_pct:].mean() > loss[:one_pct].mean()),
    }


def eigenvalue_telemetry(chunks_path: str) -> Dict[str, Any]:
    """The eigenvalue spectra's summary from a ``chunks.jsonl`` (every
    Sinkhorn-projected H_res: the largest eigenvalue stays <= 1)."""
    with open(chunks_path) as f:
        crows = [json.loads(line) for line in f]
    eig = [r["eig_max_eigenvalue"] for r in crows if r.get("eig_max_eigenvalue") is not None]
    dsp = [r.get("eig_ds_error_max_proj") for r in crows
           if r.get("eig_ds_error_max_proj") is not None]
    out: Dict[str, Any] = {}
    if eig:
        stride = max(len(eig) // 50, 1)
        out["eigenvalue_telemetry"] = {
            "samples": len(eig),
            "max_eigenvalue_overall": float(np.max(eig)),
            "max_eigenvalue_final": float(eig[-1]),
            "constraint_satisfied": bool(np.max(eig) <= 1.0 + 1e-3),
            "series_sampled": [round(float(v), 6) for v in eig[::stride]],
        }
    if dsp:
        out["ds_error_proj_max_overall"] = float(np.max(dsp))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    out = summarize_steps(read_steps(args.steps))
    if args.chunks and os.path.exists(args.chunks):
        out.update(eigenvalue_telemetry(args.chunks))
    if args.report and os.path.exists(args.report):
        with open(args.report) as f:
            rep = json.load(f)
        out["monitor"] = {
            "num_alerts": len(rep.get("alerts", [])),
            "num_corrections": len(rep.get("corrections", [])),
            "loss_trend_slope": rep.get("loss_trend"),
        }
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
