"""Training stability monitoring: threshold checks, alerts, trends.

Counterpart of ``hvs_tpu/training/stability.py``. The monitor is host-side:
it consumes the scalar metrics the train step returns (gradient norm, loss,
DS error, signal ratio) plus, at low frequency, an eigenvalue check computed
from the current parameters (Sinkhorn through its Hopper kernel on the card,
then ``torch.linalg.eigvalsh``). Checks: gradient explosion / vanishing,
H_res eigenvalue excess, Sinkhorn convergence, loss NaN / 3-sigma jumps.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class StabilityThresholds:
    """Reference defaults (src/training/stability_monitor.py:96-102)."""

    grad_explosion: float = 100.0
    grad_vanishing: float = 1e-7
    max_eigenvalue: float = 1.1
    sk_error: float = 0.01
    loss_sigma_jump: float = 3.0
    signal_ratio_max: float = 10.0


class StabilityMonitor:
    """Periodic stability checks with alert history
    (reference: StabilityMonitor.check_stability, stability_monitor.py:164-397)."""

    def __init__(self, thresholds: StabilityThresholds = StabilityThresholds(),
                 history_len: int = 1000):
        self.thresholds = thresholds
        self.loss_history: deque = deque(maxlen=history_len)
        self.grad_history: deque = deque(maxlen=history_len)
        self.alerts: List[Dict[str, Any]] = []
        self.corrections: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    def check_stability(
        self, metrics: Dict[str, float], params: Any = None, check_eigs: bool = False
    ) -> Dict[str, Any]:
        """Run all checks on the latest step metrics; returns a report dict."""
        alerts: List[str] = []
        loss = metrics.get("loss")
        grad_norm = metrics.get("grad_norm")

        if grad_norm is not None:
            if grad_norm > self.thresholds.grad_explosion:
                alerts.append(f"gradient_explosion: {grad_norm:.3g}")
            elif 0 < grad_norm < self.thresholds.grad_vanishing:
                alerts.append(f"gradient_vanishing: {grad_norm:.3g}")
            self.grad_history.append(grad_norm)

        if loss is not None:
            if not np.isfinite(loss):
                alerts.append("loss_nan_or_inf")
            elif len(self.loss_history) >= 10:
                arr = np.asarray(self.loss_history, np.float64)
                mu, sigma = arr.mean(), arr.std() + 1e-9
                if loss > mu + self.thresholds.loss_sigma_jump * sigma:
                    alerts.append(f"loss_jump: {loss:.3g} vs mean {mu:.3g}")
            if np.isfinite(loss):
                self.loss_history.append(loss)

        ds_err = metrics.get("ds_error_max")
        if ds_err is not None and ds_err > self.thresholds.sk_error:
            alerts.append(f"sinkhorn_not_converged: {ds_err:.3g}")

        sig = metrics.get("signal_ratio_mean")
        if sig is not None and sig > self.thresholds.signal_ratio_max:
            alerts.append(f"signal_amplification: {sig:.3g}")

        max_eig = metrics.get("max_eigenvalue")
        if check_eigs and params is not None and max_eig is None:
            max_eig = self.max_h_res_eigenvalue(params)
        if max_eig is not None and max_eig > self.thresholds.max_eigenvalue:
            alerts.append(f"eigenvalue_excess: {max_eig:.3g}")

        is_stable = not alerts
        if alerts:
            self.alerts.append(
                {"time": time.time(), "alerts": alerts, "metrics": dict(metrics)}
            )
        return {"is_stable": is_stable, "alerts": alerts, "max_eigenvalue": max_eig}

    # ------------------------------------------------------------------
    @staticmethod
    def max_h_res_eigenvalue(params: Dict[str, Any], sk_iters: int = 20) -> float:
        """Largest eigenvalue of sym(Sinkhorn(H_res_raw)) over every mHC
        residual matrix of a named-parameter dict, computed on demand."""
        return float(make_eig_telemetry(sk_iters)(params)["max_eigenvalue"])

    # ------------------------------------------------------------------
    def record_correction(self, lr_scale: float) -> None:
        self.corrections.append({"time": time.time(), "lr_scale": lr_scale})

    def loss_trend(self, window: int = 100) -> Optional[float]:
        """Linear-regression slope of recent losses (reference :434-448)."""
        if len(self.loss_history) < 2:
            return None
        arr = np.asarray(list(self.loss_history)[-window:], np.float64)
        x = np.arange(len(arr))
        slope = np.polyfit(x, arr, 1)[0]
        return float(slope)

    def save_report(self, path: str) -> None:
        """JSON alert report (reference :392-397)."""
        report = {
            "alerts": self.alerts,
            "corrections": self.corrections,
            "loss_trend": self.loss_trend(),
            "num_steps_tracked": len(self.loss_history),
        }
        with open(path, "w") as f:
            json.dump(report, f, indent=2, default=float)

    def plot_dashboard(self, path: str) -> Optional[str]:
        """Loss/grad dashboards (reference :450-496); no-op without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].plot(list(self.loss_history))
        axes[0].set_title("loss")
        axes[1].plot(list(self.grad_history))
        axes[1].set_title("grad norm")
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return path


def make_eig_telemetry(sk_iters: int = 20):
    """The eigenvalue summary of every constrained residual matrix, for
    low-frequency polling from the host loop.

    Returns ``fn(params) -> {"max_eigenvalue", "min_eigenvalue",
    "ds_error_max_proj"}`` (0-dim tensors) for a named-parameter dict; the DS
    error is that of the same finite-iteration projection the forward uses.
    """
    import torch

    from ..ops.sinkhorn import doubly_stochastic_error, sinkhorn_log_many
    from .losses import iter_h_res_leaves

    @torch.no_grad()
    def eig_fn(params):
        maxes, mins, ds = [], [], []
        leaves = [leaf.float() for _, leaf in iter_h_res_leaves(params)]
        for h in sinkhorn_log_many(leaves, n_iters=sk_iters):
            e = torch.linalg.eigvalsh(0.5 * (h + h.T))
            maxes.append(e[-1])
            mins.append(e[0])
            ds.append(doubly_stochastic_error(h))
        return {
            "max_eigenvalue": torch.stack(maxes).max(),
            "min_eigenvalue": torch.stack(mins).min(),
            "ds_error_max_proj": torch.stack(ds).max(),
        }

    return eig_fn


class TrainingStabilityMetrics:
    """Rolling aggregate tracker (reference: stability_monitor.py:508-689)."""

    def __init__(self, window: int = 1000):
        self.window = window
        self.metrics: Dict[str, deque] = {}

    def update(self, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            if k not in self.metrics:
                self.metrics[k] = deque(maxlen=self.window)
            if np.isfinite(v):
                self.metrics[k].append(float(v))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, dq in self.metrics.items():
            if not dq:
                continue
            arr = np.asarray(dq, np.float64)
            out[k] = {
                "mean": float(arr.mean()),
                "std": float(arr.std()),
                "min": float(arr.min()),
                "max": float(arr.max()),
                "last": float(arr[-1]),
            }
        return out

    def stability_score(self) -> float:
        """Composite 0-1 score (reference: metrics.py:667-705): penalize high
        gradient variance, eigenvalue excess, DS error."""
        score = 1.0
        s = self.summary()
        if "grad_norm" in s:
            cv = s["grad_norm"]["std"] / (abs(s["grad_norm"]["mean"]) + 1e-9)
            score *= float(np.clip(1.0 - cv / 4.0, 0.0, 1.0))
        if "ds_error_max" in s:
            score *= float(np.clip(1.0 - s["ds_error_max"]["last"] / 0.05, 0.0, 1.0))
        if "loss" in s and s["loss"]["last"] > s["loss"]["mean"] + 3 * s["loss"]["std"]:
            score *= 0.5
        return score
