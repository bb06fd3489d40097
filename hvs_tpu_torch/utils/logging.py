"""Structured logging: coloured console, rotating files, JSONL metrics,
optional TensorBoard and wandb.

Counterpart of ``hvs_tpu/utils/logging.py``: the same sinks and files
(``<name>.log``, ``<name>.error.log``, ``<name>.metrics.jsonl`` in
``log_dir``), the same JSONL records (``step``, ``time`` and the metrics as
floats), metric history and named timers. TensorBoard and wandb are optional
and gated on import. ``setup_logger`` is the convenience factory.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, Optional


_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[35m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelname, "")
        base = super().format(record)
        return f"{color}{base}{_RESET}" if sys.stderr.isatty() else base


class StructuredLogger:
    """Multi-sink logger with metric history and named timers."""

    def __init__(
        self,
        name: str = "hvs_tpu_torch",
        log_dir: Optional[str] = None,
        level: int = logging.INFO,
        use_tensorboard: bool = False,
        use_wandb: bool = False,
        wandb_project: Optional[str] = None,
    ):
        self.logger = logging.getLogger(name)
        self.logger.setLevel(level)
        self.logger.handlers.clear()
        self.logger.propagate = False  # avoid duplicate lines via the root logger
        self.log_dir = log_dir
        self.metric_history: Dict[str, list] = defaultdict(list)
        self._timers: Dict[str, float] = {}
        self._jsonl_path = None
        self._tb = None
        self._wandb = None

        console = logging.StreamHandler()
        console.setFormatter(
            _ColorFormatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        self.logger.addHandler(console)

        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            file_h = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, f"{name}.log"), maxBytes=10 * 2**20, backupCount=3
            )
            file_h.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
            )
            self.logger.addHandler(file_h)
            err_h = logging.handlers.RotatingFileHandler(
                os.path.join(log_dir, f"{name}.error.log"), maxBytes=5 * 2**20,
                backupCount=2,
            )
            err_h.setLevel(logging.ERROR)
            err_h.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
            )
            self.logger.addHandler(err_h)
            self._jsonl_path = os.path.join(log_dir, f"{name}.metrics.jsonl")

        if use_tensorboard and log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
            except Exception:
                self._tb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project or name)
            except Exception:
                self._wandb = None

    # ---------------- plain logging ----------------
    def debug(self, msg, *a):
        self.logger.debug(msg, *a)

    def info(self, msg, *a):
        self.logger.info(msg, *a)

    def warning(self, msg, *a):
        self.logger.warning(msg, *a)

    def error(self, msg, *a):
        self.logger.error(msg, *a)

    # ---------------- metrics ----------------
    def log_metrics(self, metrics: Dict[str, Any], step: int, prefix: str = "") -> None:
        clean = {}
        for k, v in metrics.items():
            try:
                clean[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        for k, v in clean.items():
            self.metric_history[k].append((step, v))
            if self._tb is not None:
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(clean, step=step)
        if self._jsonl_path:
            with open(self._jsonl_path, "a") as f:
                f.write(json.dumps({"step": step, "time": time.time(), **clean}) + "\n")

    def log_gradient_norm(self, norm: float, step: int) -> None:
        self.log_metrics({"grad_norm": norm}, step)

    def log_learning_rate(self, lr: float, step: int) -> None:
        self.log_metrics({"learning_rate": lr}, step)

    # ---------------- timers ----------------
    def start_timer(self, name: str) -> None:
        self._timers[name] = time.perf_counter()

    def stop_timer(self, name: str, step: Optional[int] = None) -> float:
        elapsed = time.perf_counter() - self._timers.pop(name)
        if step is not None:
            self.log_metrics({f"time/{name}": elapsed}, step)
        return elapsed

    @contextmanager
    def timer(self, name: str, step: Optional[int] = None):
        self.start_timer(name)
        try:
            yield
        finally:
            self.stop_timer(name, step)

    def get_metric_history(self, key: str):
        return list(self.metric_history.get(key, []))

    def close(self) -> None:
        """Close the sinks: TensorBoard, wandb and the log files."""
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        for handler in list(self.logger.handlers):
            handler.close()
            self.logger.removeHandler(handler)


def setup_logger(
    name: str = "hvs_tpu_torch", log_dir: Optional[str] = None, level: int = logging.INFO
) -> StructuredLogger:
    """A :class:`StructuredLogger` with the default sinks."""
    return StructuredLogger(name=name, log_dir=log_dir, level=level)
