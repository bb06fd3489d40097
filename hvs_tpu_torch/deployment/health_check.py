"""Health checking: model, system and API probes with a worst-status rollup.

Counterpart of ``hvs_tpu/deployment/health_check.py`` with the same names:

  * :class:`ModelHealthChecker` — model loaded, device memory, latency and
    error rate, with the same thresholds; the device check reads
    ``torch.cuda.mem_get_info`` for the engine's card (used fraction
    ``1 - free / total``; warning above 0.85, critical above 0.95).
  * :class:`SystemHealthChecker` — CPU, memory and disk through ``psutil``,
    imported inside ``check`` (without it the check raises and the rollup
    reads critical, as the reference's would).
  * :class:`APIChecker` — live-probes the REST endpoints.
  * :class:`HealthChecker` — worst status wins, history, a monitoring
    thread, and a Prometheus gauge when ``prometheus_client`` is installed.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch


class HealthStatus(str, enum.Enum):
    HEALTHY = "healthy"
    WARNING = "warning"
    CRITICAL = "critical"
    UNKNOWN = "unknown"

    @property
    def severity(self) -> int:
        return {"healthy": 0, "unknown": 1, "warning": 2, "critical": 3}[self.value]


@dataclass
class CheckResult:
    name: str
    status: HealthStatus
    message: str = ""
    data: Dict[str, Any] = field(default_factory=dict)
    timestamp: float = field(default_factory=time.time)


def device_memory_fraction(device: torch.device) -> float:
    """Used share of the card's memory, ``1 - free / total`` from
    ``torch.cuda.mem_get_info``; 0.0 for the CPU, which reports none (as a
    JAX CPU device reports no memory stats)."""
    if device.type != "cuda":
        return 0.0
    free, total = torch.cuda.mem_get_info(device)
    return 1.0 - free / total


class ModelHealthChecker:
    def __init__(self, engine, latency_threshold_ms: float = 100.0,
                 error_rate_threshold: float = 0.1):
        self.engine = engine
        self.latency_threshold_ms = latency_threshold_ms
        self.error_rate_threshold = error_rate_threshold

    def check(self) -> List[CheckResult]:
        results = []
        loaded = self.engine is not None and self.engine.model is not None
        results.append(
            CheckResult(
                "model_loaded",
                HealthStatus.HEALTHY if loaded else HealthStatus.CRITICAL,
                "model weights present" if loaded else "no model loaded",
            )
        )
        try:
            device = self.engine.device
            used_frac = device_memory_fraction(device)
            status = HealthStatus.HEALTHY
            if used_frac > 0.95:
                status = HealthStatus.CRITICAL
            elif used_frac > 0.85:
                status = HealthStatus.WARNING
            results.append(
                CheckResult(
                    "device", status, f"{device.type} mem {used_frac:.0%}",
                    {"memory_fraction": used_frac},
                )
            )
        except Exception as e:
            results.append(CheckResult("device", HealthStatus.CRITICAL, str(e)))
        stats = self.engine.get_performance_stats() if loaded else {}
        if stats.get("count"):
            p95 = stats["p95_latency_ms"]
            status = (
                HealthStatus.HEALTHY if p95 <= self.latency_threshold_ms
                else HealthStatus.WARNING
            )
            results.append(CheckResult("latency", status, f"p95 {p95:.1f}ms", stats))
            err = stats.get("error_rate", 0.0)
            results.append(
                CheckResult(
                    "error_rate",
                    HealthStatus.HEALTHY if err <= self.error_rate_threshold
                    else HealthStatus.CRITICAL,
                    f"error rate {err:.1%}",
                )
            )
        return results


class SystemHealthChecker:
    def __init__(self, cpu_threshold: float = 95.0, mem_threshold: float = 90.0,
                 disk_threshold: float = 95.0):
        self.cpu_threshold = cpu_threshold
        self.mem_threshold = mem_threshold
        self.disk_threshold = disk_threshold

    def check(self) -> List[CheckResult]:
        import psutil

        results = []
        cpu = psutil.cpu_percent(interval=0.05)
        results.append(
            CheckResult(
                "cpu",
                HealthStatus.HEALTHY if cpu < self.cpu_threshold else HealthStatus.WARNING,
                f"cpu {cpu:.0f}%",
                {"cpu_percent": cpu},
            )
        )
        mem = psutil.virtual_memory().percent
        results.append(
            CheckResult(
                "memory",
                HealthStatus.HEALTHY if mem < self.mem_threshold else HealthStatus.WARNING,
                f"mem {mem:.0f}%",
                {"mem_percent": mem},
            )
        )
        disk = psutil.disk_usage("/").percent
        results.append(
            CheckResult(
                "disk",
                HealthStatus.HEALTHY if disk < self.disk_threshold
                else HealthStatus.CRITICAL,
                f"disk {disk:.0f}%",
                {"disk_percent": disk},
            )
        )
        return results


class APIChecker:
    """Live-probes a REST server's ``/health`` and ``/metrics``."""

    def __init__(self, base_url: str, timeout_s: float = 3.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def check(self) -> List[CheckResult]:
        import urllib.error
        import urllib.request

        results = []
        for endpoint in ("/health", "/metrics"):
            url = self.base_url + endpoint
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
                    ok = 200 <= resp.status < 300
                results.append(
                    CheckResult(
                        f"api{endpoint}",
                        HealthStatus.HEALTHY if ok else HealthStatus.WARNING,
                        f"{resp.status} in {(time.perf_counter() - t0) * 1e3:.0f}ms",
                    )
                )
            except (urllib.error.URLError, OSError) as e:
                results.append(CheckResult(f"api{endpoint}", HealthStatus.CRITICAL, str(e)))
        return results


class HealthChecker:
    """Every checker's results, rolled up (worst status wins), kept in a
    bounded history, optionally run by a monitoring thread."""

    def __init__(self, engine=None, api_url: Optional[str] = None, history_len: int = 100):
        self.checkers: List[Any] = []
        if engine is not None:
            self.checkers.append(ModelHealthChecker(engine))
        self.checkers.append(SystemHealthChecker())
        if api_url:
            self.checkers.append(APIChecker(api_url))
        self.history: List[Dict[str, Any]] = []
        self.history_len = history_len
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._init_prometheus()

    def _init_prometheus(self):
        try:
            from prometheus_client import CollectorRegistry, Gauge

            self.registry = CollectorRegistry()
            self.status_gauge = Gauge(
                "hvs_health_status", "0 healthy, 1 unknown, 2 warning, 3 critical",
                ["check"], registry=self.registry,
            )
        except Exception:
            self.registry = None

    def run_checks(self) -> Dict[str, Any]:
        all_results: List[CheckResult] = []
        for checker in self.checkers:
            try:
                all_results.extend(checker.check())
            except Exception as e:
                all_results.append(
                    CheckResult(type(checker).__name__, HealthStatus.CRITICAL, str(e))
                )
        worst = max(
            (r.status for r in all_results), key=lambda s: s.severity,
            default=HealthStatus.UNKNOWN,
        )
        if self.registry:
            for r in all_results:
                self.status_gauge.labels(r.name).set(r.status.severity)
        report = {
            "status": worst.value,
            "timestamp": time.time(),
            "checks": [
                {"name": r.name, "status": r.status.value, "message": r.message}
                for r in all_results
            ],
        }
        self.history.append(report)
        if len(self.history) > self.history_len:
            self.history.pop(0)
        return report

    def start_monitoring(self, interval_s: float = 10.0,
                         on_report: Optional[Callable] = None) -> None:
        def loop():
            while not self._stop.is_set():
                report = self.run_checks()
                if on_report:
                    on_report(report)
                self._stop.wait(interval_s)

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop_monitoring(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
            self._thread = None

    def format_report(self, report: Optional[Dict[str, Any]] = None) -> str:
        report = report or self.run_checks()
        colors = {"healthy": "\033[32m", "warning": "\033[33m",
                  "critical": "\033[31m", "unknown": "\033[36m"}
        lines = [f"overall: {colors.get(report['status'], '')}{report['status']}\033[0m"]
        for c in report["checks"]:
            color = colors.get(c["status"], "")
            lines.append(f"  {c['name']:<16} {color}{c['status']:<8}\033[0m {c['message']}")
        return "\n".join(lines)
