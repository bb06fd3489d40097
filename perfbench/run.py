"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name from ``BENCHMARK.json`` at the
root of the checkout, in files of its own:

- its configuration, ``perfbench/configs/<config>.json``, which names its
  plain reference, ``perfbench/reference/<reference>.py``;
- its traffic mix, ``perfbench/traffic/<traffic>.json``: the mix's
  parameters, the general generator that drives the window
  (``perfbench/generators/<generator>.py``: ``setup``, ``window``,
  ``close``), the check that makes the inputs and decides ``correct``
  (``perfbench/checks/<check>.py``: ``prepare``, ``judge``, ``control``),
  and the limits of the numbers that check compares;
- each metric, ``perfbench/metrics/<metric>.py``, or, where there is none,
  the file of the part of its name before the first dot (``idle_share.py``
  reads ``idle_share.serve`` and ``idle_share.fleet``).

A run: the check's inputs made from ``--seed``; the generator's set-up; the
window of ``--seconds``; the peak memory; the program freed; the check's
numbers, held against the mix's limits. With ``--trace 0`` the line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read from a profiler trace of the window and from the benchmark's own
spans. Without a CUDA card (or with fewer cards than the cell asks for) the
run exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "perfbench"
# Top-level module names that must not be loaded: the JAX stack and the JAX
# package the port was made from (compared whole: hvs_tpu_torch passes).
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "hvs_tpu")


def _process_age_s() -> float:
    """Seconds since this process started (from /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def _set_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library loads JAX by itself."""
    cache = ROOT / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def load_file(path: Path):
    """A module from a file of the benchmark, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


class Run:
    """Everything one run holds: the cell, its configuration, traffic and
    reference, the inputs the check made from the seed, the generator's
    state, and what the window produced."""

    def __init__(self, bench, cell, cfg, traffic, seed, trace, device):
        from perfbench.harness.tracing import Spans, Trace

        self.bench, self.cell, self.cfg, self.traffic = bench, cell, cfg, traffic
        self.seed, self.device = seed, device
        self.reference = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
        self.spans = Spans(active=bool(trace))
        self.trace = Trace() if trace else None
        self.result = {}
        self.served = []
        self.setup_s = None
        self.reference_s = 0.0
        self.summary = None
        self.count = {}

    @contextmanager
    def reference_time(self):
        """Set-up work of the benchmark's own reference (a count, a
        calibration of the inputs): its seconds are kept out of
        ``setup_s``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.reference_s += time.perf_counter() - t0

    def mark_window_start(self) -> float:
        """The window opens: set-up ends here (a traced run's profiler
        starts after this reading, before the window)."""
        self.setup_s = _process_age_s() - self.reference_s
        if self.trace is not None:
            self.trace.start()
        return time.perf_counter()


def metric_file(name: str) -> Path:
    """The reader of metric ``name``: its own file, else that of the part of
    its name before the first dot."""
    own = BENCH / "metrics" / f"{name}.py"
    return own if own.is_file() else BENCH / "metrics" / f"{name.split('.')[0]}.py"


def _metrics(run, entries):
    out = {}
    for m in entries:
        wl = m.get("workloads")
        if wl is not None and run.cell["name"] not in wl:
            continue
        value = load_file(metric_file(m["name"])).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def compare(numbers, traffic):
    """Each compared number beside its limit: the mix's ``limits`` are
    upper limits, its ``floors`` lower ones."""
    out = {k: {"value": numbers[k], "limit": v, "is": "at_most"}
           for k, v in traffic.get("limits", {}).items()}
    out.update({k: {"value": numbers[k], "limit": v, "is": "at_least"}
                for k, v in traffic.get("floors", {}).items()})
    return out


def passes(compared) -> bool:
    return all(c["value"] <= c["limit"] if c["is"] == "at_most" else c["value"] >= c["limit"]
               for c in compared.values())


def execute(bench, cell, seed: int, seconds: float, trace: int, device, cfg=None,
            traffic=None, control: bool = False):
    """One run of ``cell`` on ``device``; returns (result line, compared
    numbers). ``cfg`` and ``traffic`` replace the cell's own (the tests run
    cut configurations on the CPU). ``control`` also judges the control on
    the same inputs, under ``"control"`` in the line (the limits' readings;
    a benchmark run does not)."""
    import torch

    cfg = cfg or json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    traffic = traffic or json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    generator = load_file(BENCH / "generators" / f"{traffic['generator']}.py")
    check = load_file(BENCH / "checks" / f"{traffic['check']}.py")
    run = Run(bench, cell, cfg, traffic, seed, trace, device)
    check.prepare(run)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    generator.setup(run)
    # What set-up left behind is long-lived: the collector need not walk it
    # again inside the window.
    gc.collect()
    gc.freeze()
    generator.window(run, seconds)
    if run.trace is not None:
        run.trace.stop()
        run.summary = run.trace.read()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    banned = banned_modules()
    if banned:
        raise SystemExit(f"modules that must not load were loaded: {', '.join(banned)}")
    metrics = _metrics(run, bench["per_layer"] if trace else bench["end_to_end"])
    generator.close(run)
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.judge(run)
    extra = {"control": check.control(run), "program": numbers} if control else {}
    compared = compare(numbers, traffic)
    line = {
        "correct": passes(compared),
        "attempted": int(run.result["attempted"]),
        "failed": int(run.result["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if run.summary is not None:
        line["device"].update(busy_s=run.summary.busy_s, window_s=run.summary.window_s)
        line["breakdown"] = run.summary.breakdown()
    line.update(extra)
    line["window"] = {k: v for k, v in run.result.items() if isinstance(v, (int, float))}
    line["reference_setup_s"] = run.reference_s
    line["judged"] = {k: v for k, v in numbers.items() if k not in compared}
    line["compared"] = compared
    return line, compared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _set_environment()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import hvs_tpu_torch

    if Path(hvs_tpu_torch.__file__).resolve().parent.parent != ROOT:
        print(f"the program under test must come from this checkout, not "
              f"{hvs_tpu_torch.__file__}", file=sys.stderr)
        return 2
    line, compared = execute(bench, cell, args.seed, args.seconds, args.trace,
                             torch.device("cuda", 0))
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} {c['is'].replace('_', ' ')} {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
