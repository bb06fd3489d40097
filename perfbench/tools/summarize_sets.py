"""Summary of a cell's measurement runs (``set1_*``, ``set2_*``, ``trace_*``
and ``readings.jsonl`` in one directory): each set's median and spread (the
quartile distance over the median, ``statistics.quantiles``) of every
metric, the compared numbers of every run, and the control's.

    python3 perfbench/tools/summarize_sets.py <directory>
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path


def last_line(path: Path):
    lines = [ln for ln in path.read_text().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    d = Path(sys.argv[1])
    runs = {}
    for tag in ("set1", "set2", "trace"):
        runs[tag] = [(p.stem.split("_")[1], last_line(p)) for p in sorted(d.glob(f"{tag}_*.out"))]
    for tag in ("set1", "set2"):
        lines = [ln for _, ln in runs[tag] if ln]
        for name in sorted({m for ln in lines for m in ln["metrics"]}):
            vals = [ln["metrics"][name]["value"] for ln in lines if name in ln["metrics"]]
            if len(vals) >= 2:
                print(f"{tag} {name} median {statistics.median(vals)!r} spread {spread(vals)!r} "
                      f"values {vals}")
    for tag, items in runs.items():
        for seed, ln in items:
            if ln is None:
                print(tag, seed, "no result")
                continue
            c = {k: v["value"] for k, v in ln["compared"].items()}
            extra = {k: ln["metrics"][k]["value"] for k in ln["metrics"]} if tag == "trace" else {}
            dev = ln["device"]
            print(tag, seed, "correct", ln["correct"], c, ln["judged"], "peak",
                  dev["memory_peak_bytes"], "busy", dev.get("busy_s"), "window",
                  dev.get("window_s"), "ref_setup", ln.get("reference_setup_s"), extra)
            if tag == "trace":
                print("  breakdown", json.dumps(ln.get("breakdown")))
    readings = d / "readings.jsonl"
    if readings.exists():
        for ln in readings.read_text().splitlines():
            r = json.loads(ln)
            print("readings", r["seed"], "program", r["program"], "control", r["control"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
