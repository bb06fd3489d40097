"""The harness: cells, configurations, mixes and metrics found by name from
files of their own; the names and units the contract allows; no result
without a card; a whole run on the CPU at a cut size, judged correct, and
judged not correct with the served path broken underneath it."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from conftest import ROOT, load_traffic, tiny_config

sys.path.insert(0, str(ROOT / "perfbench"))
import run as bench_run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CPU = torch.device("cpu")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names[:len(b["configs"]) + len(b["workloads"])])) == \
        len(b["configs"]) + len(b["workloads"])
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])


def test_every_named_file_exists():
    b = bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench" / "generators" / f"{traffic['generator']}.py").is_file()
        assert (ROOT / "perfbench" / "checks" / f"{traffic['check']}.py").is_file()
        assert (ROOT / "perfbench" / "configs" / f"{w['config']}.json").is_file()
    for c in b["configs"]:
        name = json.loads((ROOT / c["file"]).read_text())["reference"]
        assert (ROOT / "perfbench" / "reference" / f"{name}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert bench_run.metric_file(m["name"]).is_file(), m["name"]


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    b = bench()

    def reports(cell):
        return {m["name"] for m in b["end_to_end"] if cell in m.get("workloads", [cell])}

    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= cells, m["name"]
        assert all(m["moves"] in reports(c) for c in m["workloads"]), m["name"]
    for c in cells:
        assert "setup_s" in reports(c) and len(reports(c)) >= 2, c
        assert any(c in m["workloads"] for m in b["per_layer"]), c


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    """A copy of the checkout with a config, a mix, a metric and a cell added
    as new files only (and the cell and metric named in BENCHMARK.json): the
    harness loads each by its name."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    cfg = json.loads((copy / "perfbench/configs/hvs_lightweight.json").read_text())
    cfg["name"] = "hvs_lightweight_new"
    (copy / "perfbench/configs/hvs_lightweight_new.json").write_text(json.dumps(cfg))
    mix = json.loads((copy / "perfbench/traffic/serve_b16_480p.json").read_text())
    mix["batch"] = 8
    (copy / "perfbench/traffic/serve_b8_480p.json").write_text(json.dumps(mix))
    (copy / "perfbench/metrics/frames_per_replay.new.py").write_text(
        "def read(run):\n    return 42.0\n")
    b["workloads"].append({"name": "new_cell", "config": "hvs_lightweight_new",
                           "traffic": "serve_b8_480p", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "frames_per_replay.new", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "engine", "moves": "serve_fps",
                           "workloads": ["new_cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(copy)!r}, {str(copy / "perfbench")!r}]
        import run
        b = json.load(open(run.ROOT / "BENCHMARK.json"))
        cell = [w for w in b["workloads"] if w["name"] == "new_cell"][0]
        cfg = json.load(open(run.BENCH / "configs" / (cell["config"] + ".json")))
        mix = json.load(open(run.BENCH / "traffic" / (cell["traffic"] + ".json")))
        gen = run.load_file(run.BENCH / "generators" / (mix["generator"] + ".py"))

        class R:
            pass

        r = R()
        r.cell = cell
        new = [m for m in b["per_layer"] if m["name"].endswith(".new")]
        print(cfg["name"], mix["batch"], gen.__name__, run._metrics(r, new),
              run.metric_file("idle_share.new").name)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=copy)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:3] == ["hvs_lightweight_new", "8", "perfbench_closed_batches"]
    assert "42.0" in out.stdout
    assert out.stdout.split()[-1] == "idle_share.py"


TOY = {
    "configs/toy_matmul.json": json.dumps({"name": "toy_matmul", "reference": "toy", "n": 32}),
    "traffic/toy_steps.json": json.dumps({
        "generator": "toy_loop", "check": "toy", "steps_per_call": 4,
        "limits": {"state_gap": 1e-4}, "floors": {"steps": 4}}),
    "reference/toy.py": """
import torch


def step(state, w):
    return torch.tanh(state @ w)
""",
    "generators/toy_loop.py": """
import time

import torch


def setup(run):
    run.state = run.state0.clone()


def window(run, seconds):
    steps = 0
    t0 = run.mark_window_start()
    while time.perf_counter() - t0 < seconds or steps == 0:
        for _ in range(run.traffic["steps_per_call"]):
            run.state = torch.tanh(run.state @ run.w)
            steps += 1
    run.result.update(window_s=time.perf_counter() - t0, steps=steps, attempted=steps, failed=0)


def close(run):
    pass
""",
    "checks/toy.py": """
import torch


def prepare(run):
    g = torch.Generator(device=run.device).manual_seed(run.seed)
    n = run.cfg["n"]
    run.w = torch.randn(n, n, generator=g, device=run.device) / n ** 0.5
    run.state0 = torch.randn(4, n, generator=g, device=run.device)


def _follow(run, dtype):
    state = run.state0.to(dtype)
    for _ in range(run.result["steps"]):
        state = run.reference.step(state, run.w.to(dtype))
    return state.float()


def judge(run):
    gap = (run.state - _follow(run, torch.float64).float()).abs().max()
    return {"state_gap": float(gap), "steps": run.result["steps"]}


def control(run):
    gap = (_follow(run, torch.bfloat16) - _follow(run, torch.float64).float()).abs().max()
    return {"state_gap": float(gap), "steps": run.result["steps"]}
""",
    "metrics/steps_per_s.py": """
def read(run):
    return run.result["steps"] / run.result["window_s"]
""",
}


def test_a_new_kind_of_cell_runs_from_new_files_only(tmp_path):
    """A cell of another kind than the serve cells (its own configuration,
    reference, generator, check, traffic and metric) added to a copy of the
    checkout as new files only, named in BENCHMARK.json: a run of it on the
    CPU loads each by name, judges it by its own reference and reports its
    own metric beside ``setup_s``."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (copy / "perfbench").rglob("*") if p.is_file()}
    for rel, text in TOY.items():
        path = copy / "perfbench" / rel
        assert not path.exists(), rel
        path.write_text(textwrap.dedent(text))
    b = bench()
    b["configs"].append({"name": "toy_matmul", "source": "a test", "reduced": [],
                         "file": "perfbench/configs/toy_matmul.json", "why": "test"})
    b["workloads"].append({"name": "toy_cell", "config": "toy_matmul", "traffic": "toy_steps",
                           "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["toy_cell"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(copy)!r}, {str(copy / "perfbench")!r}]
        import torch
        import run
        b = json.load(open(run.ROOT / "BENCHMARK.json"))
        cell = [w for w in b["workloads"] if w["name"] == "toy_cell"][0]
        line, compared = run.execute(b, cell, 3000000021, 0.2, 0, torch.device("cpu"),
                                     control=True)
        print(json.dumps(line))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=copy)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert set(line["metrics"]) == {"steps_per_s", "setup_s"}
    assert set(line["compared"]) == {"state_gap", "steps"}
    assert line["control"]["state_gap"] > 1e-4
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_without_a_card_the_run_fails_and_prints_nothing():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          "flagship_serve_720p_b16", "--seed", "3000000017", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, env=env,
                         cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(tmp_path / "perfbench" / "run.py"), "--workload",
                          "flagship_serve_720p_b16", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _tiny_run(generator, monkeypatch=None, fault=None):
    cfg = tiny_config()
    # Dense enough that a served frame holds confident detections (252
    # anchors at 64²), so an altered answer reads as one.
    cfg["candidates_per_frame"] = 120
    checked = {"check": "detections", "limits": load_traffic("serve_b16_720p")["limits"],
               "floors": {"frames": 1, "detections": 1}}
    if generator == "closed_batches":
        mix = {"generator": generator, "frame_h": 48, "frame_w": 80, "image_size": 64,
               "batch": 2, "pool": 4, "sample": 1000}
    else:
        mix = {"generator": generator, "frame_h": 48, "frame_w": 80, "image_size": 64,
               "buckets": [1, 2], "phases": [0.1, 0.6], "fps": 8, "jitter_ms": 2.0, "pool": 4,
               "sample": 1000}
    mix.update(checked)
    if fault is not None:
        fault(monkeypatch)
    cell = {"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1}
    line, compared = bench_run.execute(bench(), cell, 3000000019, 0.6, 0, CPU, cfg=cfg,
                                       traffic=mix)
    return line


@pytest.mark.parametrize("generator", ["closed_batches", "open_cameras"])
def test_a_cut_run_on_the_cpu_is_correct(generator):
    line = _tiny_run(generator)
    assert line["correct"], line
    assert line["attempted"] > 0 and line["compared"]["detections"]["value"] > 0
    assert set(line["metrics"]) >= {"setup_s"}
    assert list(line)[-1] == "compared"


def _half_batch_left_out(monkeypatch):
    from hvs_tpu_torch.inference import engine as eng

    real = eng.InferenceEngine.finalize_batch

    def finalize(self, handle):
        dets = real(self, handle)
        for d in dets[len(dets) // 2:]:
            d.boxes, d.scores, d.classes = d.boxes[:0], d.scores[:0], d.classes[:0]
        return dets

    monkeypatch.setattr(eng.InferenceEngine, "finalize_batch", finalize)


def _answer_altered(monkeypatch):
    from hvs_tpu_torch.inference import engine as eng

    real = eng._pack_outputs

    def pack(det, emb=None):
        out = real(det, emb)
        out[..., 5] = torch.where(out[..., 5] >= 0, (out[..., 5] + 1) % 6, out[..., 5])
        return out

    monkeypatch.setattr(eng, "_pack_outputs", pack)


def _boxes_moved(monkeypatch):
    from hvs_tpu_torch.inference import engine as eng

    real = eng._pack_outputs

    def pack(det, emb=None):
        out = real(det, emb)
        side = torch.maximum(out[..., 2] - out[..., 0], out[..., 3] - out[..., 1]).clamp(min=0)
        out[..., 0] += 0.5 * side
        out[..., 2] += 0.5 * side
        return out

    monkeypatch.setattr(eng, "_pack_outputs", pack)


@pytest.mark.parametrize("fault", [_half_batch_left_out, _answer_altered, _boxes_moved])
@pytest.mark.parametrize("generator", ["closed_batches", "open_cameras"])
def test_a_broken_served_path_is_not_correct(generator, fault, monkeypatch):
    line = _tiny_run(generator, monkeypatch, fault)
    assert not line["correct"], line["compared"]


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct(card):
    """On a card: one cell for a second, its result line whole."""
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          "lightweight_serve_480p_b16", "--seed", "2147483659", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"serve_fps", "setup_s"} <= set(line["metrics"])
