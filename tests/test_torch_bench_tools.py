"""The port's measurement entry points on the CPU against the JAX package's
scripts: ``python -m hvs_tpu_torch.bench`` against ``bench.py``,
``benchmark`` against ``scripts/benchmark.py``, ``serve_bench`` against
``scripts/serve_bench.py``, ``summarize_run`` against
``scripts/summarize_run.py`` and ``serve_policy_sim`` against
``scripts/serve_policy_sim.py``.

The JAX scripts run in-process with ``sys.argv`` patched and their model
patched to the tiny one (``bench.py``'s image size and seeded inputs too);
the port's modules run the same way, on the CPU. Serve programs are held
on the same converted weights (an orbax checkpoint of conditioned tiny
weights for ``bench.py``, ``scripts/torch_import_checkpoint.py``'s .pt
file for the port), both models in fp32: boxes and scores within
rtol 2e-3 / atol 5e-3, classes exact. Reports are held key for key.
"""

import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from hvs_tpu.models import ProductionHybridVision as JaxProduction
from hvs_tpu_torch import bench, benchmark, serve_bench, serve_policy_sim, summarize_run
from hvs_tpu_torch.models import ProductionHybridVision as PortProduction
from tests.test_torch_infer import _conditioned_init, _tiny_jax_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-3, 5e-3
TINY = dict(stage_channels=(16, 24, 32, 40), stage_blocks=(1, 1, 1, 1), vit_dim=16,
            vit_depth=1, vit_heads=2, fpn_channels=16, head_channels=16)
BATCH = 2
SIZE = 64


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


def _keys(tree):
    """The nested key structure of a JSON object (lists by their items')."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Conditioned tiny weights as an orbax checkpoint (the JAX trainer's
    layout) and as the port's .pt file, converted by the import tool."""
    tmp = tmp_path_factory.mktemp("bench_ckpt")
    params = _conditioned_init(_tiny_jax_config(), seed=3)
    orbax_dir = str(tmp / "orbax")
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(orbax_dir, {"params": params})
    port = str(tmp / "tiny.pt")
    _load("scripts/torch_import_checkpoint.py", "_import_tool").main(
        [orbax_dir, port, "--tiny"])
    return orbax_dir, port


def _keep_compile_cache(monkeypatch):
    """``bench.py``'s compile-cache settings ignored: the tests' stay."""
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda name, value: None if name in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
        else update(name, value))


def _jax_bench_patches(monkeypatch, images, record):
    """``bench.py`` at the tiny width in fp32, at SIZE², on ``images``; the
    arrays it waits on recorded."""
    monkeypatch.setattr("hvs_tpu.models.ProductionHybridVision",
                        functools.partial(JaxProduction, **TINY, dtype=jnp.float32))
    _keep_compile_cache(monkeypatch)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(images[:shape[0]]))
    zeros = jnp.zeros
    monkeypatch.setattr(jnp, "zeros", lambda shape, dtype=None: zeros(
        (1, SIZE, SIZE, 3) if tuple(shape) == (1, 640, 640, 3) else shape, dtype))
    ready = jax.block_until_ready

    def block(x):
        record.append(jax.tree_util.tree_map(np.asarray, ready(x)))
        return x

    monkeypatch.setattr(jax, "block_until_ready", block)


def test_bench_serve_program_and_line_match_bench_py(checkpoints, monkeypatch, capsys):
    """``bench``'s serve program against the one ``bench.py`` builds, on the
    same converted weights and inputs (``HVS_BENCH_CHECKPOINT``, batch 2 by
    ``HVS_BENCH_BATCH``): boxes and scores within the tolerance, classes
    and counts exact; the printed lines have the same keys; an orbax
    directory is refused by the port, naming the import tool."""
    orbax_dir, port_ckpt = checkpoints
    images = np.random.default_rng(0).uniform(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    record = []
    _jax_bench_patches(monkeypatch, images, record)
    monkeypatch.setenv("HVS_BENCH_BATCH", str(BATCH))
    monkeypatch.setenv("HVS_BENCH_CHECKPOINT", orbax_dir)
    _load("bench.py", "_jax_bench").main()
    want_line = _last_json(capsys.readouterr().out)
    want = record[0]  # the warm call on the batch

    monkeypatch.setattr(bench, "ProductionHybridVision",
                        functools.partial(PortProduction, **TINY, dtype=torch.float32))
    monkeypatch.setattr(bench, "IMAGE", SIZE)
    monkeypatch.setattr(bench, "ITERS", 2)
    monkeypatch.setattr(bench, "ITERS_B1", 2)
    det = bench.build_detector(0, port_ckpt, "cpu")
    got = [t.numpy() for t in bench.serve_fn(det)(torch.from_numpy(images))]
    valid = want[1] >= 0
    assert valid.sum() >= 4
    np.testing.assert_array_equal(got[1] >= 0, valid)
    np.testing.assert_array_equal(got[2][valid], want[2][valid])
    np.testing.assert_allclose(got[0][valid], want[0][valid], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1][valid], want[1][valid], rtol=RTOL, atol=ATOL)

    monkeypatch.setenv("HVS_BENCH_CHECKPOINT", port_ckpt)
    line = bench.main(["--device", "cpu"])
    assert _last_json(capsys.readouterr().out) == line
    assert set(line) == set(want_line) == {"metric", "value", "unit", "vs_baseline",
                                           "batch1_frame_ms", "checkpoint", "batch"}
    assert line["metric"] == want_line["metric"] and line["unit"] == want_line["unit"]
    assert line["value"] > 0 and line["batch"] == want_line["batch"] == BATCH
    monkeypatch.setenv("HVS_BENCH_CHECKPOINT", orbax_dir)
    with pytest.raises(ValueError, match="torch_import_checkpoint.py"):
        bench.main(["--device", "cpu"])


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_bench_quant_modes_build_bench_py_models(mode, monkeypatch, capsys):
    """``HVS_BENCH_QUANT`` maps to the model flags ``bench.py`` passes
    (its model constructor recorded, the run stopped there); the port's int8
    model serves with identity scales."""
    class Built(Exception):
        pass

    def record(**kw):
        raise Built(kw)

    monkeypatch.setenv("HVS_BENCH_QUANT", str(mode))
    _keep_compile_cache(monkeypatch)
    monkeypatch.setattr("hvs_tpu.models.ProductionHybridVision", record)
    with pytest.raises(Built) as built:
        _load("bench.py", "_jax_bench").main()
    kw = built.value.args[0]
    assert kw.pop("use_pallas") == (mode == 0) and kw.pop("sk_iters") == bench.SK_ITERS
    assert kw == bench.quant_flags(mode)
    monkeypatch.setattr(bench, "ProductionHybridVision",
                        functools.partial(PortProduction, **TINY))
    det = bench.build_detector(mode, "", "cpu")
    boxes, scores, classes = bench.serve_fn(det)(torch.rand(1, SIZE, SIZE, 3))
    assert boxes.shape == (1, bench.MAX_DETECTIONS, 4) and torch.isfinite(scores).all()


def test_bench_without_cuda_prints_the_unavailable_line(monkeypatch, capsys):
    """No card and no ``--device cpu``: the line with value 0 and
    ``cuda_unavailable``, exit 1 (``bench.py``'s ``tpu_unavailable`` line)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit) as ex:
            bench.main(argv)
        assert ex.value.code == 1
        line = _last_json(capsys.readouterr().out)
        assert set(line) == {"metric", "value", "unit", "vs_baseline", "error", "detail"}
        assert (line["value"], line["error"]) == (0, "cuda_unavailable")


def test_benchmark_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """``benchmark --tiny`` against ``scripts/benchmark.py --tiny``: the same
    files, result keys, CSV and Markdown headers and last-line keys."""
    args = ["--tiny", "--batches", "2", "--iters", "2", "--sustained-s", "0.3"]
    monkeypatch.setattr("hvs_tpu.utils.enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["benchmark.py", *args, "--output", str(tmp_path / "jax")])
    _load("scripts/benchmark.py", "_jax_benchmark").main()
    want_line = _last_json(capsys.readouterr().out)
    line = benchmark.main([*args, "--device", "cpu", "--output", str(tmp_path / "port")])
    launches = _last_json(capsys.readouterr().err)
    assert set(launches) == {"kernel_launches", "replays", "graphs", "kernel_sites"}
    assert launches["graphs"] == 1 and launches["replays"] >= 2
    assert set(line) == set(want_line) == {"best_throughput_fps", "e2e_p50_ms", "output_dir"}
    assert line["best_throughput_fps"] > 0
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    results = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "benchmark.json") as f:
            results[side] = json.load(f)
    want, got = results["jax"], results["port"]
    assert set(got) == set(want) == {"throughput", "end_to_end", "sustained"}
    assert _keys(got["throughput"]) == _keys(want["throughput"])
    assert _keys(got["end_to_end"]) == _keys(want["end_to_end"])
    assert {"duration_s", "frames", "fps"} <= set(got["sustained"]) & set(want["sustained"])
    host = {k for k in want["sustained"] if not k.startswith("device_mem")}
    assert host <= set(got["sustained"])
    for name, head in (("benchmark.md", 4), ("throughput.csv", 1)):
        lines = {}
        for side in ("jax", "port"):
            with open(tmp_path / side / name) as f:
                lines[side] = f.read().splitlines()
        assert lines["port"][:head] == lines["jax"][:head]
        assert len(lines["port"]) == len(lines["jax"])
    assert [r.split(",")[0] for r in lines["port"]] == [r.split(",")[0] for r in lines["jax"]]


def test_serve_bench_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """``serve_bench --tiny`` in each mode against ``scripts/serve_bench.py
    --tiny`` (closed and overload; a queue of 8 under overload, deeper than
    the warm-up's burst of 4, which the JAX script's warm-up cannot take
    shed): the report's keys (``engine_stats``
    aside, whose keys are each engine's), frames served without an error,
    shedding under overload on both, every request the port accepted
    completed; ``scripts/serve_median_report.py``, unchanged, reads the
    port's reports."""
    monkeypatch.setattr("hvs_tpu.utils.enable_compile_cache", lambda *a, **k: None)
    script = _load("scripts/serve_bench.py", "_jax_serve_bench")
    modes = {"closed": [], "rated": ["--rate", "20"],
             "overload": ["--rate", "2000", "--policy", "shed_oldest", "--queue-depth", "8"]}
    want = {}
    for mode in ("closed", "overload"):
        monkeypatch.setattr(sys, "argv", [
            "serve_bench.py", "--tiny", "--seconds", "0.5", "--bucket", "1", "--frames", "4",
            "--mode", mode, *modes[mode], "--output", str(tmp_path / f"jax_{mode}.json")])
        script.main()
        with open(tmp_path / f"jax_{mode}.json") as f:
            want[mode] = json.load(f)
        assert want[mode]["frames"] > 0
    assert want["overload"]["shed_or_rejected"] > 0
    for mode, extra in modes.items():
        out = str(tmp_path / f"port_{mode}.json")
        report = serve_bench.main(["--tiny", "--seconds", "0.5", "--bucket", "1", "--frames", "4",
                                   "--mode", mode, *extra, "--device", "cpu", "--output", out])
        capsys.readouterr()
        with open(out) as f:
            got = json.load(f)
        ref = want.get(mode, want["closed"])
        assert got == json.loads(json.dumps(report, default=float))
        assert set(got) == set(ref) and _keys(got["sla"]) == _keys(ref["sla"])
        assert got["mode"] == mode and got["frames"] > 0
        assert got["path"] == ref["path"]
        if mode == "overload":
            assert got["overload_policy"] == ref["overload_policy"] == "shed_oldest"
            assert got["shed_or_rejected"] > 0
            assert got["frames"] + got["shed_or_rejected"] == got["submitted"]
    monkeypatch.setattr(sys, "argv", [
        "serve_median_report.py", "--config", f"overload={tmp_path}/port_overload.json",
        "--config", f"rated8={tmp_path}/port_rated.json", "--floor-ms", "10",
        "--output", str(tmp_path / "median.json")])
    _load("scripts/serve_median_report.py", "_median_report").main()
    with open(tmp_path / "median.json") as f:
        median = json.load(f)
    assert set(median["configs"]) == {"overload", "rated8"}
    assert median["configs"]["rated8"]["metrics"]["p95_ms"]["n_reps"] == 1


def test_serve_bench_reads_the_class_count_of_a_port_checkpoint(checkpoints):
    """``infer_num_classes`` reads out channels = 3 x (5 + C) of the port
    checkpoint's prediction conv (80 for the tiny converted weights)."""
    assert serve_bench.infer_num_classes(checkpoints[1]) == 80


def _hand_made_log(path):
    """A chunked run's rows (one timestamp per chunk of 5) with a resumed
    stretch: steps 8-10 logged twice, the second time with other values."""
    rows = []
    for step in range(1, 21):
        chunk_t = 1000.0 + 0.5 * ((step - 1) // 5)
        rows.append({"step": step, "time": chunk_t, "loss": 5.0 / step, "grad_norm": 1.0 + step,
                     "lr_scale": 1.0 if step < 15 else 0.5, "ds_error_max": 1e-4 * step})
        if step == 10:
            for again in range(8, 11):
                rows.append({"step": again, "time": 1010.0, "loss": 4.0 / again,
                             "grad_norm": 0.5 + again, "lr_scale": 1.0,
                             "ds_error_max": 2e-4 * again})
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)


def test_summarize_run_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """The same output as ``scripts/summarize_run.py`` on a tiny run of the
    port's ``train_device`` (its steps, chunks and stability report) and
    on a hand-made log with a resumed duplicate stretch and chunk-equal
    timestamps."""
    from hvs_tpu_torch import train_device

    run = tmp_path / "run"
    train_device.run(train_device.parse_args([
        "--synthetic", "8", "--tiny", "--device", "cpu", "--total-steps", "4",
        "--chunk-steps", "2", "--eig-every-chunks", "1", "--run-dir", str(run)]))
    _hand_made_log(tmp_path / "hand.jsonl")
    script = _load("scripts/summarize_run.py", "_jax_summarize_run")
    cases = {"run": ["--steps", str(run / "steps.jsonl"), "--chunks", str(run / "chunks.jsonl"),
                     "--report", str(run / "stability_report.json")],
             "hand": ["--steps", str(tmp_path / "hand.jsonl")]}
    for name, args in cases.items():
        monkeypatch.setattr(sys, "argv", ["summarize_run.py", *args,
                                          "--output", str(tmp_path / f"jax_{name}.json")])
        script.main()
        got = summarize_run.main([*args, "--output", str(tmp_path / f"port_{name}.json")])
        capsys.readouterr()
        with open(tmp_path / f"jax_{name}.json") as f:
            want = json.load(f)
        with open(tmp_path / f"port_{name}.json") as f:
            assert json.load(f) == want == json.loads(json.dumps(got))
    with open(tmp_path / "jax_run.json") as f:
        assert {"eigenvalue_telemetry", "ds_error_proj_max_overall", "monitor"} <= set(json.load(f))
    assert want["steps"] == 20 and want["grad_norm"]["max"] == 21.0


def test_serve_policy_sim_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """Both policies complete their requests on the stub engine, with the
    JAX script's report keys; the port's fixed-deadline batcher is a
    subclass of its real ``_MicroBatcher``."""
    from hvs_tpu_torch.inference.engine import _MicroBatcher

    args = ["--seconds", "0.3", "--rates", "40", "--fixed-ms", "5", "--per-item-ms", "0.5",
            "--deadline-ms", "10"]
    monkeypatch.setattr(sys, "argv", ["serve_policy_sim.py", *args,
                                      "--output", str(tmp_path / "jax.json")])
    _load("scripts/serve_policy_sim.py", "_jax_policy_sim").main()
    got = serve_policy_sim.main([*args, "--output", str(tmp_path / "port.json")])
    capsys.readouterr()
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert _keys(got) == _keys(want)
    for report in (got, want):
        for policy in ("adaptive_flush_r4", "fixed_deadline_r3"):
            assert report["rates"]["40.0"][policy]["completed"] > 0
    assert issubclass(serve_policy_sim.LegacyBatcher, _MicroBatcher)


@pytest.mark.parametrize("module, argv", [
    ("benchmark", ["--tiny", "--batches", "1"]),
    ("serve_bench", ["--tiny", "--seconds", "0.1"]),
    ("accuracy_sweep", ["--checkpoint", "missing", "--data-root", "missing"]),
])
def test_entry_points_raise_without_a_card(module, argv, monkeypatch):
    """Without CUDA and without ``--device cpu`` the engine-based entry
    points raise before anything runs: there is no CPU fallback."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"hvs_tpu_torch.{module}").main(argv)
