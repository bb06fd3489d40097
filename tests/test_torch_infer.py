"""The serve path's remaining options on the CPU, against the JAX package:
the engine with soft and matrix NMS, checkpoints of the JAX package
imported by ``scripts/torch_import_checkpoint.py`` and served by both
engines, ``python -m hvs_tpu_torch.infer`` against ``scripts/inference.py``,
``utils/profiler.py`` and ``utils/logging.py``.

Engines are ``tests/test_torch_engine.py``'s tiny fp32 pair on conditioned
weights (scores spread across the threshold): packed outputs within
rtol 2e-3 / atol 5e-3, classes and counts exact. The CLIs run the
``--tiny`` model (80 classes) in fp32 on conditioned weights written as a
flax msgpack file for JAX's script and converted by the tool for the port's:
the results files must have the same keys, and each image the same
detections within the engines' tolerance.
"""

import functools
import importlib.util
import json
import os
import sys

import chip_smoke
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from flax import serialization

from hvs_tpu.config import ModelConfig as JaxModelConfig
from hvs_tpu.inference import InferenceEngine as JaxEngine
from hvs_tpu.utils.logging import StructuredLogger as JaxStructuredLogger
from hvs_tpu_torch import infer
from hvs_tpu_torch.config import ModelConfig as PortModelConfig
from hvs_tpu_torch.inference import InferenceEngine
from hvs_tpu_torch.utils import (InferenceProfiler, ModelProfiler, ResourceMonitor,
                                 StructuredLogger, setup_logger)
from tests.test_torch_engine import (ATOL, RTOL, _check_detections, _check_packed, _configs,
                                     _images)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


import_tool = _script("torch_import_checkpoint")


def _conditioned_init(jm, seed=1):
    """A jitted JAX init of ``jm`` with the head conditioned as in
    ``tests/test_torch_engine.py`` (numpy arrays)."""
    model = jm.build_model(production=True)
    v = jax.jit(functools.partial(model.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(v["params"]))
    r = np.random.default_rng(seed)
    for head in params["detection_head"].values():
        pred = head["predict"]
        pred["kernel"] = (pred["kernel"] * 4.0).astype(np.float32)
        bias = np.array(pred["bias"]).reshape(3, -1)
        bias[:, 4] = 1.0
        bias[:, 5:] = r.standard_normal(bias[:, 5:].shape)
        pred["bias"] = bias.reshape(-1).astype(np.float32)
    return params


def _with_ema(params):
    """EMA weights that differ from ``params``: the head's kernels x 0.9."""
    ema = jax.tree_util.tree_map(np.array, params)
    for head in ema["detection_head"].values():
        head["predict"]["kernel"] = (head["predict"]["kernel"] * 0.9).astype(np.float32)
    return ema


def _serve(engine, images):
    handle = engine.dispatch_batch(images)
    out = np.asarray(handle["device"]) if "device" in handle else handle["out"].numpy().copy()
    return out, engine.finalize_batch(handle)


def _check_packed_any_order(want, got):
    """``_check_packed`` where detections may come in another order: each
    image's detections pair off one to one, same class, boxes and scores
    within the tolerance. Soft and matrix NMS rank by decayed scores, which
    carry the forward's differences and, in the reference, its class
    offset's rounding of normalized boxes; two within the tolerance of each
    other may swap."""
    assert want.shape == got.shape
    np.testing.assert_array_equal(got[:, 0, 6], want[:, 0, 6])
    assert want[:, 0, 6].sum() >= 4
    for w, g, n in zip(want, got, want[:, 0, 6].astype(int)):
        free = list(range(n))
        for row in g[:n]:
            match = [i for i in free if w[i, 5] == row[5]
                     and np.allclose(row[:5], w[i, :5], rtol=RTOL, atol=ATOL)]
            assert match, (row, w[:n])
            free.remove(match[0])


@pytest.mark.parametrize("method", ["soft", "matrix"])
def test_engine_nms_methods_match_jax(method):
    """A tiny port engine against a tiny JAX engine with ``nms_method``
    soft and matrix, on the same weights and frames: the letterboxed path
    (mixed shapes) and the raw path (a registered shape, letterbox inside
    the serve function)."""
    jm, ji, pm, pi = _configs()
    ji.postprocessing.nms_method = pi.postprocessing.nms_method = method
    params = _conditioned_init(jm)
    jax_engine = JaxEngine(jm, ji, variables={"params": params})
    port = InferenceEngine(pm, pi, variables={"params": params})
    for images in (_images(20, [(60, 50), (64, 64)]), _images(21, [(48, 80), (48, 80)])):
        if images[0].shape == images[1].shape:
            for engine in (jax_engine, port):
                engine.register_raw_shape(images[0].shape[:2], buckets=(2,))
        want, _ = _serve(jax_engine, images)
        got, _ = _serve(port, images)
        _check_packed_any_order(want, got)
    assert {e.nms_method for e in port._serve_fns.values()} == {method}


def _port_model_json(pm, path):
    with open(path, "w") as f:
        json.dump({k: v for k, v in pm.to_dict().items() if k != "device"}, f, default=list)
    return str(path)


def test_jax_checkpoints_serve_in_the_port(tmp_path):
    """An orbax checkpoint with EMA (the JAX trainer's layout) and a flax
    msgpack file, written from a tiny JAX init, imported by the tool and
    served by both engines: the same detections. The orbax import carries
    the EMA weights and ``use_ema`` serves them, as the JAX engine does; the
    msgpack import carries the params only (the JAX engine serves a msgpack
    file's params); ``use_ema=False`` serves the params."""
    jm, ji, pm, pi = _configs()
    params = _conditioned_init(jm)
    ema = _with_ema(params)
    orbax_dir = str(tmp_path / "orbax_ckpt")
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(orbax_dir, {"params": params, "ema_params": ema, "step": np.int32(7),
                               "lr_scale": np.float32(1.0)})
    msgpack_file = str(tmp_path / "model.msgpack")
    with open(msgpack_file, "wb") as f:
        f.write(serialization.msgpack_serialize({"params": params, "ema_params": ema}))
    config = _port_model_json(pm, tmp_path / "model.json")
    converted = {}
    for name, src in (("orbax", orbax_dir), ("msgpack", msgpack_file)):
        out = str(tmp_path / f"{name}.pt")
        import_tool.main([src, out, "--config", config])
        converted[name] = torch.load(out)
    assert sorted(converted["orbax"]) == ["ema_params", "params"]
    assert sorted(converted["msgpack"]) == ["params"]

    images = _images(22, [(60, 50), (64, 64)])
    for name, src in (("orbax", orbax_dir), ("msgpack", msgpack_file)):
        ji.checkpoint_path, pi.checkpoint_path = src, str(tmp_path / f"{name}.pt")
        want, want_det = _serve(JaxEngine(jm, ji), images)
        port = InferenceEngine(pm, pi)
        got, got_det = _serve(port, images)
        _check_packed(want, got)
        _check_detections(want_det, got_det)
        served = "ema_params" if name == "orbax" else "params"
        for pname, p in port.model.named_parameters():
            assert torch.equal(p, converted[name][served][pname]), pname
    pi.use_ema = False
    pi.checkpoint_path = str(tmp_path / "orbax.pt")
    port = InferenceEngine(pm, pi)
    for pname, p in port.model.named_parameters():
        assert torch.equal(p, converted["orbax"]["params"][pname]), pname
    kernel = "detection_head.head_fused_small.predict.kernel"
    assert not torch.equal(converted["orbax"]["params"][kernel],
                           converted["orbax"]["ema_params"][kernel])
    with pytest.raises(ValueError, match="does not map"):  # a tree of 8 classes, not 80
        import_tool.main([msgpack_file, str(tmp_path / "bad.pt"), "--tiny"])


def _tiny_jax_config():
    """``scripts/inference.py``'s ``--tiny`` model config."""
    mcfg = JaxModelConfig()
    mcfg.backbone.stage_channels = (16, 24, 32, 40)
    mcfg.backbone.stage_blocks = (1, 1, 1, 1)
    mcfg.vit.dim, mcfg.vit.depth, mcfg.vit.num_heads = 16, 1, 2
    mcfg.fusion.fpn_channels = 16
    mcfg.detection.head_channels = 16
    mcfg.mhc.sinkhorn_iterations = 5
    return mcfg


def _write_video(path, frames):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        writer.write(f)
    writer.release()


def test_infer_cli_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """``python -m hvs_tpu_torch.infer --tiny --device cpu`` against
    ``scripts/inference.py --tiny`` on an image, a directory, a video and
    the synthetic camera, from the same weights (a msgpack file for the
    reference, the tool's conversion of it for the port) and the same
    ``--config`` (one bucket): the same ``results.json`` keys and summary
    keys, the same frame counts, each image's detections within the
    engines' tolerance. Both scripts build their model config in fp32 here
    (the config class's default precision is bf16, whose rounding differs
    between the two libraries more than the tolerance allows); nothing else
    of either script changes."""
    params = _conditioned_init(_tiny_jax_config(), seed=3)
    msgpack_file = str(tmp_path / "tiny.msgpack")
    with open(msgpack_file, "wb") as f:
        f.write(serialization.msgpack_serialize({"params": params}))
    port_ckpt = str(tmp_path / "tiny.pt")
    import_tool.main([msgpack_file, port_ckpt, "--tiny"])
    config = str(tmp_path / "inference.json")
    with open(config, "w") as f:
        json.dump({"performance": {"batch_buckets": [1], "warmup_iterations": 1},
                   "postprocessing": {"max_detections": 24}}, f)
    images = _images(23, [(72, 96), (64, 64), (50, 90)])
    os.makedirs(tmp_path / "imgs")
    for i, img in enumerate(images):
        cv2.imwrite(str(tmp_path / "imgs" / f"im{i}.jpg"), img)
    _write_video(str(tmp_path / "clip.avi"), _images(24, [(60, 80)] * 5))

    script = _script("inference")
    monkeypatch.setattr("hvs_tpu.utils.enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr("hvs_tpu.config.ModelConfig",
                        functools.partial(JaxModelConfig, precision="fp32"))
    monkeypatch.setattr("hvs_tpu_torch.config.ModelConfig",
                        functools.partial(PortModelConfig, precision="fp32"))
    sources = {"image": ["--image", str(tmp_path / "imgs" / "im0.jpg")],
               "dir": ["--dir", str(tmp_path / "imgs")],
               "video": ["--video", str(tmp_path / "clip.avi"), "--frames", "5"],
               "synthetic": ["--source", "synthetic", "--frames", "4"]}
    for name, args in sources.items():
        common = [*args, "--tiny", "--config", config]
        monkeypatch.setattr(sys, "argv", ["inference.py", *common, "--checkpoint", msgpack_file,
                                          "--output", str(tmp_path / f"jax_{name}")])
        script.main()
        want_summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        run = infer.main([*common, "--checkpoint", port_ckpt, "--device", "cpu",
                          "--output", str(tmp_path / f"port_{name}")])
        got_summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert run.summary == got_summary
        assert set(got_summary) == set(want_summary)
        assert got_summary["processed"] == want_summary["processed"]
        with open(want_summary["results_file"]) as f:
            want = json.load(f)
        with open(got_summary["results_file"]) as f:
            got = json.load(f)
        assert set(got) == set(want) == chip_smoke.INFER_FILE_KEYS
        assert set(want_summary) == chip_smoke.INFER_SUMMARY_KEYS
        assert len(got["results"]) == len(want["results"])
        kind = "image" if name in ("image", "dir") else name
        for g, w in zip(got["results"], want["results"]):
            assert set(g) == set(w) == chip_smoke.INFER_RESULT_KEYS[kind], name
            if "detections" in w:
                assert os.path.basename(g["file"]) == os.path.basename(w["file"])
                assert set(g["detections"]) == set(w["detections"])
                assert set(g["timing_ms"]) == set(w["timing_ms"])
                assert g["num_detections"] == w["num_detections"] > 0
                gd, wd = g["detections"], w["detections"]
                assert gd["classes"] == wd["classes"] and gd["class_names"] == wd["class_names"]
                np.testing.assert_allclose(gd["scores"], wd["scores"], rtol=RTOL, atol=ATOL)
                scale = max(cv2.imread(w["file"]).shape[:2]) / 64
                np.testing.assert_allclose(gd["boxes"], wd["boxes"], rtol=RTOL,
                                           atol=ATOL * 64 * scale)
            else:
                assert g["frames"] == w["frames"] > 0
        if name == "dir":
            assert want_summary["processed"] == len(images)
    with pytest.raises(SystemExit):
        infer.main(["--tiny", "--device", "cpu"])


def test_model_profiler_counts_a_matmul_and_kernel_a():
    """``cost_analysis``'s flops: 2·M·K·N for a product; kernel A's operator
    by its formula, 8·N·d²; bytes: the operands and the result."""
    a, b = torch.randn(48, 40), torch.randn(40, 24)
    costs = ModelProfiler(torch.matmul, a, b).cost_analysis()
    assert costs["flops"] == 2 * 48 * 40 * 24
    assert costs["bytes accessed"] == 4 * (48 * 40 + 40 * 24 + 48 * 24)
    from hvs_tpu_torch.ops.mhc_block import mhc_block

    n, d = 70, 32
    g = torch.Generator().manual_seed(0)
    mats = [torch.randn(d, d, generator=g).bfloat16() for _ in range(4)]
    vecs = [torch.randn(d, generator=g) for _ in range(6)]
    args = (torch.randn(n, d, generator=g).bfloat16(), mats[0], vecs[0], mats[1], vecs[1],
            mats[2], mats[3], *vecs[2:])
    assert ModelProfiler(mhc_block, *args).cost_analysis()["flops"] == 8 * n * d * d
    report = ModelProfiler(torch.matmul, a, b).profile(iters=3)
    assert report.flops == 2 * 48 * 40 * 24 and report.wall_time_ms > 0
    assert report.memory_mb is None and report.achieved_tflops > 0


def test_profiler_trace_sweep_and_monitor(tmp_path):
    x = torch.randn(16, 16)
    log_dir = ModelProfiler(torch.relu, x).trace(str(tmp_path / "trace"), iters=2)
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    prof = InferenceProfiler(lambda b: (lambda t: t @ t.T), batch_sizes=(1, 4))
    results = prof.run(lambda b: torch.randn(b, 8), iters=3)
    assert set(results) == {1, 4} and all(r["latency_ms"] > 0 for r in results.values())
    assert prof.optimal_batch() in (1, 4) and set(prof.scaling_efficiency()) == {1, 4}
    monitor = ResourceMonitor(interval_s=0.01)
    monitor.start()
    while len(monitor.samples) < 2:
        pass
    summary = monitor.stop()
    assert monitor._thread is None and summary["cpu_percent_max"] >= 0
    assert "mem_used_gb_mean" in summary


def test_structured_logger_matches_jax(tmp_path):
    """The same calls give the same files and the same JSONL records (but
    their wall-clock ``time``), metric history and timers."""
    records = {}
    for side, cls in (("port", StructuredLogger), ("jax", JaxStructuredLogger)):
        log_dir = str(tmp_path / side)
        logger = cls(name="run", log_dir=log_dir)
        logger.info("step %d", 1)
        logger.error("bad %s", "thing")
        logger.log_metrics({"loss": 1.5, "acc": np.float32(0.25), "name": "skip"}, step=3,
                           prefix="train/")
        logger.log_gradient_norm(2.0, step=4)
        logger.log_learning_rate(1e-3, step=4)
        with logger.timer("fwd", step=5):
            pass
        assert logger.get_metric_history("train/loss") == [(3, 1.5)]
        logger.close()
        with open(os.path.join(log_dir, "run.metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        records[side] = {"files": sorted(os.listdir(log_dir)),
                         "rows": [{k: v for k, v in r.items() if k != "time"} for r in rows],
                         "error_log": open(os.path.join(log_dir, "run.error.log")).read().count(
                             "bad thing")}
        assert all("time" in r for r in rows)
    assert records["port"]["rows"] == [r if "time/fwd" not in r else
                                       {**r, "time/fwd": records["port"]["rows"][-1]["time/fwd"]}
                                       for r in records["jax"]["rows"]]
    assert records["port"]["files"] == records["jax"]["files"]
    assert records["port"]["error_log"] == records["jax"]["error_log"] == 1
    assert setup_logger("port_default").logger.name == "port_default"
