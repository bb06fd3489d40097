"""The port's serving engine on the CPU: admission control, the micro-batcher,
chunking, the async facade, hot swap under load, config rebuilds, and the
precision flags and configuration it rests on.

Counterparts of ``tests/test_admission.py``, the config-rebuild test of
``tests/test_hot_swap.py`` and the engine tests of ``tests/test_inference.py``,
on a tiny engine of the port (``device="cpu"``: no graphs, the plain kernel
versions). The engine's agreement with the JAX engine is in
``tests/test_torch_engine.py``.
"""

import asyncio
import json
import queue
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hvs_tpu_torch.config import InferenceConfig, ModelConfig, load_config
from hvs_tpu_torch.data import letterbox
from hvs_tpu_torch.device import pin_matmul_precision
from hvs_tpu_torch.inference import (AsyncInferenceEngine, EngineOverloaded, ImagePreprocessor,
                                     InferenceEngine, NMSFilter)
from hvs_tpu_torch.inference.engine import _MicroBatcher
from hvs_tpu_torch.utils.tracing import SpanRecorder

torch.set_num_threads(1)

IMG = np.zeros((8, 8, 3), np.uint8)


def port_model_config(**overrides) -> ModelConfig:
    """The JAX engine tests' tiny model (``tests/test_inference.py``) on the CPU."""
    cfg = ModelConfig(input_size=64, feature_dim=32, device="cpu", **overrides)
    cfg.backbone.stage_channels = (16, 24, 32, 40)
    cfg.backbone.stage_blocks = (1, 1, 1, 1)
    cfg.vit.dim, cfg.vit.depth, cfg.vit.num_heads = 16, 1, 2
    cfg.fusion.fpn_channels = 16
    cfg.fusion.out_channels = (16, 24, 32)
    cfg.detection.head_channels = 16
    cfg.detection.num_classes = 8
    cfg.mhc.sinkhorn_iterations = 5
    return cfg


def port_inference_config() -> InferenceConfig:
    cfg = InferenceConfig(device="cpu")
    cfg.preprocessing.image_size = 64
    cfg.performance.batch_buckets = (1, 2)
    cfg.postprocessing.score_threshold = 0.01
    cfg.postprocessing.pre_nms_top_k = 64
    cfg.postprocessing.max_detections = 16
    return cfg


def _image(seed=0, h=80, w=100):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)


@pytest.fixture(scope="module")
def tiny_port_engine():
    e = InferenceEngine(port_model_config(), port_inference_config())
    e.warmup()
    return e


# ---------------- admission control (test_admission.py) ----------------


def make_batcher(policy="reject", depth=4):
    perf = SimpleNamespace(batch_buckets=(1, 2), max_queue_depth=depth, overload_policy=policy,
                           max_queue_delay_ms=33.0)
    return _MicroBatcher(SimpleNamespace(config=SimpleNamespace(performance=perf),
                                         spans=SpanRecorder()))


@pytest.mark.parametrize("policy", ["reject", "shed_oldest"])
def test_overload_policy(policy):
    b = make_batcher(policy, depth=2)
    f0, f1 = b.submit(IMG), b.submit(IMG)
    if policy == "reject":
        with pytest.raises(EngineOverloaded):
            b.submit(IMG)
        assert not f0.done() and not f1.done()
        assert (b.stats()["rejected"], b.stats()["shed"]) == (1, 0)
    else:
        f2 = b.submit(IMG)  # overflows: f0 is shed, f2 admitted
        assert isinstance(f0.exception(), EngineOverloaded)
        assert not f1.done() and not f2.done()
        assert (b.stats()["rejected"], b.stats()["shed"]) == (0, 1)
    assert b.stats()["queue_depth"] == b.stats()["queue_capacity"] == 2


def test_queue_depth_sized_from_service_time():
    perf = SimpleNamespace(batch_buckets=(1, 2, 8), max_queue_depth=0, overload_policy="reject",
                           max_queue_delay_ms=33.0, queue_budget_ms=100.0, latency_target_ms=50.0)
    engine = SimpleNamespace(config=SimpleNamespace(performance=perf), _service_time_s={},
                             spans=SpanRecorder())
    assert _MicroBatcher(engine).queue.maxsize == 16  # no warmup: 2 x largest bucket
    engine._service_time_s = {1: 0.010, 8: 0.040}  # 5 ms per item at bucket 8
    assert _MicroBatcher(engine).queue.maxsize == 20  # 100 ms / 5 ms
    perf.queue_budget_ms = 0.0
    assert _MicroBatcher(engine).queue.maxsize == 10  # latency_target_ms
    engine._service_time_s = {8: 0.400}
    assert _MicroBatcher(engine).queue.maxsize == 8  # never below one batch


def test_accepting_tracks_capacity():
    e = object.__new__(InferenceEngine)
    e._batcher = None
    assert not InferenceEngine.accepting(e)
    e._batcher = make_batcher("reject", depth=2)
    assert InferenceEngine.accepting(e)
    e._batcher.submit(IMG)
    assert InferenceEngine.accepting(e)
    e._batcher.submit(IMG)
    assert not InferenceEngine.accepting(e)


class _StubEngine:
    """Records dispatch sizes; an instant device with an optional service time."""

    def __init__(self, max_delay_ms=50.0, service_s=0.0):
        self.config = SimpleNamespace(performance=SimpleNamespace(
            batch_buckets=(1, 2, 8), max_queue_depth=64, overload_policy="reject",
            max_queue_delay_ms=max_delay_ms))
        self.metrics = SimpleNamespace(record_error=lambda: None)
        self.spans = SpanRecorder()
        self.dispatches = []
        self.service_s = service_s

    def dispatch_batch(self, images, requests=None):
        self.dispatches.append(len(images))
        return {"n": len(images)}

    def finalize_batch(self, handle):
        time.sleep(self.service_s)
        return [f"det{i}" for i in range(handle["n"])]


def test_idle_device_dispatches_at_once():
    eng = _StubEngine(max_delay_ms=200.0)
    b = _MicroBatcher(eng)
    b.start()
    try:
        t0 = time.perf_counter()
        assert b.submit(IMG).result(timeout=5.0) == "det0"
        assert time.perf_counter() - t0 < 0.15  # far below the 200 ms deadline
        assert eng.dispatches[0] == 1
    finally:
        b.stop()


def test_busy_device_accumulates_batches():
    eng = _StubEngine(max_delay_ms=30.0, service_s=0.02)
    b = _MicroBatcher(eng)
    b.start()
    try:
        for f in [b.submit(IMG) for _ in range(24)]:
            f.result(timeout=10.0)
        assert sum(eng.dispatches) == 24
        assert max(eng.dispatches) > 1 and len(eng.dispatches) < 24
    finally:
        b.stop()


# ---------------- the engine (test_inference.py) ----------------


def test_engine_output_structure(tiny_port_engine):
    det = tiny_port_engine.infer(_image())
    assert det.image_size == (80, 100) and det.latency_ms > 0
    assert len(det.scores) == len(det.boxes) == len(det.classes) == len(det.class_names)
    assert len(det) > 0  # score threshold 0.01: random init detects something
    assert det.boxes[:, [0, 2]].max() <= 100 and det.boxes[:, [1, 3]].max() <= 80
    assert det.boxes.min() >= 0
    assert set(det.to_dict()) == {"boxes", "scores", "classes", "class_names", "latency_ms"}


def test_engine_deterministic_and_edge_cases(tiny_port_engine):
    img = _image(3)
    d1, d2 = tiny_port_engine.infer(img), tiny_port_engine.infer(img)
    np.testing.assert_array_equal(d1.boxes, d2.boxes)
    np.testing.assert_array_equal(d1.scores, d2.scores)
    for edge in (np.zeros((8, 8, 3), np.uint8), np.full((64, 64, 3), 255, np.uint8),
                 _image(4, h=10, w=200)):
        assert tiny_port_engine.infer(edge).boxes.shape[-1] == 4


def test_engine_chunks_beyond_the_largest_bucket(tiny_port_engine):
    images = [_image(i, h=40 + i, w=50) for i in range(5)]  # buckets (1, 2): 2 + 2 + 1
    before = dict(tiny_port_engine.replays)
    results = tiny_port_engine.infer_batch(images)
    assert [r.image_size for r in results] == [im.shape[:2] for im in images]
    after = tiny_port_engine.replays
    assert (after[2] - before[2], after[1] - before[1]) == (2, 1)
    with pytest.raises(ValueError, match="largest bucket"):
        tiny_port_engine.dispatch_batch(images)
    single = tiny_port_engine.infer(images[4])
    np.testing.assert_allclose(results[4].boxes, single.boxes, atol=1e-4)


def test_engine_register_raw_shape_and_unregistered_shapes(tiny_port_engine):
    tiny_port_engine.register_raw_shape((48, 64))
    assert (48, 64) in tiny_port_engine._raw_shapes
    for b in tiny_port_engine.config.performance.batch_buckets:
        assert (b, (48, 64)) in tiny_port_engine._serve_fns
    before = set(tiny_port_engine._serve_fns)
    det = tiny_port_engine.infer(_image(9, h=37, w=53))  # unregistered: letterboxed path
    assert det.image_size == (37, 53)
    assert set(tiny_port_engine._serve_fns) == before
    img = _image(11, h=48, w=64)
    d_raw = tiny_port_engine.infer(img)
    tiny_port_engine._raw_shapes.discard((48, 64))
    try:
        d_host = tiny_port_engine.infer(img)
    finally:
        tiny_port_engine._raw_shapes.add((48, 64))
    # 48x64 into 64: no resize, only the pad, so both paths see the same pixels.
    np.testing.assert_allclose(d_raw.boxes, d_host.boxes, atol=1e-3)
    np.testing.assert_allclose(d_raw.scores, d_host.scores, atol=1e-5)


def test_engine_stats_and_stability_report(tiny_port_engine):
    tiny_port_engine.infer(_image(5))
    stats = tiny_port_engine.get_performance_stats()
    assert stats["count"] >= 1 and "p95_latency_ms" in stats and "service_ms_b2" in stats
    rep = tiny_port_engine.get_stability_report()
    assert rep["num_mhc_layers"] > 3 and rep["max_ds_error"] < 1e-2
    assert rep["eigenvalue_constraint_satisfied"]


def test_engine_micro_batcher_and_async_facade(tiny_port_engine):
    tiny_port_engine.start_batcher()
    try:
        futs = [tiny_port_engine.submit(_image(i)) for i in range(3)]
        assert all(f.result(timeout=30).latency_ms > 0 for f in futs)
    finally:
        tiny_port_engine.stop_batcher()

    async def go():
        ae = AsyncInferenceEngine(tiny_port_engine)
        try:
            one = await ae.infer(_image(9))
            many = await ae.infer_batch([_image(1), _image(2)])
            return one, many
        finally:
            ae.close()

    one, many = asyncio.run(go())
    assert one.latency_ms > 0 and len(many) == 2
    assert tiny_port_engine._batcher is None


@pytest.mark.parametrize("policy", ["reject", "shed_oldest"])
def test_batcher_counts_are_exact_under_concurrent_submits(tiny_port_engine, policy):
    """8 threads submit 500 requests each to a running batcher with a short
    queue: every submit is counted, and each refusal or shed once."""
    b = _MicroBatcher(tiny_port_engine)
    b.policy, b.queue = policy, queue.Queue(maxsize=4)
    futs, refused, lock = [], [0], threading.Lock()

    def client():
        mine, no = [], 0
        for _ in range(500):
            try:
                mine.append(b.submit(IMG))
            except EngineOverloaded:
                no += 1
        with lock:
            futs.extend(mine)
            refused[0] += no

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    b.start()
    try:
        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        b.stop()
    stats = b.stats()
    assert stats["submitted"] == len(futs) + refused[0] == 4000
    assert stats["rejected"] == refused[0]
    shed = sum(1 for f in futs if f.done() and isinstance(f.exception(), EngineOverloaded))
    assert stats["shed"] == shed
    assert (refused[0] > 0) == (policy == "reject") and (shed > 0) == (policy == "shed_oldest")


def _port_params(seed):
    m = port_model_config().build_model(production=True, seed=seed)
    return {k: v.detach().clone() for k, v in m.named_parameters()}


def test_reload_during_hammering_serves_old_or_new_weights():
    """While a thread serves one frame in a loop, the weights are swapped:
    every result equals the old weights' output or the new weights', never a
    mixture."""
    engine_a = InferenceEngine(port_model_config(), port_inference_config(),
                               variables={"params": _port_params(0)})
    img = _image(21)
    old = engine_a.infer(img)
    new_params = _port_params(1)
    new = InferenceEngine(port_model_config(), port_inference_config(),
                          variables={"params": new_params}).infer(img)
    assert len(old) != len(new) or not np.allclose(old.scores, new.scores)
    seen, stop = [], threading.Event()

    def hammer():
        while not stop.is_set():
            seen.append(engine_a.infer(img))

    t = threading.Thread(target=hammer)
    t.start()
    time.sleep(0.3)
    engine_a.reload({"params": new_params})
    time.sleep(0.3)
    stop.set()
    t.join()

    def same(a, b):
        return (len(a) == len(b) and np.array_equal(a.classes, b.classes)
                and np.allclose(a.boxes, b.boxes, atol=1e-4)
                and np.allclose(a.scores, b.scores, atol=1e-6))

    kinds = ["old" if same(d, old) else "new" if same(d, new) else "mixed" for d in seen]
    assert "mixed" not in kinds
    assert kinds[0] == "old" and kinds[-1] == "new"
    assert kinds == sorted(kinds, key=lambda k: k == "new")  # old, then new


def test_reload_checks_the_structure(tiny_port_engine):
    params = {k: v.detach().clone() for k, v in tiny_port_engine.model.named_parameters()}
    params.pop("feature_proj.bias")
    with pytest.raises(KeyError, match="feature_proj.bias"):
        tiny_port_engine.reload({"params": params})
    params["feature_proj.bias"] = torch.zeros(7)
    with pytest.raises(ValueError, match="feature_proj.bias"):
        tiny_port_engine.reload({"params": params})


def test_detect_during_config_rebuild():
    """Thresholds are fixed into each serve function: while a thread serves,
    the score threshold flips and the functions are rebuilt; every result
    is one threshold's."""
    e = InferenceEngine(port_model_config(), port_inference_config())
    img = _image(30)
    results = {}
    for thr in (0.01, 0.02):
        e.config.postprocessing.score_threshold = thr
        e.rebuild_serve_fns()
        results[thr] = len(e.infer(img))
    assert results[0.01] > results[0.02]
    seen, stop, errors = [], threading.Event(), []

    def hammer():
        try:
            while not stop.is_set():
                seen.append(len(e.infer(img)))
        except Exception as err:  # pragma: no cover - surfaced below
            errors.append(err)

    t = threading.Thread(target=hammer)
    t.start()
    for i in range(6):
        e.config.postprocessing.score_threshold = 0.01 if i % 2 else 0.02
        e.rebuild_serve_fns()
        time.sleep(0.05)
    stop.set()
    t.join()
    assert not errors and seen
    assert set(seen) <= set(results.values())


def test_engine_checkpoint_of_the_port_trainer(tmp_path):
    """``load_checkpoint`` reads a trainer checkpoint, preferring its EMA."""
    e = InferenceEngine(port_model_config(), port_inference_config())
    params = {k: v.detach().clone() for k, v in e.model.named_parameters()}
    ema = {k: v + 0.01 for k, v in params.items()}
    torch.save({"params": params, "ema_params": ema, "step": 3}, tmp_path / "ckpt.pt")
    loaded = e.load_checkpoint(str(tmp_path / "ckpt"))["params"]
    assert torch.equal(loaded["feature_proj.bias"], ema["feature_proj.bias"])
    e.config.use_ema = False
    loaded = e.load_checkpoint(str(tmp_path / "ckpt.pt"))["params"]
    assert torch.equal(loaded["feature_proj.bias"], params["feature_proj.bias"])


# ---------------- precision, configuration, not-ported options ----------------


def test_precision_helper_pins_the_three_flags():
    flags = (torch.backends.cuda.matmul, "allow_tf32"), (torch.backends.cudnn, "allow_tf32"), \
        (torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction")
    saved = [getattr(o, n) for o, n in flags]
    try:
        for o, n in flags:
            setattr(o, n, True)
        pin_matmul_precision()
        assert [getattr(o, n) for o, n in flags] == [False, False, False]
        for o, n in flags:
            setattr(o, n, True)
        InferenceEngine(port_model_config(), port_inference_config())
        assert [getattr(o, n) for o, n in flags] == [False, False, False]
    finally:
        for (o, n), v in zip(flags, saved):
            setattr(o, n, v)


# Soft and matrix NMS were ported: the cases now check that the engine and
# NMSFilter take them (the graphs record the method they were built for, and
# a rebuild picks up a new one), and that an unknown method still raises.
@pytest.mark.parametrize("method", ["soft", "matrix"])
def test_soft_and_matrix_nms_raise(method):
    cfg = port_inference_config()
    cfg.postprocessing.nms_method = method
    engine = InferenceEngine(port_model_config(), cfg)
    det = engine.infer(_image())
    assert engine._serve_fns[1].nms_method == method and np.isfinite(det.scores).all()
    cfg.postprocessing.nms_method = "hard"
    engine.rebuild_serve_fns()
    engine.infer(_image())
    assert engine._serve_fns[1].nms_method == "hard"
    assert NMSFilter(method).method == method
    with pytest.raises(ValueError, match="unknown NMS method"):
        NMSFilter("greedy")
    cfg.postprocessing.nms_method = "greedy"
    engine.rebuild_serve_fns()
    with pytest.raises(ValueError, match="unknown NMS method"):
        engine.infer(_image())


# use_segmentation, use_depth and vit.enabled=False were ported with the
# multi-task model, quantization.enabled with int8 serving and rag.enabled
# with the retrieval model: each case now checks that the config builds them
# (the ids keep the ROADMAP item they were ported under).
@pytest.mark.parametrize("field,item", [
    ("quantization", "item 8"), ("rag", "item 9"), ("use_segmentation", "item 9"),
    ("use_depth", "item 9"), ("vit", "item 9")])
def test_parts_not_ported_raise(field, item):
    cfg = port_model_config()
    if field == "quantization":
        cfg.quantization.enabled = True
    elif field == "rag":
        cfg.rag.enabled = True
    elif field == "vit":
        cfg.vit.enabled = False
    else:
        setattr(cfg, field, True)
    if field in ("use_segmentation", "use_depth", "vit"):
        model = cfg.build_model(production=True, task="multi_task")
        built = {"use_segmentation": model.segmentation_head, "use_depth": model.depth_head,
                 "vit": model.vit_encoder}
        assert {k: v is not None for k, v in built.items()} == {
            "use_segmentation": field == "use_segmentation", "use_depth": field == "use_depth",
            "vit": field != "vit"}
        return
    if field == "quantization":
        # The int8 twin (flags as JAX's build_model sets them); the engine
        # needs calibrated scales, as JAX's does.
        model = cfg.build_model(production=True)
        assert model.backbone.act_quant and not model.fpn.act_quant
        assert not cfg.build_model().backbone.act_quant  # a training model stays float
        with pytest.raises(ValueError, match="requires calibrated scales"):
            InferenceEngine(cfg, port_inference_config())
        return
    # rag: the knowledge module on the small scale behind its zero gate, its
    # mHC layer a kernel-A site, the knowledge base COCO's (80 + 5 facts).
    model = cfg.build_model(production=True)
    assert model.rag is not None and float(model.rag_gate.detach()) == 0.0
    assert model.rag.mhc_fuse.fused and tuple(model.rag.kb.shape) == (85, 128)
    assert "rag.kb" not in model.state_dict()  # a constant, in no checkpoint


def test_config_device_and_dtype(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ModelConfig()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InferenceEngine(port_model_config(), InferenceConfig(device="cpu"), device="cuda")
    cfg = port_model_config(precision="fp32")
    assert cfg.dtype() == torch.float32 and port_model_config().dtype() == torch.bfloat16
    model = cfg.build_model()
    assert next(model.parameters()).device.type == "cpu" and model.dtype == torch.float32
    for suffix in ("json", "yaml"):
        path = str(tmp_path / f"model.{suffix}")
        cfg.save(path)
        back = load_config(path)
        as_lists = json.loads(json.dumps(cfg.to_dict()))  # files keep tuples as lists
        assert isinstance(back, ModelConfig) and back.to_dict() == as_lists
    icfg = port_inference_config()
    icfg.save(str(tmp_path / "inference.yaml"))
    back = load_config(str(tmp_path / "inference.yaml"))
    assert back.performance.batch_buckets == [1, 2] and back.preprocessing.image_size == 64


def test_letterbox_keeps_numpy_and_tensor_kinds():
    img = _image(0, h=50, w=100)
    out, scale, pad = letterbox(img, 64)
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.shape == (64, 64, 3)
    assert scale == 0.64 and pad == (0, 16)
    assert (out[:16] == 114).all() and (out[16 + 32:] == 114).all()
    t_out, _, _ = letterbox(torch.from_numpy(img), 64)
    assert isinstance(t_out, torch.Tensor)
    np.testing.assert_array_equal(t_out.numpy(), out)
    r = ImagePreprocessor(image_size=64).process(img)
    assert r.image.shape == (64, 64, 3) and r.pad == (0, 16)
    np.testing.assert_array_equal(r.image, letterbox(np.ascontiguousarray(img[..., ::-1]), 64)[0])
