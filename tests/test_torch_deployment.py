"""The port's deployment layer on the CPU: live REST and gRPC servers, export,
the gated model repository and health checks, each against the JAX package.

A tiny JAX ``InferenceEngine`` and the port's engine share converted,
conditioned weights (``tests/test_torch_engine.py``'s configs: fp32, scores
spread across the 0.25 threshold). Counterparts of the 20 tests of
``tests/test_deployment.py`` run against the port's servers; the port's
REST and gRPC responses, its exported program, ``config.pbtxt``, manifest
and gate decisions are held against the JAX package's. Floats within
rtol 2e-3 / atol 5e-3 (normalized; boxes in pixels scale the atol), classes
exact. One deliberate difference: a JPEG large enough to be decoded reduced
gets its boxes and image size in the client's original pixels (the
reference returns the reduced image's), shown on its own.
"""

import asyncio
import base64
import functools
import json
import os
import subprocess
import sys
import threading
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.deployment import ModelExporter as JaxModelExporter
from hvs_tpu.deployment import RegistryGate as JaxRegistryGate
from hvs_tpu.deployment import RobotVisionService as JaxRobotVisionService
from hvs_tpu.deployment import ServingModelConfig as JaxServingModelConfig
from hvs_tpu.deployment import VisionAPIServer as JaxVisionAPIServer
from hvs_tpu.deployment.model_server import _config_pbtxt as jax_config_pbtxt
from hvs_tpu.inference import InferenceEngine as JaxEngine
from hvs_tpu.inference.preprocessing import decode_jpeg as jax_decode_jpeg
from hvs_tpu_torch.deployment import (
    APIChecker,
    HealthChecker,
    HealthStatus,
    ModelExporter,
    ModelServerManager,
    RegistryGate,
    RobotGRPCServer,
    RobotVisionClient,
    ServingModelConfig,
    VisionAPIServer,
)
from hvs_tpu_torch.deployment.model_server import _config_pbtxt
from hvs_tpu_torch.deployment.proto import robot_vision_pb2 as pb
from hvs_tpu_torch.inference import InferenceEngine
from hvs_tpu_torch.inference.preprocessing import decode_jpeg
from tests.test_torch_engine import ATOL, RTOL, _configs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTRY = os.path.join(REPO, "configs", "model_registry.yaml")


@pytest.fixture(scope="module")
def pair():
    """(JAX engine, port engine) on the same conditioned weights: the
    prediction convs scaled as in ``tests/test_torch_engine.py`` so that
    scores spread across the 0.25 threshold."""
    jm, ji, pm, pi = _configs()
    jax_model = jm.build_model(production=True)
    v = jax.jit(functools.partial(jax_model.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    params = jax.device_get(v["params"])
    r = np.random.default_rng(1)
    for head in params["detection_head"].values():
        pred = head["predict"]
        pred["kernel"] = (pred["kernel"] * 4.0).astype(np.float32)
        bias = np.array(pred["bias"]).reshape(3, -1)
        bias[:, 4] = 1.0
        bias[:, 5:] = r.standard_normal(bias[:, 5:].shape)
        pred["bias"] = bias.reshape(-1).astype(np.float32)
    return JaxEngine(jm, ji, variables={"params": params}), \
        InferenceEngine(pm, pi, variables={"params": params})


def _jpeg_bytes(seed=0, h=64, w=64) -> bytes:
    img = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return buf.tobytes()


def _smooth_jpeg(seed, h, w) -> bytes:
    """A JPEG of a blurred random image: its reduced decode keeps enough
    structure for detections."""
    img = np.random.default_rng(seed).integers(0, 255, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    assert ok
    return buf.tobytes()


# ---------------- REST --------------------------------------------------------


@pytest.fixture(scope="module")
def rest_client(pair, tmp_path_factory):
    """The port's aiohttp app on a test server on a background loop."""
    from aiohttp.test_utils import TestClient, TestServer

    server = VisionAPIServer(pair[1], results_dir=str(tmp_path_factory.mktemp("batch_results")))
    loop = asyncio.new_event_loop()
    holder = {}

    def run():
        asyncio.set_event_loop(loop)

        async def setup():
            client = TestClient(TestServer(server.app), loop=loop)
            await client.start_server()
            return client

        holder["client"] = loop.run_until_complete(setup())
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    for _ in range(300):
        if "client" in holder:
            break
        time.sleep(0.1)
    client = holder["client"]

    def call(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout=120)

    yield client, call
    call(client.close())
    loop.call_soon_threadsafe(loop.stop)
    server.shutdown()


def _post_json(rest_client, path, payload):
    client, call = rest_client

    async def go():
        resp = await client.post(path, json=payload)
        return resp.status, await resp.json()

    return call(go())


def test_api_detect_base64(rest_client):
    status, body = _post_json(rest_client, "/detect",
                              {"image_base64": base64.b64encode(_jpeg_bytes()).decode()})
    assert status == 200
    assert "detections" in body and "latency_ms" in body
    assert body["image_size"] == [64, 64]


def test_api_detect_multipart(rest_client):
    import aiohttp

    client, call = rest_client

    async def go():
        form = aiohttp.FormData()
        form.add_field("file", _jpeg_bytes(1), filename="a.jpg", content_type="image/jpeg")
        resp = await client.post("/detect", data=form)
        return resp.status, await resp.json()

    status, body = call(go())
    assert status == 200
    assert isinstance(body["detections"], list)


def test_api_fast_429_before_decode_when_queue_full(rest_client, pair):
    from hvs_tpu_torch.inference.engine import _MicroBatcher

    client, call = rest_client
    torch_engine = pair[1]
    b64 = base64.b64encode(_jpeg_bytes()).decode()
    batcher = _MicroBatcher(torch_engine)  # loop not started: the queue never drains
    batcher.queue.maxsize = 1
    batcher.queue.put_nowait((None, None))
    assert torch_engine._batcher is None
    torch_engine._batcher = batcher
    try:
        assert not torch_engine.accepting()

        async def go():
            resp = await client.post("/detect", json={"image_base64": b64})
            return resp.status, resp.headers.get("Retry-After")

        assert call(go()) == (429, "1")
    finally:
        torch_engine._batcher = None
    assert _post_json(rest_client, "/detect", {"image_base64": b64})[0] == 200


def test_api_detect_no_image_is_400(rest_client):
    assert _post_json(rest_client, "/detect", {})[0] == 400


def test_api_detect_batch(rest_client):
    images = [base64.b64encode(_jpeg_bytes(i)).decode() for i in range(2)]
    status, body = _post_json(rest_client, "/detect/batch", {"images_base64": images})
    assert status == 200
    assert len(body["results"]) == 2


def test_api_detect_batch_background_job(rest_client, pair):
    client, call = rest_client
    images = [base64.b64encode(_jpeg_bytes(i)).decode() for i in range(2)]
    status, body = _post_json(rest_client, "/detect/batch",
                              {"images_base64": images, "background": True})
    assert status == 200 and body["status"] == "processing"

    async def poll():
        resp = await client.get(f"/batch_results/{body['job_id']}")
        return await resp.json()

    for _ in range(200):
        done = call(poll())
        if done["status"] == "done":
            break
        time.sleep(0.05)
    assert done["status"] == "done" and len(done["results"]) == 2
    want = pair[1].infer(decode_jpeg(_jpeg_bytes(0), 64))
    assert done["results"][0]["classes"] == want.classes.tolist()


def test_api_health_and_metrics(rest_client):
    client, call = rest_client

    async def go():
        h = await client.get("/health")
        m = await client.get("/metrics")
        return h.status, await h.json(), m.status, await m.text()

    hs, hbody, ms, mtext = call(go())
    assert hs == 200 and hbody["status"] == "healthy" and hbody["model_loaded"]
    assert ms == 200 and "hvs_requests_total" in mtext


def test_api_models_endpoint(rest_client):
    client, call = rest_client

    async def go():
        resp = await client.get("/models")
        return resp.status, await resp.json()

    status, body = call(go())
    assert status == 200
    assert body["current"]["image_size"] == 64
    assert body["current"]["stability"]["max_ds_error"] < 1e-3


def test_api_model_switch_bad_path(rest_client):
    assert _post_json(rest_client, "/models/switch", {"checkpoint_path": "/nonexistent"})[0] == 400


def test_api_mjpeg_stream(rest_client):
    client, call = rest_client

    async def go():
        resp = await client.get("/stream/synthetic?max_frames=2")
        return resp.status, await resp.content.read()

    status, body = call(go())
    assert status == 200
    assert body.count(b"--frame") >= 2


def _same_detections(got, want, image_hw):
    """REST detection lists: classes exact, scores and pixel boxes within the
    end-to-end tolerance (the normalized atol scaled to pixels)."""
    assert len(got) == len(want) and len(want) > 0
    assert [d["class_id"] for d in got] == [d["class_id"] for d in want]
    assert [d["class_name"] for d in got] == [d["class_name"] for d in want]
    np.testing.assert_allclose([d["score"] for d in got], [d["score"] for d in want],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose([d["box"] for d in got], [d["box"] for d in want],
                               rtol=RTOL, atol=ATOL * max(image_hw))


def test_api_detect_matches_jax_response(rest_client, pair):
    """The port's /detect against the JAX server's response for the same
    image and weights: the same keys and types, classes, scores and boxes."""
    jax_engine, _ = pair
    blob = _jpeg_bytes(7)
    status, got = _post_json(rest_client, "/detect",
                             {"image_base64": base64.b64encode(blob).decode()})
    assert status == 200
    jax_server = JaxVisionAPIServer(jax_engine)
    try:
        want = jax_server._response_for(jax_engine.infer(jax_decode_jpeg(blob, 64)), "r")
    finally:
        jax_server.shutdown()
    assert set(got) == set(want)
    assert got["image_size"] == want["image_size"] == [64, 64]
    assert got["annotated_image_base64"] is None
    assert all(set(d) == set(want["detections"][0]) for d in got["detections"])
    _same_detections(got["detections"], want["detections"], (64, 64))


# ---------------- gRPC ----------------------------------------------------------


@pytest.fixture(scope="module")
def grpc_pair(pair):
    server = RobotGRPCServer(pair[1], host="127.0.0.1", port=0)
    port = server.start()
    client = RobotVisionClient(f"127.0.0.1:{port}")
    yield server, client
    client.close()
    server.stop()


def test_grpc_detect_single(grpc_pair):
    _, client = grpc_pair
    resp = client.detect(_jpeg_bytes(3), request_id="r1")
    assert resp.request_id == "r1"
    assert resp.image_height == 64 and resp.image_width == 64
    assert resp.error == ""


def test_grpc_detect_bad_image(grpc_pair):
    _, client = grpc_pair
    assert client.detect(b"not an image").error != ""


def test_grpc_detect_batch_stream(grpc_pair):
    _, client = grpc_pair
    assert len(list(client.detect_batch(iter([_jpeg_bytes(4), _jpeg_bytes(5)])))) == 2


def test_grpc_commands(grpc_pair):
    _, client = grpc_pair
    assert client.command("ping").message == "pong"
    status = client.command("get_status")
    assert status.success and "requests_served" in status.data
    assert not client.command("nonsense").success


def test_grpc_update_config_rebuilds_serve_fns(grpc_pair, pair):
    _, client = grpc_pair
    torch_engine = pair[1]
    pp = torch_engine.config.postprocessing
    before = pp.score_threshold
    try:
        resp = client.command("update_config", score_threshold=0.9)
        assert resp.success and pp.score_threshold == 0.9
        assert torch_engine.replays == {}  # every serve function dropped
        det = torch_engine.infer(decode_jpeg(_jpeg_bytes(7), 64))
        assert len(det) == 0 or det.scores.min() >= 0.9
    finally:
        pp.score_threshold = before
        torch_engine.rebuild_serve_fns()


def test_grpc_detect_matches_jax_service(grpc_pair, pair):
    """DetectSingle of the port's live server against the JAX service's
    ``_detect`` on the same bytes, message field by field; a JAX client
    message parses as the port's (one wire schema)."""
    import robot_vision_pb2 as jax_pb  # registered by hvs_tpu.deployment

    _, client = grpc_pair
    blob = _jpeg_bytes(7)
    got = client.detect(blob, request_id="q")
    want = JaxRobotVisionService(pair[0])._detect(jax_pb.DetectRequest(image=blob, request_id="q"))
    assert pb.DetectResponse.FromString(want.SerializeToString()).request_id == "q"
    assert (got.request_id, got.image_height, got.image_width, got.error) == \
        (want.request_id, want.image_height, want.image_width, want.error)
    assert len(got.detections) == len(want.detections) > 0
    assert [d.class_id for d in got.detections] == [d.class_id for d in want.detections]
    assert [d.class_name for d in got.detections] == [d.class_name for d in want.detections]
    fields = ("x1", "y1", "x2", "y2")
    np.testing.assert_allclose([[getattr(d, f) for f in fields] for d in got.detections],
                               [[getattr(d, f) for f in fields] for d in want.detections],
                               rtol=RTOL, atol=ATOL * 64)
    np.testing.assert_allclose([d.score for d in got.detections],
                               [d.score for d in want.detections], rtol=RTOL, atol=ATOL)


# ---------------- original pixels on a large JPEG ------------------------------


def test_large_jpeg_boxes_in_original_pixels(rest_client, grpc_pair, pair):
    """A 201x301 JPEG at a 64 letterbox is decoded at half size (101x151,
    each side rounded up). The reference answers in those reduced pixels;
    the port maps boxes and image size back to 201x301, per axis, on every
    route: /detect, /detect/batch and DetectSingle."""
    jax_engine, torch_engine = pair
    blob = _smooth_jpeg(11, 201, 301)
    reduced = decode_jpeg(blob, 64)
    assert reduced.shape[:2] == (101, 151)
    want = torch_engine.infer(reduced)
    assert len(want) > 0
    scale = np.array([301 / 151, 201 / 101, 301 / 151, 201 / 101], np.float32)
    want_boxes = want.boxes * scale

    status, body = _post_json(rest_client, "/detect",
                              {"image_base64": base64.b64encode(blob).decode()})
    assert status == 200 and body["image_size"] == [201, 301]
    np.testing.assert_allclose([d["box"] for d in body["detections"]], want_boxes, rtol=1e-6)
    boxes = np.array([d["box"] for d in body["detections"]])
    assert boxes[:, [0, 2]].max() <= 301 and boxes[:, [1, 3]].max() <= 201
    assert boxes[:, [0, 2]].max() > 151 or boxes[:, [1, 3]].max() > 101

    status, batch = _post_json(rest_client, "/detect/batch",
                               {"images_base64": [base64.b64encode(blob).decode()]})
    assert status == 200 and batch["results"][0]["image_size"] == [201, 301]
    np.testing.assert_allclose([d["box"] for d in batch["results"][0]["detections"]],
                               want_boxes, rtol=1e-6)

    resp = grpc_pair[1].detect(blob)
    assert (resp.image_height, resp.image_width) == (201, 301)
    np.testing.assert_allclose([[d.x1, d.y1, d.x2, d.y2] for d in resp.detections], want_boxes,
                               rtol=1e-6)

    # The reference, on the same bytes: the reduced image's pixels.
    jax_server = JaxVisionAPIServer(jax_engine)
    try:
        ref = jax_server._response_for(jax_engine.infer(jax_decode_jpeg(blob, 64)), "r")
    finally:
        jax_server.shutdown()
    assert ref["image_size"] == [101, 151]


def test_source_hw_reads_the_jpeg_header():
    from hvs_tpu_torch.deployment.service import source_hw

    for h, w, k in ((64, 64, 1), (129, 200, 2), (257, 515, 4), (700, 1030, 8)):
        blob = _jpeg_bytes(0, h, w)
        image = decode_jpeg(blob, 64)
        assert image.shape[:2] == (-(-h // k), -(-w // k))
        assert source_hw(blob, image) == (h, w)
    png = cv2.imencode(".png", np.zeros((300, 200, 3), np.uint8))[1].tobytes()
    assert source_hw(png, decode_jpeg(png, 64)) == (300, 200)


# ---------------- export --------------------------------------------------------


def test_export_weights_and_reload(pair, tmp_path):
    torch_engine = pair[1]
    path = ModelExporter(torch_engine.model, image_size=64).export_weights(
        str(tmp_path / "weights.pt"))
    loaded = torch_engine.load_checkpoint(path)
    assert "params" in loaded
    named = dict(torch_engine.model.named_parameters())
    assert set(loaded["params"]) == set(named)
    for name, value in loaded["params"].items():
        assert torch.equal(value, named[name].detach().cpu())


@pytest.fixture(scope="module")
def program(pair, tmp_path_factory):
    """The port engine's serve function exported once: (exporter, .pt2 path)."""
    exporter = ModelExporter(pair[1].model, image_size=64)
    return exporter, exporter.export_program(str(tmp_path_factory.mktemp("pt2") / "model.pt2"))


def test_export_program_consistency(program):
    exporter, path = program
    report = exporter.consistency_check(path)
    assert report["consistent"], report


def test_export_program_matches_jax_stablehlo(pair, program, tmp_path):
    """The port's loaded ``.pt2`` against the program JAX's
    ``export_stablehlo`` writes, on the same seeded uint8 batch."""
    exporter, path = program
    jax_engine = pair[0]
    jax_exporter = JaxModelExporter(jax_engine.model, jax_engine.variables, image_size=64)
    jax_path = jax_exporter.export_stablehlo(str(tmp_path / "model.stablehlo"))
    x = np.random.default_rng(0).integers(0, 255, (1, 64, 64, 3), np.uint8)
    want = [np.asarray(a) for a in jax_exporter.load_stablehlo(jax_path).call(jnp.asarray(x))]
    with torch.no_grad():
        got = [t.numpy() for t in exporter.load_program(path)(torch.from_numpy(x))]
    valid = want[1] >= 0
    assert valid.sum() >= 2
    np.testing.assert_array_equal(got[1] >= 0, valid)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0][valid], want[0][valid], rtol=RTOL, atol=ATOL)


def test_serving_manifest(pair, tmp_path):
    mgr = ModelServerManager(pair[1], ServingModelConfig(image_size=64))
    mgr.build_repository(str(tmp_path / "repo"))
    manifest = json.loads((tmp_path / "repo" / "hybrid_vision" / "manifest.json").read_text())
    assert manifest["input"]["shape"] == [-1, 64, 64, 3]
    assert (tmp_path / "repo" / "hybrid_vision" / "1" / "weights.pt").exists()


@pytest.mark.parametrize("fields", [{}, {"image_size": 416, "batch_buckets": (1, 4, 16)},
                                    {"name": "robot", "max_queue_delay_ms": 2.5,
                                     "precision": "fp32"}])
def test_manifest_and_config_pbtxt_equal_jax(fields):
    port, ref = ServingModelConfig(**fields), JaxServingModelConfig(**fields)
    assert port.to_manifest() == ref.to_manifest()
    assert _config_pbtxt(port) == jax_config_pbtxt(ref)


# ---------------- health --------------------------------------------------------


def test_health_checker_rollup(pair):
    hc = HealthChecker(engine=pair[1])
    report = hc.run_checks()
    assert report["status"] in ("healthy", "warning", "critical")
    names = {c["name"] for c in report["checks"]}
    assert {"model_loaded", "device", "cpu", "memory", "disk"} <= names
    checks = {c["name"]: c for c in report["checks"]}
    assert checks["model_loaded"]["status"] == "healthy"
    assert checks["device"]["status"] == "healthy"  # the CPU reports no memory
    assert "overall" in hc.format_report(report)


def test_health_api_checker_unreachable():
    results = APIChecker("http://127.0.0.1:1").check()  # nothing listens there
    assert all(r.status == HealthStatus.CRITICAL for r in results)


def test_health_monitoring_thread(pair):
    hc = HealthChecker(engine=pair[1])
    reports = []
    hc.start_monitoring(interval_s=0.1, on_report=reports.append)
    time.sleep(0.35)
    hc.stop_monitoring()
    assert len(reports) >= 2
    assert len(hc.history) >= 2


def test_health_reads_latency_and_error_rate(pair):
    from hvs_tpu_torch.deployment.health_check import ModelHealthChecker

    torch_engine = pair[1]
    torch_engine.infer(decode_jpeg(_jpeg_bytes(2), 64))
    results = {r.name: r for r in ModelHealthChecker(torch_engine).check()}
    assert results["latency"].status == HealthStatus.HEALTHY
    assert results["error_rate"].status == HealthStatus.HEALTHY
    assert results["device"].data == {"memory_fraction": 0.0}


# ---------------- model repository + admission gates ---------------------------

GOOD = {"map_50": 0.9, "latency_ms": 8.0, "precision": 0.95, "recall": 0.9,
        "ds_error": 1e-4, "max_eigenvalue": 0.99}


def test_registry_gate_thresholds():
    gate = RegistryGate(REGISTRY)
    ok, why = gate.admit(dict(GOOD, latency_ms=10))
    assert ok, why
    bad, why = gate.admit({"map_50": 0.5, "latency_ms": 10})
    assert not bad
    assert any("min_map_50" in r for r in why)
    slow_, why = gate.admit({"map_50": 0.9, "latency_ms": 500})
    assert not slow_
    assert any("max_latency_ms" in r for r in why)


@pytest.mark.parametrize("metrics", [
    GOOD, dict(GOOD, map_50=0.4), dict(GOOD, latency_ms=80.0, recall=0.1),
    dict(GOOD, ds_error=2e-3, max_eigenvalue=1.5), {"map_50": 0.75, "latency_ms": 50},
    {"precision": 0.79999}, {},
])
def test_registry_gate_decisions_equal_jax(metrics):
    for registry in (REGISTRY, None):
        port, ref = RegistryGate(registry), JaxRegistryGate(registry)
        assert port.gates == ref.gates and port.keep_last == ref.keep_last
        assert port.admit(metrics) == ref.admit(metrics)
    assert RegistryGate(gates={"min_map_50": 0.95}).admit(GOOD) == \
        JaxRegistryGate(gates={"min_map_50": 0.95}).admit(GOOD)


def test_repository_versioning_and_gated_load(pair, tmp_path):
    root = str(tmp_path / "repo")
    mgr = ModelServerManager(pair[1], ServingModelConfig(image_size=64),
                             gate=RegistryGate(REGISTRY))
    r1 = mgr.build_repository(root, version=1, metrics=GOOD)
    assert r1["admitted"], r1
    r2 = mgr.build_repository(root, version=2, metrics=dict(GOOD, map_50=0.4))
    assert not r2["admitted"]
    assert any("min_map_50" in f for f in r2["failures"])
    assert not (tmp_path / "repo" / "hybrid_vision" / "2" / "ADMITTED").exists()
    pbtxt = (tmp_path / "repo" / "hybrid_vision" / "config.pbtxt").read_text()
    assert "dynamic_batching" in pbtxt and "preferred_batch_size" in pbtxt
    assert ModelServerManager.latest_admitted(root, "hybrid_vision") == 1
    assert mgr.load_from_repository(root) == 1
    with pytest.raises(RuntimeError, match="not admitted"):
        mgr.load_from_repository(root, version=2)


def test_repository_keeps_last_versions_and_swaps_weights(pair, tmp_path):
    """Versions past ``keep_last`` are pruned; loading a version swaps its
    weights into the live engine (and back)."""
    torch_engine = pair[1]
    root = str(tmp_path / "repo")
    gate = RegistryGate(gates={})
    gate.keep_last = 2
    mgr = ModelServerManager(torch_engine, ServingModelConfig(image_size=64), gate=gate)
    for v in (1, 2, 3):
        mgr.build_repository(root, version=v, metrics=GOOD)
    assert sorted(os.listdir(os.path.join(root, "hybrid_vision"))) == \
        ["2", "3", "config.pbtxt", "manifest.json"]
    frame = decode_jpeg(_jpeg_bytes(7), 64)
    before = torch_engine.infer(frame)
    path = os.path.join(root, "hybrid_vision", "3", "weights.pt")
    original = torch.load(path)
    scaled = {k: v * 1.5 if k.endswith("predict.bias") else v
              for k, v in original["params"].items()}
    torch.save({"params": scaled}, path)
    try:
        assert mgr.load_from_repository(root) == 3
        swapped = torch_engine.infer(frame)
        assert len(swapped) != len(before) or not np.allclose(swapped.scores, before.scores)
    finally:
        torch_engine.reload(original)
    again = torch_engine.infer(frame)
    np.testing.assert_array_equal(again.classes, before.classes)
    np.testing.assert_allclose(again.scores, before.scores, rtol=0, atol=0)


# ---------------- frameworks absent --------------------------------------------


def test_deployment_imports_without_frameworks():
    """With aiohttp, grpc, pydantic, cv2, psutil and prometheus_client blocked
    (and protobuf), the package and its framework-free modules import and a
    tiny engine's request, export and health path runs; the servers raise
    ImportError instead of falling back."""
    code = (
        "import sys\n"
        "for m in ('aiohttp', 'grpc', 'google.protobuf', 'pydantic', 'cv2', 'psutil',\n"
        "          'prometheus_client'):\n"
        "    sys.modules[m] = None\n"
        "import hvs_tpu_torch.deployment as d\n"
        "from hvs_tpu_torch.deployment import service, model_server, health_check\n"
        "assert d.ModelExporter is model_server.ModelExporter\n"
        "assert d.HealthChecker is health_check.HealthChecker\n"
        "report = d.HealthChecker().run_checks()\n"
        "assert report['status'] == 'critical', report\n"
        "for name in ('VisionAPIServer', 'RobotGRPCServer'):\n"
        "    try:\n"
        "        getattr(d, name)\n"
        "    except ImportError:\n"
        "        pass\n"
        "    else:\n"
        "        raise SystemExit(name + ' imported without its framework')\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'hvs_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_proto_copy_is_byte_identical():
    for name in ("robot_vision.proto", "robot_vision_pb2.py"):
        with open(os.path.join(REPO, "hvs_tpu", "deployment", "proto", name), "rb") as f:
            ref = f.read()
        with open(os.path.join(REPO, "hvs_tpu_torch", "deployment", "proto", name), "rb") as f:
            assert f.read() == ref, name
