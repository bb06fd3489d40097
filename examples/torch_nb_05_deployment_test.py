# %% [markdown]
# # 05 — Deployment test (PyTorch/CUDA port)
#
# The port's counterpart of `examples/nb_05_deployment_test.py`: stand the
# REST API up in-process, drive its endpoints over real HTTP, export the
# serve function (`torch.export`, a `.pt2` program, where the JAX package
# writes StableHLO), build a versioned serving repository with admission
# gates, and run the health-check rollup. On the card the engine's graphs
# and the exported program run kernel A at every fused mHC site.
#
#     python examples/torch_nb_05_deployment_test.py [--device cpu]
#
# `HVS_NB_TINY=1` serves tiny widths at 64²; files go to `$HVS_NB_OUT`
# (default `outputs/torch_nb05`); the server listens on `$HVS_NB_PORT`
# (default: a free port). The last line of standard output is one JSON
# object with the tour's numbers; the kernels' launch counters go to
# standard error as one `{"kernel_launches": ...}` line.

# %%
import argparse
import base64
import json
import os
import sys
import threading
import time

# Works as a script (repo/examples/) AND inside a notebook kernel
# (cwd = repo root, no __file__).
sys.path.insert(
    0,
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if "__file__" in globals() else os.getcwd(),
)

import numpy as np

from hvs_tpu_torch import resolve_device
from hvs_tpu_torch.training.chunk import kernel_counts

_parser = argparse.ArgumentParser()
_parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
DEVICE = resolve_device(_parser.parse_known_args()[0].device)
TINY = bool(int(os.environ.get("HVS_NB_TINY", "0")))
OUT = os.environ.get("HVS_NB_OUT", "outputs/torch_nb05")
os.makedirs(OUT, exist_ok=True)
PORT = int(os.environ.get("HVS_NB_PORT", "0"))
print("device:", DEVICE)

# %% [markdown]
# ## Engine + API server (aiohttp) in a background thread

# %%
import asyncio

from aiohttp import web

from hvs_tpu_torch.config import InferenceConfig, ModelConfig
from hvs_tpu_torch.deployment import VisionAPIServer
from hvs_tpu_torch.inference import InferenceEngine

mcfg = ModelConfig(device=DEVICE.type)
icfg = InferenceConfig(device=DEVICE.type)
icfg.postprocessing.score_threshold = 0.01
if TINY:
    mcfg.backbone.stage_channels = (16, 24, 32, 40)
    mcfg.backbone.stage_blocks = (1, 1, 1, 1)
    mcfg.vit.dim = 16
    mcfg.vit.depth = 1
    mcfg.vit.num_heads = 2
    mcfg.fusion.fpn_channels = 16
    mcfg.detection.head_channels = 16
    mcfg.mhc.sinkhorn_iterations = 5
    icfg.preprocessing.image_size = 64
    icfg.performance.batch_buckets = (1, 2)

engine = InferenceEngine(mcfg, icfg)
engine.warmup()

server = VisionAPIServer(engine, results_dir=os.path.join(OUT, "batch_results"))
loop = asyncio.new_event_loop()
runner = web.AppRunner(server.app)
bound = []


def _serve():
    asyncio.set_event_loop(loop)
    try:
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", PORT)
        loop.run_until_complete(site.start())
        bound.append(site._server.sockets[0].getsockname()[1])
    except Exception as e:  # reported below, on the main thread
        bound.append(e)
        return
    loop.run_forever()


t = threading.Thread(target=_serve, daemon=True)
t.start()
for _ in range(6000):
    if bound:
        break
    time.sleep(0.05)
if not bound or isinstance(bound[0], Exception):
    raise RuntimeError(f"the API server did not start: {bound}")
BASE = f"http://127.0.0.1:{bound[0]}"
print(f"API serving on {BASE}")

# %% [markdown]
# ## Drive the endpoints over real HTTP

# %%
import urllib.error
import urllib.request

import cv2


def call(path, payload=None):
    """(status, body) of a GET, or of a POST of ``payload`` as JSON."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"{BASE}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body.decode(errors="replace")


frame = np.random.default_rng(0).integers(0, 255, (120, 160, 3), np.uint8)
ok, enc = cv2.imencode(".jpg", frame)
b64 = base64.b64encode(enc.tobytes()).decode()

endpoints = {}
responses = {}
for path, payload in (("/health", None), ("/ping", None),
                      ("/detect", {"image_base64": b64}),
                      ("/invocations", {"image_base64": b64}),
                      ("/detect/batch", {"images_base64": [b64, b64]}),
                      ("/models", None), ("/metrics", None)):
    key = path if payload is None else f"POST {path}"
    endpoints[key], responses[key] = call(path, payload)
    print(f"{key}: {endpoints[key]}")
health = responses["/health"]
det = responses["POST /detect"]
print("health:", health["status"])
print(f"detections: {len(det['detections'])}, latency {det['latency_ms']:.1f} ms")

# %% [markdown]
# ## Export: the serve function as a `.pt2` program, with a consistency check

# %%
from hvs_tpu_torch.deployment import ModelExporter

exporter = ModelExporter(engine.model, image_size=icfg.preprocessing.image_size)
pt2_path = exporter.export_program(os.path.join(OUT, "model.pt2"))
consistency = exporter.consistency_check(pt2_path)
print("exported:", pt2_path)
print("consistency:", consistency)

# %% [markdown]
# ## Versioned serving repository with admission gates
#
# `build_repository` lays out `<root>/<name>/<version>/` with a
# `config.pbtxt`-style descriptor; `RegistryGate` enforces the
# model-registry thresholds (min mAP / max latency / precision / recall)
# before a version can be admitted.

# %%
from hvs_tpu_torch.deployment import ModelServerManager, RegistryGate, ServingModelConfig

gate = RegistryGate()
good = {"map_50": 0.92, "latency_ms": 9.0, "precision": 0.93, "recall": 0.88}
bad = {"map_50": 0.41, "latency_ms": 9.0, "precision": 0.93, "recall": 0.88}
good_admitted, _ = gate.admit(good)
bad_admitted, bad_reasons = gate.admit(bad)
print("good model admitted:", good_admitted)
print("bad model admitted: ", bad_admitted, bad_reasons)

mgr = ModelServerManager(engine, ServingModelConfig(name="hvs_demo"), gate=gate)
repo_root = os.path.join(OUT, "model_repository")
result = mgr.build_repository(repo_root, version=1, metrics=good)
refused = mgr.build_repository(repo_root, version=2, metrics=bad)
latest = ModelServerManager.latest_admitted(repo_root, "hvs_demo")
print("version 1 admitted:", result["admitted"], " version 2 admitted:", refused["admitted"])
print("latest admitted version:", latest)
for dirpath, _, files in os.walk(repo_root):
    for f in files:
        print("  ", os.path.relpath(os.path.join(dirpath, f), repo_root))

# %% [markdown]
# ## Health-check rollup (model / device / latency / API probes)

# %%
from hvs_tpu_torch.deployment import HealthChecker

checker = HealthChecker(engine, api_url=BASE)
report = checker.run_checks()
for check in report["checks"]:
    print(f"{check['name']:>16}: {check['status']}  {check['message'][:60]}")
print("overall:", report["status"])

# %%
asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(timeout=60)
loop.call_soon_threadsafe(loop.stop)
t.join(timeout=10)
server.shutdown()
print("done")

print(json.dumps({"kernel_launches": kernel_counts()}), file=sys.stderr, flush=True)
print(json.dumps({
    "tour": "nb_05", "device": str(DEVICE), "image_size": engine.image_size,
    "endpoints": endpoints, "health": health["status"],
    "detections": len(det["detections"]), "detect_latency_ms": det["latency_ms"],
    "export": consistency, "gate": {"good": good_admitted, "bad": bad_admitted},
    "repository": {"v1_admitted": result["admitted"], "v2_admitted": refused["admitted"],
                   "latest_admitted": latest},
    "health_rollup": report["status"],
    "health_checks": {c["name"]: c["status"] for c in report["checks"]},
}), flush=True)
