"""``python -m hvs_tpu_torch.accuracy_sweep`` on the CPU against
``scripts/accuracy_sweep.py`` on a 64² shapes set at 32² and 64².

Both scripts build their real engines (the tiny model, 8 classes, on the
same weights: an orbax checkpoint for JAX's, the port's conversion of it
for the port's) and time batch 16 through them; the detections both loops
score come from one function shared by the two engines (``infer``
overridden): each image's ground truth, moved by a few pixels that grow
as the resolution falls, some relabelled, plus a false positive, so that
AP is neither 0 nor 1 and differs between the resolutions. Every AP entry
within 2e-3, the same report keys, the same ``trained_steps`` from the
run's ``chunks.jsonl``.
"""

import functools
import hashlib
import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from hvs_tpu.config import ModelConfig as JaxModelConfig
from hvs_tpu.inference import InferenceEngine as JaxEngine
from hvs_tpu_torch import accuracy_sweep, make_shapes_dataset
from hvs_tpu_torch.config import ModelConfig as PortModelConfig
from hvs_tpu_torch.data import load_image
from hvs_tpu_torch.inference import InferenceEngine as PortEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AP_ATOL = 2e-3
CLASSES = 8
STEPS = 123


def _tiny(cfg):
    cfg.backbone.stage_channels = (16, 24, 32, 40)
    cfg.backbone.stage_blocks = (1, 1, 1, 1)
    cfg.vit.dim, cfg.vit.depth, cfg.vit.num_heads = 16, 1, 2
    cfg.fusion.fpn_channels = 16
    cfg.detection.head_channels = 16
    cfg.mhc.sinkhorn_iterations = 5
    cfg.detection.num_classes = CLASSES
    return cfg


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _key(bgr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(bgr).tobytes()).hexdigest()


def _shared_detections(root: str):
    """``detect(bgr_frame, resolution)`` for the val split under ``root``:
    the frame's ground truth moved by up to 128 / resolution pixels, every
    third box relabelled, scores spread, and one false positive."""
    with open(os.path.join(root, "annotations", "instances_val.json")) as f:
        coco = json.load(f)
    ids = {c["id"]: i for i, c in enumerate(sorted(coco["categories"], key=lambda c: c["id"]))}
    truth = {}
    for n, im in enumerate(coco["images"]):
        rgb = load_image(os.path.join(root, "val", im["file_name"]))
        anns = [a for a in coco["annotations"] if a["image_id"] == im["id"]]
        boxes = np.asarray([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                             a["bbox"][1] + a["bbox"][3]] for a in anns], np.float32)
        truth[_key(rgb[..., ::-1])] = (n, boxes.reshape(-1, 4),
                                       np.asarray([ids[a["category_id"]] for a in anns]))

    def detect(bgr, resolution):
        n, boxes, classes = truth[_key(bgr)]
        r = np.random.default_rng(n)
        shift = r.uniform(-1, 1, boxes.shape) * 128.0 / resolution
        out = np.concatenate([boxes + shift, [[1.0, 1.0, 9.0, 9.0]]]).astype(np.float32)
        cls = np.concatenate([classes, [n % CLASSES]])
        cls[::3] = (cls[::3] + 1) % CLASSES
        scores = r.uniform(0.3, 1.0, len(out)).astype(np.float32)
        return SimpleNamespace(boxes=out, scores=scores, classes=cls.astype(np.int64))

    return detect


@pytest.fixture(scope="module")
def sweep_data(tmp_path_factory):
    """The shapes set (64², 8 val images), the tiny 8-class weights as an
    orbax checkpoint at ``run/checkpoints/final`` and the port's at
    ``final.pt`` beside it, and the run's ``chunks.jsonl``."""
    tmp = tmp_path_factory.mktemp("sweep")
    root = str(tmp / "shapes64")
    make_shapes_dataset.main(["--root", root, "--train", "1", "--val", "8", "--size", "64"])
    model = _tiny(JaxModelConfig()).build_model(production=True)
    v = jax.jit(functools.partial(model.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(v["params"]))
    ckpt = str(tmp / "run" / "checkpoints" / "final")
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(ckpt, {"params": params})
    tool = _load("scripts/torch_import_checkpoint.py", "_import_tool_sweep")
    pm = _tiny(PortModelConfig(device="cpu"))
    pm.precision = "fp32"
    torch.save(tool.convert({"params": params}, pm), ckpt + ".pt")
    with open(tmp / "run" / "chunks.jsonl", "w") as f:
        f.write(json.dumps({"step": STEPS // 2}) + "\n" + json.dumps({"step": STEPS}) + "\n")
    return root, ckpt, str(tmp)


def _close(got, want, where=""):
    """``got`` against ``want``: the same keys throughout, numbers within
    ``AP_ATOL``."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert abs(got - want) <= AP_ATOL, (where, got, want)
    else:
        assert got == want, (where, got, want)


def test_accuracy_sweep_matches_the_jax_script(sweep_data, monkeypatch, capsys):
    """The port's sweep against the JAX script's on the same set, weights
    and detections: every AP entry within 2e-3 at both resolutions, the
    same keys, headline, criteria and ``trained_steps``; AP neither 0 nor 1
    and not the same at both resolutions."""
    root, ckpt, tmp = sweep_data
    detect = _shared_detections(root)

    class JaxStub(JaxEngine):
        def infer(self, image):
            return detect(image, self.config.preprocessing.image_size)

    class PortStub(PortEngine):
        def infer(self, image):
            return detect(image, self.config.preprocessing.image_size)

    monkeypatch.setattr("hvs_tpu.utils.enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr("hvs_tpu.config.ModelConfig", lambda: _tiny(JaxModelConfig()))
    monkeypatch.setattr("hvs_tpu.inference.InferenceEngine", JaxStub)
    monkeypatch.setattr("hvs_tpu_torch.config.ModelConfig",
                        lambda device="auto": _tiny(PortModelConfig(device=device)))
    monkeypatch.setattr("hvs_tpu_torch.inference.InferenceEngine", PortStub)
    monkeypatch.setattr(accuracy_sweep, "FPS_ITERS", 2)
    args = ["--checkpoint", ckpt, "--data-root", root, "--resolutions", "32,64"]
    monkeypatch.setattr(sys, "argv", ["accuracy_sweep.py", *args,
                                      "--output", f"{tmp}/jax.json"])
    _load("scripts/accuracy_sweep.py", "_jax_accuracy_sweep").main()
    got = accuracy_sweep.main([*args, "--device", "cpu", "--output", f"{tmp}/port.json"])
    launches = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert launches["graphs"] == 2 and launches["replays"] >= 2 * accuracy_sweep.FPS_ITERS
    with open(f"{tmp}/jax.json") as f:
        want = json.load(f)
    with open(f"{tmp}/port.json") as f:
        assert json.load(f) == got
    assert set(got) == set(want) == {"benchmark", "checkpoint", "trained_steps", "headline",
                                     "resolution_sweep", "criteria", "reference"}
    assert got["trained_steps"] == want["trained_steps"] == STEPS
    assert got["criteria"] == want["criteria"] and got["reference"] == want["reference"]
    assert "python -m hvs_tpu_torch.make_shapes_dataset" in got["benchmark"]
    _close(got["headline"], want["headline"])
    for res in ("32", "64"):
        w, g = want["resolution_sweep"][res], got["resolution_sweep"][res]
        assert set(g) == set(w)
        assert g.pop("eval_seconds") >= 0 and w.pop("eval_seconds") >= 0
        for k in ("fps_per_chip_batch16", "batch16_ms"):
            assert g.pop(k) > 0 and w.pop(k) > 0
        _close(g, w, res)
        assert 0 < g["mAP@0.5"] < 1 and g["num_images"] == 8
    assert got["resolution_sweep"]["32"]["mAP@[.5:.95]"] != \
        got["resolution_sweep"]["64"]["mAP@[.5:.95]"]


def test_accuracy_sweep_reads_trained_steps_from_the_run(tmp_path):
    """``trained_steps`` is the last ``chunks.jsonl`` row's step of the
    checkpoint's run directory, else None, as the JAX script reads it."""
    run = tmp_path / "run"
    os.makedirs(run / "checkpoints")
    assert accuracy_sweep.trained_steps_of(str(run / "checkpoints" / "best")) is None
    with open(run / "chunks.jsonl", "w") as f:
        f.write('{"step": 100}\n{"step": 6000, "val_loss": 1.0}\n')
    assert accuracy_sweep.trained_steps_of(str(run / "checkpoints" / "best/")) == 6000
