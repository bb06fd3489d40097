"""The port's evaluation layer (``utils/metrics.py``: ``DetectionEvaluator``,
``StabilityMetrics``; ``python -m hvs_tpu_torch.evaluate``) against the JAX
package's and ``scripts/evaluate.py``, on the CPU; and the slice end to end:
a generated dataset on disk feeding the three trainers and the evaluator.

The evaluators are the same numpy code on the same inputs, held to 1e-12.
The evaluation loop is held against the JAX script with both engines
replaced by one stub that answers each frame from its ground truth (or from
shifted, thinned ground truth), so the reports must be equal key for key.
"""

import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import hvs_tpu.inference
import hvs_tpu.utils
import hvs_tpu_torch.inference
from hvs_tpu.utils.metrics import DetectionEvaluator as JaxEvaluator
from hvs_tpu.utils.metrics import StabilityMetrics as JaxStability
from hvs_tpu_torch import evaluate as port_eval
from hvs_tpu_torch.data import generate_shapes_dataset
from hvs_tpu_torch.utils import DetectionEvaluator, StabilityMetrics

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_evaluate_script",
                                                  os.path.join(REPO, "scripts", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close_results(got, want, tol=1e-12):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert set(g) == set(w), k
            for c in w:
                assert abs(g[c] - w[c]) <= tol, (k, c)
        else:
            assert abs(g - w) <= tol, (k, g, w)


def _random_records(seed, n_images=12, num_classes=5):
    """Ground truth in every size bucket (boxes of 8-200 px in a 640 frame);
    predictions that hit (jittered), miss (absent) or are false positives
    (random boxes, wrong classes), with tied and distinct scores."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_images):
        n = int(r.integers(0, 7))
        wh = np.exp(r.uniform(np.log(8), np.log(200), (n, 2)))
        xy = r.uniform(0, 640 - wh)
        gt = np.concatenate([xy, xy + wh], 1)
        cls = r.integers(0, num_classes, n)
        keep = r.uniform(size=n) > 0.25
        pb = gt[keep] + r.normal(0, 0.08, (keep.sum(), 1)) * np.tile(wh[keep], 2)
        pc = cls[keep].copy()
        n_fp = int(r.integers(0, 4))
        fp_xy = r.uniform(0, 560, (n_fp, 2))
        pb = np.concatenate([pb, np.concatenate([fp_xy, fp_xy + r.uniform(5, 80, (n_fp, 2))],
                                                1)])
        pc = np.concatenate([pc, r.integers(0, num_classes, n_fp)])
        ps = np.round(r.uniform(0.05, 1.0, len(pb)), 1)  # ties
        out.append((pb, ps, pc, gt, cls))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_detection_evaluator_matches_jax(seed):
    records = _random_records(seed)
    got_ev, want_ev = DetectionEvaluator(num_classes=5), JaxEvaluator(num_classes=5)
    for rec in records:
        got_ev.add_image(*rec)
        want_ev.add_image(*rec)
    got, want = got_ev.evaluate(), want_ev.evaluate()
    _close_results(got, want)
    assert want["AP@0.5_small"] >= 0 and want["AP@0.5_medium"] >= 0 \
        and want["AP@0.5_large"] >= 0  # every bucket holds ground truth
    assert 0 < want["mAP@0.5"] < 1 and len(want["per_class_AP@0.5"]) == 5
    for cls in range(5):
        for t in (0.5, 0.75):
            for area in ("all", "small", "medium", "large"):
                assert got_ev._class_ap(cls, t, area) == want_ev._class_ap(cls, t, area)
    got_ev.reset()
    assert got_ev.evaluate()["mAP@0.5"] == 0.0 and got_ev.records == []


def test_detection_evaluator_thresholds_and_edge_cases_match_jax():
    for kw in (dict(iou_thresholds=[0.3, 0.6]), {}):
        got_ev, want_ev = DetectionEvaluator(num_classes=3, **kw), JaxEvaluator(num_classes=3,
                                                                                 **kw)
        cases = [  # no predictions; no ground truth; a perfect hit
            (np.zeros((0, 4)), [], [], [[0, 0, 10, 10]], [0]),
            ([[5, 5, 50, 50]], [0.9], [1], np.zeros((0, 4)), []),
            ([[1, 1, 40, 40]], [0.8], [2], [[1, 1, 40, 40]], [2]),
        ]
        for c in cases:
            got_ev.add_image(*c)
            want_ev.add_image(*c)
        _close_results(got_ev.evaluate(), want_ev.evaluate())
    assert DetectionEvaluator.AREA_RANGES == JaxEvaluator.AREA_RANGES


@pytest.mark.parametrize("seed", [0, 1])
def test_stability_metrics_match_jax(seed):
    r = np.random.default_rng(seed)
    got, want = StabilityMetrics(window=16), JaxStability(window=16)
    assert got.report() == want.report()
    for i in range(40):
        m = {"grad_norm": float(r.lognormal(3, 0.5)), "max_eigenvalue": float(r.uniform(0.9, 1.6)),
             "ds_error_max": float(r.uniform(0, 0.08)),
             "signal_ratio_mean": float(r.lognormal(0, 0.8)),
             "loss": float("nan") if i % 9 == 4 else float(r.uniform())}
        got.update(m)
        want.update(m)
        assert got.report() == want.report()
    assert {k: list(v) for k, v in got.history.items()} == \
        {k: list(v) for k, v in want.history.items()}


# ---------------------------------------------------------------------------
# The evaluation loop against scripts/evaluate.py


def _ground_truth_by_file(root, split):
    data = json.loads(open(os.path.join(root, "annotations", f"instances_{split}.json")).read())
    remap = {c["id"]: i for i, c in enumerate(sorted(data["categories"], key=lambda c: c["id"]))}
    out = {}
    for im in data["images"]:
        anns = [a for a in data["annotations"] if a["image_id"] == im["id"]]
        boxes = np.asarray([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                             a["bbox"][1] + a["bbox"][3]] for a in anns], np.float32)
        out[im["file_name"]] = (boxes.reshape(-1, 4),
                                np.asarray([remap[a["category_id"]] for a in anns]))
    return out


def _stub_engine(root, split, shifted):
    """An engine that answers each frame (checked to be the file's BGR
    pixels) with its ground truth; ``shifted`` moves each box by 3 px, drops
    every third and adds a false positive."""
    truth = _ground_truth_by_file(root, split)
    names = sorted(truth)
    frames = {n: cv2.imread(os.path.join(root, split, n)) for n in names}

    class StubEngine:
        def __init__(self, model_config, inference_config, *args, **kwargs):
            self.calls = 0

        def infer(self, image):
            name = names[self.calls]
            self.calls += 1
            assert np.array_equal(np.ascontiguousarray(image), frames[name]), name
            boxes, classes = truth[name]
            scores = np.linspace(0.9, 0.3, len(boxes)).astype(np.float32)
            if shifted:
                keep = np.arange(len(boxes)) % 3 != 2
                boxes = np.concatenate([boxes[keep] + 3.0, [[1, 1, 30, 30]]]).astype(np.float32)
                classes = np.concatenate([classes[keep], [1]])
                scores = np.concatenate([scores[keep], [0.95]]).astype(np.float32)
            return SimpleNamespace(boxes=boxes, scores=scores, classes=classes)

        def get_performance_stats(self):
            return {"fps": 2.5, "p95_latency_ms": 4.0, "count": self.calls}

        def get_stability_report(self):
            return {"num_mhc_layers": 25, "max_ds_error": 1e-7}

    return StubEngine


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """The port's shapes benchmark at 64², 8 classes: 8 train / 4 val."""
    root = str(tmp_path_factory.mktemp("torch_eval_shapes"))
    generate_shapes_dataset(root, num_train=8, num_val=4, size=64, seed=0)
    return root


@pytest.mark.parametrize("shifted", [False, True])
def test_evaluate_loop_matches_the_jax_script(dataset_root, tmp_path, monkeypatch, shifted):
    stub = _stub_engine(dataset_root, "val", shifted)
    monkeypatch.setattr(hvs_tpu.inference, "InferenceEngine", stub)
    monkeypatch.setattr(hvs_tpu_torch.inference, "InferenceEngine", stub)
    monkeypatch.setattr(hvs_tpu.utils, "enable_compile_cache", lambda *a, **k: None)
    flags = ["--data-root", dataset_root, "--split", "val", "--tiny", "--num-classes", "8"]
    monkeypatch.setattr(sys, "argv", ["evaluate.py", *flags, "--output",
                                      str(tmp_path / "jax.json")])
    _jax_script().main()
    got = port_eval.main([*flags, "--device", "cpu", "--output", str(tmp_path / "port.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert json.loads(json.dumps(got, default=float)) == want
    assert set(want) == {"accuracy", "per_class_AP@0.5", "performance", "stability"}
    assert (want["accuracy"]["mAP@0.5"] == 1.0) == (not shifted)
    assert set(want["per_class_AP@0.5"]) <= {"circle", "square", "triangle", "rectangle",
                                             "ellipse", "ring", "cross", "star"}


def test_evaluate_synthetic_self_check_matches_the_jax_script():
    port = port_eval.main(["--synthetic", "--images", "6"])
    want = _jax_script().synthetic_self_check(SimpleNamespace(images=6))
    assert port["mAP@0.5"] == want["mAP@0.5"] == 1.0
    _close_results(port, want, tol=0.0)
    assert vars(port_eval.parse_args([])) == dict(
        vars(_jax_script_args()), device=None)


def _jax_script_args():
    old = sys.argv
    try:
        sys.argv = ["evaluate.py"]
        return _jax_script().parse_args()
    finally:
        sys.argv = old


# ---------------------------------------------------------------------------
# End to end on the CPU: a dataset on disk -> the three trainers -> evaluate


def _training_yaml(tmp_path, root):
    import yaml

    path = tmp_path / "training.yaml"
    path.write_text(yaml.safe_dump({
        "device": "cpu", "batch_size": 4, "epochs": 1,
        "dataset": {"root": root, "train_split": "train", "val_split": "val",
                    "image_size": 64, "max_boxes": 8, "num_workers": 1},
        "checkpoint_dir": str(tmp_path / "ckpt"), "log_dir": str(tmp_path / "logs")}))
    return str(path)


def test_train_from_data_root_on_cpu(dataset_root, tmp_path):
    from hvs_tpu_torch.train import main

    summary = main(["--config", _training_yaml(tmp_path, dataset_root), "--tiny", "--device",
                    "cpu"])
    assert summary["device"] == "cpu" and summary["num_classes"] == 8
    assert summary["steps"] == 2  # 8 images, batch 4, one epoch
    assert np.isfinite(summary["train_loss"]).all() and np.isfinite(summary["best_val_loss"])
    assert (tmp_path / "ckpt" / "best.pt").exists()
    assert (tmp_path / "logs" / "stability_report.json").exists()
    flags = main(  # the flags override the file
        ["--config", _training_yaml(tmp_path, dataset_root), "--tiny", "--device", "cpu",
         "--batch-size", "2", "--num-classes", "10", "--checkpoint-dir", str(tmp_path / "ck2")])
    assert flags["steps"] == 4 and flags["num_classes"] == 10
    assert (tmp_path / "ck2" / "best.pt").exists()


def test_train_device_from_data_root_on_cpu(dataset_root, tmp_path):
    from hvs_tpu_torch.train_device import main

    run_dir = tmp_path / "run"
    summary = main(["--data-root", dataset_root, "--num-classes", "8", "--tiny", "--device",
                    "cpu", "--total-steps", "4", "--chunk-steps", "2", "--val-every-chunks", "2",
                    "--run-dir", str(run_dir)])
    assert summary["steps"] == 4 and np.isfinite(summary["best_val_loss"])
    for name in ("steps.jsonl", "chunks.jsonl", "checkpoints/final.pt", "checkpoints/best.pt"):
        assert (run_dir / name).exists(), name
    with pytest.raises(ValueError, match="num-classes"):
        main(["--data-root", dataset_root, "--num-classes", "4", "--tiny", "--device", "cpu",
              "--total-steps", "2", "--chunk-steps", "2", "--run-dir", str(run_dir)])


def test_train_multitask_generates_and_reads_a_dense_dataset_on_cpu(tmp_path):
    from hvs_tpu_torch.train_multitask import main

    root = tmp_path / "mt"
    report = main(["--data-root", str(root), "--num-train", "4", "--num-val", "4", "--size",
                   "64", "--tiny", "--device", "cpu", "--steps", "4", "--chunk-steps", "2",
                   "--batch-size", "2", "--output", str(tmp_path / "mt.json")])
    assert (root / "masks" / "train" / "train_000003.png").exists()
    assert (root / "depth" / "val" / "val_000003.png").exists()
    assert report["train_images"] == 4 and str(root) in report["note"]
    for side in ("before", "after"):
        assert np.isfinite([v for v in report[side].values() if np.isscalar(v)]).all()
    again = main(["--data-root", str(root), "--num-train", "99", "--tiny", "--device", "cpu",
                  "--steps", "2", "--chunk-steps", "2", "--batch-size", "2", "--size", "64",
                  "--output", str(tmp_path / "mt2.json")])
    assert again["train_images"] == 4  # read, not regenerated
    assert again["before"] == report["before"]


def test_evaluate_a_trained_checkpoint_on_cpu(dataset_root, tmp_path):
    from hvs_tpu_torch.train_device import main as train_device

    run_dir = tmp_path / "run"
    train_device(["--data-root", dataset_root, "--num-classes", "8", "--tiny", "--device",
                  "cpu", "--total-steps", "2", "--chunk-steps", "2", "--run-dir", str(run_dir)])
    args = port_eval.parse_args(["--data-root", dataset_root, "--split", "val", "--tiny",
                                 "--device", "cpu", "--checkpoint",
                                 str(run_dir / "checkpoints" / "final"), "--output",
                                 str(tmp_path / "ev.json")])
    result = port_eval.run(args)
    report = result.report
    assert len(result.detections) == 4 and report["accuracy"]["num_images"] == 4.0
    assert 0.0 <= report["accuracy"]["mAP@0.5"] <= 1.0
    assert report["performance"]["count"] == 4 and report["stability"]["num_mhc_layers"] > 0
    # The checkpoint's EMA weights are the ones served, and each result is
    # the engine's answer for that frame.
    ckpt = torch.load(str(run_dir / "checkpoints" / "final.pt"), map_location="cpu")
    for name, p in result.engine.model.named_parameters():
        assert torch.equal(p.detach(), ckpt["ema_params"][name].to(p.dtype)), name
    image = cv2.imread(os.path.join(dataset_root, "val", result.dataset.images[1]["file_name"]))
    det = result.engine.infer(image)
    assert np.array_equal(det.boxes, result.detections[1].boxes)
    assert np.array_equal(det.scores, result.detections[1].scores)
    # The evaluator's numbers recomputed from the detections.
    ev = DetectionEvaluator(num_classes=8)
    for i, d in enumerate(result.detections):
        ev.add_image(d.boxes, d.scores, d.classes, *port_eval.ground_truth(result.dataset, i))
    acc = ev.evaluate()
    assert report["accuracy"] == {k: v for k, v in acc.items() if not isinstance(v, dict)}


def test_entry_points_need_a_card_or_the_cpu(dataset_root):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid")
    from hvs_tpu_torch.train_device import main as train_device
    from hvs_tpu_torch.train_multitask import main as train_multitask

    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_eval.main(["--data-root", dataset_root, "--split", "val", "--tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_device(["--data-root", dataset_root, "--num-classes", "8", "--tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_multitask(["--data-root", dataset_root, "--tiny"])
