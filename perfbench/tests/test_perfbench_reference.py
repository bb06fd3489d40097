"""The plain reference against the port, at a tiny size on the CPU, and the
benchmark's flop count against the figure the port's own count gave."""

import importlib

import numpy as np
import pytest
import torch

from conftest import ROOT, load_config, load_traffic, tiny_config
from perfbench.harness import judge, program
from perfbench.harness.frames import make_frames
from perfbench.harness.weights import make_weights
from perfbench.reference import hybrid as ref

CPU = torch.device("cpu")
LIMIT = load_traffic("serve_b16_720p")["limits"]["logit_gap"]
CONFIGS = sorted(p.stem for p in (ROOT / "perfbench" / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_param_spec_matches_the_port(name):
    """Every configuration's reference names the parameters of the model the
    harness builds from its file, with their shapes."""
    cfg = load_config(name)
    reference = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    model = program.model_config(cfg, "cpu").build_model(production=True, device="cpu")
    port = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mine = {n: s for n, s, _, _ in reference.param_spec(cfg)}
    assert mine == port


@pytest.mark.parametrize("use_vit", [True, False])
def test_reference_logits_match_the_port(use_vit):
    cfg = tiny_config(use_vit)
    weights = make_weights(cfg, ref, 12345, CPU)
    engine = program.build_engine(cfg, weights, 64, (2,), CPU)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port = engine.model(x)["detection"]["raw"]
        mine = ref.Model(cfg, ref.prepare(weights, cfg["sinkhorn_iterations"])).raw(x)
    for key, r in zip(ref.SCALES, mine):
        torch.testing.assert_close(port[key].float(), r, rtol=1e-4, atol=1e-4)


def test_served_frames_judge_clean_and_faults_do_not():
    """The engine's served detections on raw frames pass the judge at fp32;
    altered classes, boxes moved by half their size, or frames left empty,
    do not."""
    cfg = tiny_config()
    cfg["predict_bias"] = {"objectness": 1.0, "class": 0.0}
    weights = make_weights(cfg, ref, 7, CPU)
    frames = make_frames(4, 48, 80, 7, CPU)
    engine = program.build_engine(cfg, weights, 64, (4,), CPU)
    engine.register_raw_shape((48, 80), buckets=[4])
    dets = engine.infer_batch([f.numpy() for f in frames])
    served = [judge.Served(d.boxes, d.scores, d.classes) for d in dets]
    model = ref.Model(cfg, ref.prepare(weights, cfg["sinkhorn_iterations"]))
    tables = judge.reference_tables(ref, model, frames, 64)
    clean = judge.judge(ref, served, tables, (48, 80), 64, cfg)
    assert clean["detections"] > 0
    assert clean["logit_gap"] < 1e-3 and clean["missed"] == 0
    altered = [judge.Served(s.boxes, s.scores, (s.classes + 1) % cfg["num_classes"])
               for s in served]
    assert judge.judge(ref, altered, tables, (48, 80), 64, cfg)["logit_gap"] > LIMIT
    moved = []
    for s in served:
        shift = (s.boxes[:, 2:] - s.boxes[:, :2]).amax(dim=1, keepdim=True) * 0.5
        moved.append(judge.Served(s.boxes + shift.repeat(1, 4), s.scores, s.classes))
    assert judge.judge(ref, moved, tables, (48, 80), 64, cfg)["logit_gap"] > LIMIT
    empty = [judge.Served(np.zeros((0, 4)), [], [])] * 2 + served[2:]
    left_out = judge.judge(ref, empty, tables, (48, 80), 64, cfg)
    assert left_out["missed"] > 0 and left_out["logit_gap"] > LIMIT


def test_flop_count_of_the_flagship_at_640():
    """PERF.md's count of the port's serve call: 50.14 GFLOP per 640² image
    (product flops, a SAME convolution's padded taps included)."""
    from perfbench.count.flops import frame_flops

    flops = frame_flops(load_config("hvs_flagship"), ref, 640)
    assert abs(flops / 50.14e9 - 1) < 0.01, flops
