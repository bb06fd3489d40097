"""The control: the plain reference computed in float8 (the precision
below the configuration's bf16), put in the program's place and judged as
the program is (``checks/detections.py``). It must come out not correct;
the sound path (the reference itself in the program's place) must come out
correct."""

from types import SimpleNamespace

import pytest
import torch

from conftest import load_traffic, tiny_config
from perfbench.harness import judge
from perfbench.harness.frames import make_frames
from perfbench.harness.weights import calibrate_objectness, make_weights
from perfbench.reference import hybrid as ref

CPU = torch.device("cpu")
LIMITS = load_traffic("serve_b16_720p")["limits"]
FRAMES = 32  # as many as a run of a cell judges


def _run(seed):
    cfg = tiny_config()
    weights = make_weights(cfg, ref, seed, CPU)
    frames = make_frames(FRAMES, 72, 128, seed, CPU)
    calibrate_objectness(cfg, ref, weights, frames[:2], 128)
    traffic = {"frame_h": 72, "frame_w": 128, "image_size": 128}
    return SimpleNamespace(cfg=cfg, traffic=traffic, reference=ref, weights=weights,
                           frames=frames, device=CPU, served=[(i, None) for i in range(FRAMES)])


def _exceeds(numbers):
    return any(numbers[k] > limit for k, limit in LIMITS.items())


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(seed, detections_check):
    numbers = detections_check.control(_run(seed))
    assert numbers["detections"] > 0
    assert _exceeds(numbers), numbers


def test_the_reference_in_the_programs_place_is_correct(detections_check):
    run = _run(11)
    tables = detections_check._tables(run)
    served = [judge.reference_detections(ref, b, s, (72, 128), 128, run.cfg) for b, s in tables]
    numbers = judge.judge(ref, served, tables, (72, 128), 128, run.cfg)
    assert numbers["detections"] > 0
    assert numbers["logit_gap"] < 1e-5 and numbers["missed"] == 0, numbers
