"""Served detections against the plain reference: the check of every cell
that serves a detector (``"check": "detections"`` in its traffic file).

``prepare`` makes the inputs from the seed: the weights and the pool of raw
camera frames, on the device, and the objectness bias set so that the
reference finds the configuration's candidates per frame; it also takes the
benchmark's own count of a frame's flops and of kernel A's sites.
``judge`` runs the configuration's reference (TF32 off) over the frames
whose answers the generator kept, once the program is freed, and holds the
answers against it (``harness/judge.py``). ``control`` puts the reference,
computed in float8, in the program's place on the same frames."""

from __future__ import annotations

import torch

from perfbench.count import bounds, flops
from perfbench.harness import judge as judging
from perfbench.harness.frames import make_frames
from perfbench.harness.weights import calibrate_objectness, make_weights


def prepare(run) -> None:
    cfg, t, ref = run.cfg, run.traffic, run.reference
    size = t["image_size"]
    run.weights = make_weights(cfg, ref, run.seed, run.device)
    run.frames = make_frames(t["pool"], t["frame_h"], t["frame_w"], run.seed, run.device)
    with run.reference_time():
        run.count = {"frame_flops": flops.frame_flops(cfg, ref, size),
                     "kernel_a_sites": bounds.kernel_a_sites(flops.mhc_sites(cfg, ref, size))}
        run.result["objectness_shift"] = calibrate_objectness(cfg, ref, run.weights,
                                                              run.frames[:2], size)


def _frames(run):
    idx = torch.tensor([i for i, _ in run.served], dtype=torch.long, device=run.device)
    return run.frames[idx]


def _tables(run, precision=None):
    cfg, ref = run.cfg, run.reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = ref.prepare(run.weights, cfg["sinkhorn_iterations"])
    model = ref.Model(cfg, params) if precision is None else ref.Model(cfg, params, precision)
    return judging.reference_tables(ref, model, _frames(run), run.traffic["image_size"])


def _judge(run, served, tables):
    t = run.traffic
    return judging.judge(run.reference, served, tables, (t["frame_h"], t["frame_w"]),
                         t["image_size"], run.cfg)


def judge(run):
    """The numbers of the answers the generator kept (``run.served``:
    [(pool index, detections)])."""
    served = [judging.Served(d.boxes, d.scores, d.classes) for _, d in run.served]
    return _judge(run, served, _tables(run))


def control(run):
    """The same numbers with the reference in float8 (e4m3, one scale per
    tensor, the precision below the configuration's bf16) in the program's
    place: its own decode, NMS and box filter."""
    t, ref = run.traffic, run.reference
    frame_hw = (t["frame_h"], t["frame_w"])
    served = [judging.reference_detections(ref, b, s, frame_hw, t["image_size"], run.cfg)
              for b, s in _tables(run, ref.Precision("fp8"))]
    return _judge(run, served, _tables(run))
