"""A/B of the two class losses for 80-way convergence, on the card.

Counterpart of ``scripts/cls_loss_ab.py``. Two arms, each from a fresh init
(seed 1) of the flagship training model at 80 classes, overfit the first
``--images`` (64) train images of ``--data-root`` at their size (640²) in
batches of ``--batch`` (8), cycling through them in order as the JAX script
does (step s takes images ``(s % n) * batch`` onward, n = images / batch),
for ``--steps`` (900) steps:

  * ``A:bce_pw79``: ``cls_mode="bce"`` with ``cls_pos_weight=79``;
  * ``B:softmax``: ``cls_mode="softmax"``.

Trainer settings as the script's: learning rate 1e-3, warm-up 100 of 2,000
scheduled steps, no EMA, 16 boxes. On the card the train step
(``step_on_device``) is captured once per arm as one CUDA graph (after
eager warm-up steps whose effect on the state is undone, as
``training/chunk.py`` does) and replayed, each batch copied into its input
buffers first.

At step 1 and every ``--probe-every`` (300) steps the probe (``probe``, the
script's ``make_probe``) runs the model in eval mode on the first
``--probe-images`` (32) images and reads, at the cells the targets assign:
the class argmax accuracy, the mean objectness probability ``obj_p``, the
mean sigmoid of the true class logit ``true_sig`` (the serve score path)
and the positives ``npos``. It prints the script's lines, then one JSON
line with every probe of both arms and the card's record. Runs on the card
unless ``--device cpu``; raises without one::

    python -m hvs_tpu_torch.make_shapes_dataset --root data/shapes80_640 --num-classes 80 \\
        --size 640 --train 64 --val 0
    python -m hvs_tpu_torch.cls_loss_ab --data-root data/shapes80_640
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .models.yolo_head import SCALE_ORDER
from .utils import perf

ARMS = (("A:bce_pw79", dict(cls_mode="bce", cls_pos_weight=79.0)),
        ("B:softmax", dict(cls_mode="softmax")))
NUM_CLASSES, MAX_BOXES = 80, 16


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Class-loss A/B (PyTorch/CUDA port)")
    p.add_argument("--data-root", default="data/shapes80_640")
    p.add_argument("--steps", type=int, default=900)
    p.add_argument("--images", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--probe-every", type=int, default=300)
    p.add_argument("--probe-images", type=int, default=32)
    p.add_argument("--output", default=f"{perf.OUTPUT_DIR}/cls_loss_ab.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--tiny", action="store_true", help="the tiny model, for a run on the CPU")
    return p.parse_args(argv)


@torch.no_grad()
def probe(model, images: torch.Tensor, gboxes: torch.Tensor, glabels: torch.Tensor,
          gmask: torch.Tensor, num_classes: int = NUM_CLASSES) -> Tuple[torch.Tensor, ...]:
    """The script's probe: the model in eval mode on normalized ``images``
    (uint8 NHWC), the targets ``build_targets`` assigns on its grids, and
    over their positive cells the argmax accuracy, the mean sigmoid of the
    objectness logit, the mean sigmoid of the true class logit, and the
    number of positives (0-dim fp32 tensors)."""
    from .training.losses import build_targets
    from .training.trainer import prepare_images

    model.eval()
    raw = model(prepare_images(images))["detection"]["raw"]
    grids = [(raw[k].shape[1], raw[k].shape[2]) for k in SCALE_ORDER]
    targets = build_targets(gboxes, glabels, gmask, grids, num_classes)
    acc = obj = tsig = npos = torch.zeros((), device=images.device)
    for k in SCALE_ORDER:
        v, t = raw[k].float(), targets[k]
        pos = t["obj"]
        cls_logit = v[..., 5:]
        acc = acc + ((cls_logit.argmax(-1) == t["cls"]).float() * pos).sum()
        obj = obj + (torch.sigmoid(v[..., 4]) * pos).sum()
        true = torch.gather(cls_logit, -1, t["cls"][..., None].long())[..., 0]
        tsig = tsig + (torch.sigmoid(true) * pos).sum()
        npos = npos + pos.sum()
    d = torch.clamp(npos, min=1.0)
    return acc / d, obj / d, tsig / d, npos


class CapturedStep:
    """``step_on_device`` on fixed input buffers, captured once as a CUDA
    graph (on the CPU: eager). Calling it with a batch copies the batch into
    the buffers and runs the step; returns its metrics (0-dim tensors)."""

    def __init__(self, trainer, example: Dict[str, torch.Tensor]):
        from .training.chunk import WARMUP_STEPS, _captured, _warm_up

        self.trainer = trainer
        self.inputs = {k: v.clone() for k, v in example.items()}
        self.graph = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        if trainer.device.type != "cuda":
            return
        state = trainer.state_tensors()
        saved = [x.detach().clone() for x in state]
        gen_state = trainer.generator.get_state()
        _warm_up(self._step, trainer.device, WARMUP_STEPS)
        with torch.no_grad():
            for x, v in zip(state, saved):
                x.copy_(v)
        trainer.generator.set_state(gen_state)
        del saved
        self.graph, self.launches = _captured(self._step, trainer.device, None,
                                              trainer.generator)

    def _step(self) -> None:
        from .training.trainer import step_on_device

        t = self.trainer
        self.metrics = step_on_device(t.model, t.tx, t.config, self.inputs, t.lr_scale_t,
                                      t.state.ema_params)[0]

    def __call__(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        for k, v in batch.items():
            self.inputs[k].copy_(v)
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()
            self.replays += 1
        self.trainer.state.step += 1
        return self.metrics


def run_arm(name: str, overrides: Dict, data, args, device, launches: perf.Launches,
            workdir: str) -> List[Dict]:
    from .training import ManifoldConstrainedTrainer, TrainerConfig
    from .train_roofline import training_model

    cfg = TrainerConfig(num_classes=NUM_CLASSES, learning_rate=1e-3, warmup_steps=100,
                        total_steps=2000, ema_decay=0.0, max_boxes=MAX_BOXES,
                        checkpoint_dir=workdir, **overrides)
    model = training_model(NUM_CLASSES, device, args.tiny, seed=1)
    trainer = ManifoldConstrainedTrainer(model, cfg, device=device, seed=1)
    trainer.init_state()
    b = args.batch
    n_batches = args.images // b

    def batch_at(i: int) -> Dict[str, torch.Tensor]:
        return {"images": data.images[i:i + b], "boxes": data.boxes[i:i + b],
                "labels": data.labels[i:i + b], "box_mask": data.mask[i:i + b]}

    step_fn = CapturedStep(trainer, batch_at(0))
    p = args.probe_images
    rows = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        m = step_fn(batch_at((step % n_batches) * b))
        if step % args.probe_every == 0 or step == 1:
            host = {k: round(float(v), 3) for k, v in m.items()
                    if k in ("loss", "box_loss", "obj_loss", "cls_loss")}
            acc, objp, tsig, npos = (float(v) for v in probe(
                trainer.model, data.images[:p], data.boxes[:p], data.labels[:p],
                data.mask[:p]))
            elapsed = time.time() - t0
            print(f"[{name}] step {step} ({elapsed:.0f}s): {host} "
                  f"| probe acc={acc:.3f} obj_p={objp:.3f} "
                  f"true_sig={tsig:.3f} npos={npos:.0f}", flush=True)
            rows.append({"step": step, "seconds": elapsed, **host, "acc": acc, "obj_p": objp,
                         "true_sig": tsig, "npos": npos})
    launches.add(step_fn)
    return rows


def run(args: argparse.Namespace) -> Tuple[Dict, Dict[str, int]]:
    from .data.device_pipeline import load_coco_arrays, put_device_data
    from .device import resolve_device

    device = resolve_device(args.device)
    launches = perf.Launches()
    arrays = load_coco_arrays(args.data_root, "train", max_boxes=MAX_BOXES, limit=args.images)
    print("loaded", arrays[0].shape, "n_boxes", arrays[3].sum(), flush=True)
    data = put_device_data(*arrays, device=device)
    report = {"card": perf.card(device), "steps": args.steps, "images": args.images,
              "batch": args.batch, "arms": {}}
    with tempfile.TemporaryDirectory(prefix="hvs_cls_ab_") as workdir:
        for name, overrides in ARMS:
            report["arms"][name] = run_arm(name, overrides, data, args, device, launches,
                                           workdir)
    final = {name: rows[-1] for name, rows in report["arms"].items()}
    report["winner"] = max(final, key=lambda k: (final[k]["acc"], final[k]["obj_p"]))
    print("done", flush=True)
    return report, launches.total()


def main(argv: Optional[Sequence[str]] = None) -> Tuple[Dict, Dict[str, int]]:
    args = parse_args(argv)
    report, launches = run(args)
    perf.write(report, args.output)
    print(json.dumps({"kernel_launches": launches}), file=sys.stderr, flush=True)
    print(json.dumps(report), flush=True)
    return report, launches


if __name__ == "__main__":
    main()
