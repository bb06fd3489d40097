#!/usr/bin/env python
"""Hold the port's training against the JAX package's at the flagship's full
widths: a host tool that imports both packages.

The flagship (``hvs_tpu/models/hybrid.py``: base 32, blocks (2, 3, 4, 2),
channels (64, 128, 256, 512), ViT 256 x 6 with 8 heads, FPN and head 256)
with 8 classes is initialised by JAX and carried into the port through
``hvs_tpu_torch/convert.py``. Both trainers are fed the same batches of the
shapes benchmark (``data/shapes.py``'s generator, in memory, from a seed).
Only the resolution is cut (default 128²).

Modes:

* ``step``: one train step from init on one ``eval_batch``, dropout off, in
  fp32 and in bf16. Compares each part of the loss, the pre-clip global
  gradient norm, each parameter group's gradient (cosine and norm ratio),
  the parameters after the update and the EMA.
* ``trajectory``: ``--steps`` steps through both trainers' chunk bodies
  (JAX: ``make_train_step`` after ``sample_batch`` on ``fold_in(rng,
  step)``, as ``make_train_chunk`` composes them; the port: ``TrainChunk``
  fed the same draws), sizes alternating by chunk, a warm-up short enough to
  reach the peak rate, ``project_every`` crossed, the EMA on. Records the
  loss, each part and the grad norm per step on both sides, and the
  yardstick: JAX fp32 against JAX bf16 (dropout off) and, with dropout on,
  JAX seed A against seed B. The port is at parity where its gap to JAX
  stays within that spread, in 20-step window means of the loss and in the
  largest grad norm after the first 20 steps (the init transient); the
  limits and the verdict are printed.
* ``init``: the port's own initialisation against JAX's, per parameter
  (mean and standard deviation), on the flagship.
* ``layer``: one bf16 mHC training layer against JAX's jitted one and its
  fp32 result, on inputs with a large common mode.

On the card (no JAX there) ``trajectory --device cuda`` holds the port on
the card against the port on that machine's CPU instead, fed the same draws
(``chip_smoke.py``'s phase ``train_trajectory``): the chain is JAX ≈ port
on the CPU here, then port on the CPU ≈ port on the card there.

Usage (here, on the CPU: ``step`` ~5 min, ``trajectory`` ~35 min at 128²,
most of it JAX's compiles; ``--jax-cache DIR`` keeps them for a rerun,
``--reuse-jax RECORD`` takes JAX's runs from an earlier record)::

    python scripts/torch_train_parity.py step --out step.json
    python scripts/torch_train_parity.py trajectory --steps 200 --out traj.json
    python scripts/torch_train_parity.py init
    python scripts/torch_train_parity.py layer
    python scripts/torch_train_parity.py trajectory --device cuda --steps 200   # on the card
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

NUM_CLASSES = 8
MAX_BOXES = 16
PARTS = ("detection_loss", "box_loss", "obj_loss", "cls_loss", "num_positives", "manifold_ds",
         "manifold_spectral", "manifold_smooth")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("step", "trajectory", "init", "layer"))
    p.add_argument("--size", type=int, default=128, help="train resolution (multiple of 32)")
    p.add_argument("--size2", type=int, default=160,
                   help="trajectory: the second size, alternated by chunk (0: one size)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--images", type=int, default=64, help="shapes images generated")
    p.add_argument("--image-size", type=int, default=160, help="generated frame side")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--chunk-steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=30)
    p.add_argument("--total-steps", type=int, default=6000,
                   help="the schedule's length (the cosine barely falls over --steps)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ema-decay", type=float, default=0.999)
    p.add_argument("--project-every", type=int, default=100)
    p.add_argument("--dtypes", default="fp32,bf16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--device", default="cpu",
                   help="trajectory: cuda runs the port on the card against the port on "
                        "this machine's CPU (chip_smoke.py's phase train_trajectory; no JAX)")
    p.add_argument("--out", default=None, help="write the JSON record here")
    p.add_argument("--reuse-jax", default=None, metavar="RECORD",
                   help="trajectory: take the JAX runs from an earlier --out record of the "
                        "same arguments (they do not depend on the port) and rerun the port's")
    p.add_argument("--jax-cache", default=None,
                   help="JAX's persistent compilation cache directory (reruns skip the compiles)")
    return p.parse_args(argv)


# ---------------------------------------------------------------------------
# Data


def shapes_arrays(n: int, size: int, seed: int):
    """``n`` frames of the shapes benchmark as ``load_coco_arrays`` returns
    them, padded to ``MAX_BOXES`` (``chip_smoke.shapes_arrays``)."""
    import chip_smoke

    return chip_smoke.shapes_arrays(n, size, seed, MAX_BOXES)


# ---------------------------------------------------------------------------
# The two sides


def jax_model(dtype: str, dropout: bool):
    """The JAX flagship; ``dropout=False`` runs every forward deterministic
    (the heads' mHC layers keep their own rate 0.1 whatever the model's
    ``dropout_rate``, so only ``deterministic`` turns dropout off)."""
    import jax.numpy as jnp

    from hvs_tpu.models import HybridVisionSystem

    class Deterministic(HybridVisionSystem):
        def __call__(self, images, task="detection", deterministic=True):
            return super().__call__(images, task, True)

    cls = HybridVisionSystem if dropout else Deterministic
    return cls(num_classes=NUM_CLASSES, monitor=True,
               dtype=jnp.float32 if dtype == "fp32" else jnp.bfloat16)


def jax_init(model, size: int, seed: int):
    """JAX's init params of ``model`` at ``size`` (numpy tree)."""
    import jax
    import jax.numpy as jnp

    return jax.device_get(jax.jit(functools.partial(model.init, task="detection"))(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3), jnp.float32))["params"])


def trainer_config(args, warmup=None):
    warmup = args.warmup if warmup is None else warmup
    return dict(num_classes=NUM_CLASSES, learning_rate=args.lr, warmup_steps=warmup,
                total_steps=args.total_steps, ema_decay=args.ema_decay, max_boxes=MAX_BOXES,
                project_every=args.project_every)


def port_trainer(params, dtype: str, dropout: bool, args, device="cpu", warmup=None):
    """The port's trainer on the flagship holding ``params`` (a flax tree);
    ``dropout=False`` zeroes every dropout rate."""
    import torch

    from hvs_tpu_torch.convert import load_flax_params
    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.models.layers import Dropout
    from hvs_tpu_torch.training.trainer import ManifoldConstrainedTrainer, TrainerConfig

    model = HybridVisionSystem(num_classes=NUM_CLASSES, monitor=True,
                               dtype=torch.float32 if dtype == "fp32" else torch.bfloat16,
                               device="cpu")
    load_flax_params(model, params)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    trainer = ManifoldConstrainedTrainer(model, TrainerConfig(**trainer_config(args, warmup)),
                                         device=device, seed=args.seed)
    trainer.init_state()
    return trainer


def group_of(name: str) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("H_res_raw", "H_pre_raw", "H_post_raw"):
        return leaf
    return name.split(".", 1)[0]


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def compare_groups(got, want):
    """Per parameter group: the cosine of ``got`` to ``want`` and their norm
    ratio (flat dicts of arrays by parameter name)."""
    a, b = grouped(got), grouped(want)
    return {g: {"cos": _cos(a[g], b[g]),
                "norm_ratio": float(np.linalg.norm(a[g]) / max(np.linalg.norm(b[g]), 1e-30)),
                "norm": float(np.linalg.norm(b[g]))}
            for g in sorted(b) if np.linalg.norm(b[g]) > 0}


def grouped(flat):
    out = {}
    for name in sorted(flat):
        out.setdefault(group_of(name), []).append(np.ravel(np.asarray(flat[name], np.float64)))
    return {k: np.concatenate(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# step


def run_step(args):
    import jax
    import jax.numpy as jnp

    from hvs_tpu.data import device_pipeline as jdp
    from hvs_tpu.training.trainer import TrainerConfig, TrainState, make_train_step
    from hvs_tpu.training.optimizer import make_optimizer
    from hvs_tpu.training.schedule import cosine_annealing_with_warmup
    from hvs_tpu_torch.convert import flatten, to_flax_layout
    from hvs_tpu_torch.data import device_pipeline as tdp
    from hvs_tpu_torch.training.trainer import step_on_device

    arrays = shapes_arrays(args.images, args.image_size, args.seed)
    jdata = jdp.DeviceData(*(jnp.asarray(a) for a in arrays))
    tdata = tdp.put_device_data(*arrays, device="cpu")
    record, kept = {}, {}
    for dtype in args.dtypes.split(","):
        t0 = time.time()
        # No warm-up: the first update moves the parameters at the peak rate.
        model = jax_model(dtype, dropout=False)
        cfg = TrainerConfig(**trainer_config(args, 0))
        params = jax_init(model, args.size, args.seed)
        tx = make_optimizer(cosine_annealing_with_warmup(cfg.learning_rate, cfg.warmup_steps,
                                                         cfg.total_steps),
                            weight_decay=cfg.weight_decay, mhc_lr_factor=cfg.mhc_lr_factor,
                            clip_regular=cfg.clip_regular, clip_mhc=cfg.clip_mhc,
                            project_every=cfg.project_every, sk_iters=cfg.sk_iters)
        state = TrainState.create(apply_fn=model.apply, params=params, tx=tx,
                                  lr_scale=jnp.ones([], jnp.float32),
                                  ema_params=jax.tree_util.tree_map(jnp.copy, params))
        state = state.replace(step=jnp.zeros((), jnp.int32))
        batch = jdp.eval_batch(jdata, 0, args.batch, args.size)
        step = make_train_step(model, cfg)

        def with_grads(state, batch, rng):
            # make_train_step's loss, gradients and update, with the
            # gradients returned too (the step itself does not return them).
            from hvs_tpu.training.losses import (build_targets, manifold_regularization_loss,
                                                 mhc_yolo_loss)

            images = batch["images"]
            h = images.shape[1]
            grids = [(h // 8, h // 8), (h // 16, h // 16), (h // 32, h // 32)]
            targets = build_targets(batch["boxes"], batch["labels"], batch["box_mask"], grids,
                                    NUM_CLASSES)

            def loss_fn(p):
                out, _ = model.apply({"params": p}, images, task="detection",
                                     deterministic=True, mutable=["stability"])
                det, _ = mhc_yolo_loss(out["detection"]["raw"], targets, NUM_CLASSES)
                reg, _ = manifold_regularization_loss(p, sk_iters=cfg.sk_iters)
                return det + cfg.manifold_reg_alpha * reg

            grads = jax.grad(loss_fn)(state.params)
            new_state, metrics = step(state, batch, rng)
            return new_state, metrics, grads

        jstate, jm, jgrads = jax.jit(with_grads)(state, batch, jax.random.PRNGKey(1))
        jm = {k: float(v) for k, v in jax.device_get(jm).items()}
        jgrads = flatten(jax.device_get(jgrads))
        jparams = flatten(jax.device_get(jstate.params))
        jema = flatten(jax.device_get(jstate.ema_params))
        t_jax = time.time() - t0

        t0 = time.time()
        trainer = port_trainer(params, dtype, False, args, warmup=0)
        tb = tdp.eval_batch(tdata, 0, args.batch, args.size)
        tm, tgrads = step_on_device(trainer.model, trainer.tx, trainer.config, tb,
                                    trainer.lr_scale_t, trainer.state.ema_params)
        tm = {k: float(v) for k, v in tm.items()}
        tgrads = {k: to_flax_layout(k, v.detach().numpy()) for k, v in tgrads.items()}
        tparams = {k: to_flax_layout(k, v.detach().numpy())
                   for k, v in trainer.params().items()}
        tema = {k: to_flax_layout(k, v.numpy()) for k, v in trainer.state.ema_params.items()}
        t_port = time.time() - t0

        rec = {"seconds": {"jax": t_jax, "port": t_port}, "metrics": {}}
        for k in ("loss",) + PARTS + ("grad_norm", "ds_error_max", "signal_ratio_mean"):
            if k in jm and k in tm:
                rec["metrics"][k] = {"jax": jm[k], "port": tm[k],
                                     "rel": abs(tm[k] - jm[k]) / max(abs(jm[k]), 1e-12)}
        rec["grad_groups"] = compare_groups(tgrads, jgrads)
        p0 = flatten(params)
        rec["update_groups"] = compare_groups({k: tparams[k] - p0[k] for k in p0},
                                              {k: jparams[k] - p0[k] for k in p0})
        kept[dtype] = (jgrads, tgrads)
        ej, et = grouped(jema), grouped(tema)
        rec["ema_max_abs"] = max(float(np.max(np.abs(et[g] - ej[g]))) for g in ej)
        record[dtype] = rec
        print(json.dumps({dtype: rec}, indent=1), flush=True)
    if "fp32" in kept and "bf16" in kept:
        # The yardstick for bf16: how far each side's bf16 gradient lies from
        # the fp32 gradient of the same parameters on the same batch.
        (jf, tf), (jb, tb) = kept["fp32"], kept["bf16"]
        record["bf16_against_fp32"] = {"jax": compare_groups(jb, jf),
                                       "port": compare_groups(tb, tf),
                                       "port_bf16_against_jax_fp32": compare_groups(tb, jf)}
        print(json.dumps({"bf16_against_fp32": record["bf16_against_fp32"]}, indent=1))
    return record


# ---------------------------------------------------------------------------
# trajectory

TRACKED = ("loss", "detection_loss", "box_loss", "obj_loss", "cls_loss", "grad_norm")
WINDOW = 20
# The first steps' grad norms are the init transient: every run's largest
# comes at step 3, where bf16 rounding at init sets it. The grad-norm
# criterion reads the largest after them.
TRANSIENT = 20


def jax_draws(rng, batch: int, n: int, aug):
    """``sample_batch``'s random draws on ``rng`` as the port's
    ``AugmentDraws`` (numpy arrays; the split order of ``sample_batch``)."""
    import jax

    k_idx, k_flip, k_bright, k_con, k_gain, k_zoom, k_tx, k_ty = jax.random.split(rng, 8)
    u = jax.random.uniform
    draws = dict(
        idx=jax.random.randint(k_idx, (batch,), 0, n),
        flip=jax.random.bernoulli(k_flip, aug.flip_prob, (batch,)),
        brightness=u(k_bright, (batch, 1, 1, 1), minval=-aug.brightness, maxval=aug.brightness),
        contrast=u(k_con, (batch, 1, 1, 1), minval=1 - aug.contrast, maxval=1 + aug.contrast),
        gain=u(k_gain, (batch, 1, 1, 3), minval=1 - aug.channel_gain,
               maxval=1 + aug.channel_gain),
        zoom=u(k_zoom, (batch,), minval=aug.zoom_min, maxval=aug.zoom_max),
        tx=u(k_tx, (batch,)), ty=u(k_ty, (batch,)))
    return {k: np.asarray(v) for k, v in jax.device_get(draws).items()}


def schedule_of(args):
    """(chunk index, size) of every step: sizes alternate by chunk, as in
    ``train_chunked``."""
    sizes = [args.size] + ([args.size2] if args.size2 else [])
    return [(i // args.chunk_steps, sizes[(i // args.chunk_steps) % len(sizes)])
            for i in range(args.steps)]


def data_rng(args, step: int, chunk: int):
    """``make_train_chunk``'s per-step key: ``fold_in(fold_in(rng, chunk), step)``."""
    import jax

    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(args.seed), chunk), step)


def run_jax_trajectory(args, arrays, params, dtype: str, dropout: bool, dropout_seed: int):
    """``args.steps`` steps of JAX's chunk body: ``sample_batch`` on the
    step's key, then ``make_train_step``. The dropout key is its own stream
    (``dropout_seed``) so that two seeds see the same batches."""
    import jax
    import jax.numpy as jnp

    from hvs_tpu.data import device_pipeline as jdp
    from hvs_tpu.training.trainer import ManifoldConstrainedTrainer, TrainerConfig, \
        TrainState, make_train_step

    model = jax_model(dtype, dropout)
    cfg = TrainerConfig(**trainer_config(args))
    # The trainer's optimizer and state, built from the given init (its own
    # init_state would compile and run the model's init once more).
    trainer = ManifoldConstrainedTrainer(model, cfg, rng=jax.random.PRNGKey(args.seed))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState.create(apply_fn=model.apply, params=p, tx=trainer.tx,
                              lr_scale=jnp.ones([], jnp.float32),
                              ema_params=jax.tree_util.tree_map(jnp.copy, p))
    state = state.replace(step=jnp.zeros((), jnp.int32))
    jdata = jdp.DeviceData(*(jnp.asarray(a) for a in arrays))
    aug = jdp.AugmentConfig()
    step_fn = make_train_step(model, cfg)
    fns = {}
    rows = []
    drop_key = jax.random.PRNGKey(10_000 + dropout_seed)
    for i, (ci, size) in enumerate(schedule_of(args)):
        if size not in fns:
            def body(state, data, rng, drop, size=size):
                batch = jdp.sample_batch(data, rng, args.batch, size, aug, augment=True)
                return step_fn(state, batch, drop)

            fns[size] = jax.jit(body, donate_argnums=(0,))
        state, m = fns[size](state, jdata, data_rng(args, i, ci),
                             jax.random.fold_in(drop_key, i))
        m = jax.device_get(m)
        rows.append({k: float(m[k]) for k in TRACKED if k in m})
    return rows


def run_port_trajectory(args, arrays, params, dtype: str, dropout: bool, device="cpu"):
    """The same steps through the port's ``TrainChunk`` bodies, fed JAX's
    draws: one chunk object per size, its metrics block pulled per chunk."""
    import jax
    import torch

    from hvs_tpu.data import device_pipeline as jdp
    from hvs_tpu_torch.data import device_pipeline as tdp
    from hvs_tpu_torch.training.chunk import TrainChunk

    trainer = port_trainer(params, dtype, dropout, args, device=device)
    data = tdp.put_device_data(*arrays, device=device)
    aug = jdp.AugmentConfig()
    chunks = {}
    rows = []
    plan = schedule_of(args)
    for i, (ci, size) in enumerate(plan):
        if size not in chunks:
            chunks[size] = TrainChunk(trainer, data, size, args.batch, args.chunk_steps,
                                      tdp.AugmentConfig())
        chunk = chunks[size]
        if i % args.chunk_steps == 0:
            chunk.pos.zero_()
        d = jax_draws(data_rng(args, i, ci), args.batch, len(arrays[0]), aug)
        draws = tdp.AugmentDraws(**{k: torch.from_numpy(np.array(v)).to(
            device=device, dtype=torch.long if k == "idx" else None) for k, v in d.items()})
        chunk.step(draws)
        if (i + 1) % args.chunk_steps == 0 or i + 1 == len(plan):
            host = chunk.pull()
            for j in range(int(chunk.pos)):
                rows.append({k: float(host[k][j]) for k in TRACKED if k in host})
    return rows


def windows(rows, key):
    v = np.array([r[key] for r in rows], np.float64)
    n = len(v) // WINDOW
    return v[:n * WINDOW].reshape(n, WINDOW)


def gap(a_rows, b_rows):
    """The largest relative gap of 20-step window means of the loss, and the
    ratio of the largest grad norms after the init transient, of run ``a``
    against run ``b``."""
    ma, mb = windows(a_rows, "loss").mean(1), windows(b_rows, "loss").mean(1)
    ga = max(r["grad_norm"] for r in a_rows[TRANSIENT:])
    gb = max(r["grad_norm"] for r in b_rows[TRANSIENT:])
    return {"loss_window_rel_max": float(np.max(np.abs(ma - mb) / np.abs(mb))),
            "grad_norm_max_ratio": float(ga / gb),
            "grad_norm_max_log_ratio": float(abs(np.log(ga / gb)))}


def run_trajectory(args):
    arrays = shapes_arrays(args.images, args.image_size, args.seed)
    params = jax_init(jax_model("fp32", False), max(args.size, args.size2 or 0), args.seed)
    runs = {}
    earlier = {}
    if args.reuse_jax:
        with open(args.reuse_jax) as f:
            earlier = json.load(f)["trajectory"]["runs"]

    def timed(name, fn, *a):
        t0 = time.time()
        runs[name] = earlier[name] if name.startswith("jax") and name in earlier else fn(*a)
        print(f"{name}: {len(runs[name])} steps in {time.time() - t0:.0f} s; window means "
              f"{np.round(windows(runs[name], 'loss').mean(1), 3).tolist()}", flush=True)

    timed("jax_fp32", run_jax_trajectory, args, arrays, params, "fp32", False, 0)
    timed("port_fp32", run_port_trajectory, args, arrays, params, "fp32", False)
    timed("jax_bf16", run_jax_trajectory, args, arrays, params, "bf16", False, 0)
    timed("port_bf16", run_port_trajectory, args, arrays, params, "bf16", False)
    timed("jax_bf16_dropout_a", run_jax_trajectory, args, arrays, params, "bf16", True, 0)
    timed("jax_bf16_dropout_b", run_jax_trajectory, args, arrays, params, "bf16", True, 1)
    timed("port_bf16_dropout", run_port_trajectory, args, arrays, params, "bf16", True)

    rounding = gap(runs["jax_bf16"], runs["jax_fp32"])
    seeds = gap(runs["jax_bf16_dropout_b"], runs["jax_bf16_dropout_a"])
    checks = {
        "port_fp32 vs jax_fp32": (gap(runs["port_fp32"], runs["jax_fp32"]), rounding),
        "port_bf16 vs jax_bf16": (gap(runs["port_bf16"], runs["jax_bf16"]), rounding),
        "port_bf16_dropout vs jax_bf16_dropout_a": (
            gap(runs["port_bf16_dropout"], runs["jax_bf16_dropout_a"]),
            {k: max(seeds[k], rounding[k]) for k in seeds}),
    }
    verdicts = {}
    for name, (got, limit) in checks.items():
        ok = (got["loss_window_rel_max"] <= limit["loss_window_rel_max"]
              and got["grad_norm_max_log_ratio"] <= limit["grad_norm_max_log_ratio"])
        verdicts[name] = {"gap": got, "limit": limit, "parity": bool(ok)}
        print(f"{name}: loss window gap {got['loss_window_rel_max']:.4f} (limit "
              f"{limit['loss_window_rel_max']:.4f}), largest grad norm ratio after step "
              f"{TRANSIENT} "
              f"{got['grad_norm_max_ratio']:.3f} (limit x/÷ "
              f"{np.exp(limit['grad_norm_max_log_ratio']):.3f}): "
              f"{'PARITY' if ok else 'APART'}", flush=True)
    return {"yardstick": {"jax_bf16_vs_jax_fp32": rounding,
                          "jax_dropout_seed_b_vs_a": seeds},
            "verdicts": verdicts, "runs": runs}


# ---------------------------------------------------------------------------
# init


def run_init(args, seeds=(0, 1, 2)):
    """The port's own initialisation against JAX's, over a few seeds: the
    loss of each at init on one batch (JAX's fp32 forward for both), and
    every parameter whose mean or standard deviation differs by more than 5 %
    of JAX's standard deviation (averaged over the seeds)."""
    import jax
    import jax.numpy as jnp
    import torch

    from hvs_tpu.data import device_pipeline as jdp
    from hvs_tpu.training import losses as jl
    from hvs_tpu_torch.convert import export_flax_params, flatten
    from hvs_tpu_torch.models import HybridVisionSystem

    arrays = shapes_arrays(args.images, args.image_size, args.seed)
    jdata = jdp.DeviceData(*(jnp.asarray(a) for a in arrays))
    batch = jdp.eval_batch(jdata, 0, 2 * args.batch, args.size)
    grids = [(args.size // s, args.size // s) for s in (8, 16, 32)]
    targets = jl.build_targets(batch["boxes"], batch["labels"], batch["box_mask"], grids,
                               NUM_CLASSES)
    model = jax_model("fp32", False)
    loss = jax.jit(lambda p: jl.mhc_yolo_loss(model.apply({"params": p}, batch["images"],
                                                          task="detection")["detection"]["raw"],
                                              targets, NUM_CLASSES)[0])
    losses, stats = [], {}
    for seed in seeds:
        jp = jax_init(model, 640, seed)
        tp = export_flax_params(HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32,
                                                   device="cpu", seed=seed))
        losses.append({"seed": seed, "jax_init": float(loss(jp)),
                       "port_init": float(loss(jax.tree_util.tree_map(jnp.asarray, tp)))})
        jf, tf = flatten(jp), flatten(tp)
        for k in jf:
            stats.setdefault(k, []).append((jf[k].mean(), jf[k].std(), tf[k].mean(), tf[k].std()))
    apart = []
    for k, v in stats.items():
        jm, js, tm, ts = np.asarray(v, np.float64).mean(0)
        if abs(ts - js) > 0.05 * js + 1e-7 or abs(tm - jm) > 0.05 * max(js, 1e-3) + 1e-6:
            apart.append({"param": k, "jax_mean": jm, "jax_std": js, "port_mean": tm,
                          "port_std": ts, "size": int(np.prod(jf[k].shape))})
    record = {"losses": losses, "params": len(stats), "apart": apart}
    print(json.dumps(record, indent=1), flush=True)
    return record


# ---------------------------------------------------------------------------
# layer


def _corr(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a, b = a - a.mean(), b - b.mean()
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


def run_layer(args, widths=(32, 64, 256)):
    """One bf16 mHC training layer (expansion 1, dropout off, JAX's init) on
    inputs with a large common mode (3 ± 0.3): the correlation of JAX's
    jitted output, and of the port's, with JAX's fp32 output, and of the
    port's with JAX's bf16 one (``tests/test_torch_train_trajectory.py``
    holds the same layer)."""
    import jax
    import jax.numpy as jnp
    import torch

    from hvs_tpu.models.layers import ManifoldHyperConnection as JaxMHC
    from hvs_tpu_torch.convert import load_flax_params
    from hvs_tpu_torch.models.layers import ManifoldHyperConnection

    rows = []
    for d in widths:
        r = np.random.default_rng(d)
        x = jnp.asarray(3.0 + 0.3 * r.standard_normal((2, 8, 8, d)), jnp.bfloat16)
        jm = JaxMHC(dim=d, expansion_rate=1, mlp_ratio=1, dtype=jnp.bfloat16, dropout_rate=0.0)
        variables = jax.jit(jm.init)(jax.random.PRNGKey(d), x[:1])
        bf16 = np.asarray(jax.jit(jm.apply)(variables, x), np.float32)
        fp32 = np.asarray(jax.jit(jm.clone(dtype=jnp.float32).apply)(
            variables, x.astype(jnp.float32)), np.float32)
        layer = ManifoldHyperConnection(d, 1, 1, dtype=torch.bfloat16, dropout_rate=0.0)
        load_flax_params(layer, jax.device_get(variables["params"]))
        layer.train()
        with torch.no_grad():
            port = layer(torch.from_numpy(np.asarray(x, np.float32)).bfloat16()).float().numpy()
        rows.append({"d": d, "jax_bf16_to_fp32": _corr(bf16, fp32),
                     "port_to_fp32": _corr(port, fp32), "port_to_jax_bf16": _corr(port, bf16)})
    print(json.dumps(rows, indent=1), flush=True)
    return rows


def main(argv=None):
    args = parse_args(argv)
    import torch

    torch.set_num_threads(args.threads)
    if args.device == "cuda":
        if args.mode != "trajectory":
            raise SystemExit("--device cuda runs the trajectory mode only")
        import chip_smoke
        from hvs_tpu_torch import build

        build.build(["mhc_block", "sinkhorn"])
        launches = chip_smoke.phase_train_trajectory(
            chip_smoke.card_line(), steps=args.steps,
            sizes=(args.size, args.size2) if args.size2 else (args.size,), batch=args.batch,
            warmup=args.warmup)
        print(json.dumps({"launches": launches}))
        return
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.jax_cache:
        jax.config.update("jax_compilation_cache_dir", args.jax_cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    record = {"mode": args.mode, "args": vars(args)}
    if args.mode == "step":
        record["step"] = run_step(args)
    elif args.mode == "trajectory":
        record["trajectory"] = run_trajectory(args)
    elif args.mode == "init":
        record["init"] = run_init(args)
    else:
        record["layer"] = run_layer(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
