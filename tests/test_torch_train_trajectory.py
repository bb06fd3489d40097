"""The port's training held against JAX beyond one step, and the bf16
numerics of the mHC training layer against XLA's, on the CPU.

* A trajectory of 8 steps in 4 chunks through both trainers' chunk bodies
  (JAX: ``sample_batch`` on ``fold_in(fold_in(rng, chunk), step)`` then
  ``make_train_step``, as ``make_train_chunk`` composes them; the port:
  ``TrainChunk`` fed the same draws), alternating two sizes by chunk,
  crossing the end of the warm-up and two ``project_every`` steps, with the
  EMA on. The tiny model of ``scripts/train.py --tiny`` in fp32, dropout off.
* XLA compiles JAX's bf16 mHC layer with each product rounded to bf16 and
  ``x @ H_res + y @ H_post`` and LN2 in fp32: the port's training layer must
  do the same, or LN2 normalises rounding noise where the sum's spread lies
  under one bf16 step of its mean.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.data import device_pipeline as jdp
from hvs_tpu.models import HybridVisionSystem as JaxHybridVisionSystem
from hvs_tpu.models.layers import ManifoldHyperConnection as JaxMHC
from hvs_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from hvs_tpu.training.trainer import TrainState, make_train_step
from hvs_tpu.training.optimizer import make_optimizer
from hvs_tpu.training.schedule import cosine_annealing_with_warmup
from hvs_tpu_torch.convert import flatten, load_flax_params, to_flax_layout
from hvs_tpu_torch.data import device_pipeline as tdp
from hvs_tpu_torch.models import HybridVisionSystem
from hvs_tpu_torch.models.layers import Dropout, ManifoldHyperConnection
from hvs_tpu_torch.train import TINY
from hvs_tpu_torch.training.chunk import TrainChunk
from hvs_tpu_torch.training.trainer import ManifoldConstrainedTrainer, TrainerConfig

torch.set_num_threads(1)

# tests/test_torch_train.py's end-to-end tolerance (fp32 through the model,
# sums in other orders in XLA and PyTorch), held over every step.
RTOL, ATOL = 2e-3, 5e-3
NUM_CLASSES, N, S, M, B = 8, 8, 96, 8, 2
SIZES, CHUNK, STEPS = (64, 96), 2, 8
CONFIG = dict(num_classes=NUM_CLASSES, warmup_steps=3, total_steps=20, project_every=3,
              ema_decay=0.9, sk_iters=TINY["sk_iters"], max_boxes=M)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _dataset():
    r = np.random.default_rng(3)
    images = r.integers(0, 256, (N, S, S, 3), dtype=np.uint8)
    wh = r.uniform(0.1, 0.5, (N, M, 2))
    boxes = np.concatenate([r.uniform(wh / 2, 1 - wh / 2), wh], -1).astype(np.float32)
    labels = r.integers(0, NUM_CLASSES, (N, M)).astype(np.int32)
    mask = (r.uniform(size=(N, M)) > 0.4).astype(np.float32)
    return images, boxes, labels, mask


def _plan():
    """(chunk, size) of every step: sizes alternate by chunk."""
    return [(i // CHUNK, SIZES[(i // CHUNK) % len(SIZES)]) for i in range(STEPS)]


def _key(step, chunk):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), chunk), step)


def _draws(rng, aug):
    """``sample_batch``'s draws on ``rng`` as the port's ``AugmentDraws``."""
    k_idx, k_flip, k_bright, k_con, k_gain, k_zoom, k_tx, k_ty = jax.random.split(rng, 8)
    u = jax.random.uniform
    d = dict(idx=jax.random.randint(k_idx, (B,), 0, N),
             flip=jax.random.bernoulli(k_flip, aug.flip_prob, (B,)),
             brightness=u(k_bright, (B, 1, 1, 1), minval=-aug.brightness, maxval=aug.brightness),
             contrast=u(k_con, (B, 1, 1, 1), minval=1 - aug.contrast, maxval=1 + aug.contrast),
             gain=u(k_gain, (B, 1, 1, 3), minval=1 - aug.channel_gain,
                    maxval=1 + aug.channel_gain),
             zoom=u(k_zoom, (B,), minval=aug.zoom_min, maxval=aug.zoom_max),
             tx=u(k_tx, (B,)), ty=u(k_ty, (B,)))
    return tdp.AugmentDraws(**{k: torch.from_numpy(np.array(v)).to(
        torch.long if k == "idx" else None) for k, v in d.items()})


class _Deterministic(JaxHybridVisionSystem):
    """The JAX model with dropout off in the train step (the heads' mHC
    layers keep their own rate, so only ``deterministic`` turns it off)."""

    def __call__(self, images, task="detection", deterministic=True):
        return super().__call__(images, task, True)


@pytest.fixture(scope="module")
def jax_trajectory():
    jm = _Deterministic(num_classes=NUM_CLASSES, dtype=jnp.float32, monitor=True, **TINY)
    arrays = _dataset()
    jdata = jdp.DeviceData(*(jnp.asarray(a) for a in arrays))
    params = jax.jit(functools.partial(jm.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.zeros((1, max(SIZES), max(SIZES), 3)))["params"]
    cfg = JaxTrainerConfig(**CONFIG)
    tx = make_optimizer(cosine_annealing_with_warmup(cfg.learning_rate, cfg.warmup_steps,
                                                     cfg.total_steps),
                        weight_decay=cfg.weight_decay, mhc_lr_factor=cfg.mhc_lr_factor,
                        clip_regular=cfg.clip_regular, clip_mhc=cfg.clip_mhc,
                        project_every=cfg.project_every, sk_iters=cfg.sk_iters)
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=tx,
                              lr_scale=jnp.ones([], jnp.float32),
                              ema_params=jax.tree_util.tree_map(jnp.copy, params))
    state = state.replace(step=jnp.zeros((), jnp.int32))
    step_fn = make_train_step(jm, cfg)
    aug = jdp.AugmentConfig()
    fns, rows, draws = {}, [], []
    for i, (ci, size) in enumerate(_plan()):
        if size not in fns:
            fns[size] = jax.jit(lambda st, data, key, size=size: step_fn(
                st, jdp.sample_batch(data, key, B, size, aug, augment=True), key))
        key = _key(i, ci)
        draws.append(_draws(key, aug))
        state, m = fns[size](state, jdata, key)
        rows.append({k: float(v) for k, v in jax.device_get(m).items()})
    return dict(arrays=arrays, params=jax.device_get(params), rows=rows, draws=draws,
                final=flatten(jax.device_get(state.params)),
                ema=flatten(jax.device_get(state.ema_params)))


def test_trajectory_over_chunks_sizes_warmup_and_projections_matches_jax(jax_trajectory):
    want = jax_trajectory
    model = HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32, monitor=True,
                               device="cpu", **TINY)
    load_flax_params(model, want["params"])
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    trainer = ManifoldConstrainedTrainer(model, TrainerConfig(**CONFIG), device="cpu")
    trainer.init_state()
    data = tdp.put_device_data(*want["arrays"], device="cpu")
    chunks = {size: TrainChunk(trainer, data, size, B, CHUNK, tdp.AugmentConfig())
              for size in SIZES}
    rows = []
    for i, (ci, size) in enumerate(_plan()):
        chunk = chunks[size]
        if i % CHUNK == 0:
            chunk.pos.zero_()
        chunk.step(want["draws"][i])
        if (i + 1) % CHUNK == 0:
            host = chunk.pull()
            rows += [{k: float(v[j]) for k, v in host.items()} for j in range(CHUNK)]
    assert int(trainer.tx.count) == STEPS
    schedule = trainer.schedule
    for i, (got, row) in enumerate(zip(rows, want["rows"])):
        for k in ("loss", "detection_loss", "box_loss", "obj_loss", "cls_loss",
                  "num_positives", "grad_norm", "manifold_ds", "ds_error_max"):
            _close(got[k], row[k], msg=f"step {i + 1}: {k}")
        _close(got["lr"], schedule(i), rtol=1e-6, atol=0, msg=f"step {i + 1}: lr")
    assert rows[2]["lr"] < rows[3]["lr"] == pytest.approx(1e-3)  # warm-up ends at count 3
    for name, p in want["final"].items():
        _close(to_flax_layout(name, trainer.params()[name].detach().numpy()), p, msg=name)
    for name, e in want["ema"].items():
        _close(to_flax_layout(name, trainer.state.ema_params[name].numpy()), e, msg=f"ema {name}")
    # The projections at counts 3 and 6 landed: every H_res_raw is the log of
    # a doubly stochastic matrix up to the later updates, on both sides.
    h = trainer.params()["fpn.mhc0.H_res_raw"].detach().exp()
    assert float((h.sum(0) - 1).abs().max()) < 0.05


def _corr(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a, b = a - a.mean(), b - b.mean()
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


@pytest.mark.parametrize("d", [32, 64, 256])
def test_training_mhc_layer_sums_the_products_in_fp32_as_xla(d):
    """XLA compiles JAX's bf16 layer with each product rounded to bf16 and
    ``x @ H_res + y @ H_post`` and LN2 in fp32. On inputs with a large common
    mode (3 ± 0.3), the init H_res (near uniform) and H_post (near 1) leave
    the sum's spread across channels under one bf16 step of its mean, where
    a rounded sum feeds LN2 noise: the port's training layer must then agree
    with JAX's jitted layer (the parent rounded the sum: correlation
    0.63-0.78) and lie exactly as far from the fp32 layer as JAX's does
    (the parent: 0.17-0.32 further)."""
    r = np.random.default_rng(d)
    x = jnp.asarray(3.0 + 0.3 * r.standard_normal((2, 8, 8, d)), jnp.bfloat16)
    jm = JaxMHC(dim=d, expansion_rate=1, mlp_ratio=1, dtype=jnp.bfloat16, dropout_rate=0.0)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(d), x[:1])
    want = np.asarray(jax.jit(jm.apply)(variables, x), np.float32)
    exact = np.asarray(jax.jit(jm.clone(dtype=jnp.float32).apply)(
        variables, x.astype(jnp.float32)), np.float32)

    layer = ManifoldHyperConnection(d, 1, 1, dtype=torch.bfloat16, dropout_rate=0.0)
    load_flax_params(layer, jax.device_get(variables["params"]))
    layer.train()
    with torch.no_grad():
        got = layer(torch.from_numpy(np.asarray(x, np.float32)).bfloat16()).float().numpy()
    assert _corr(got, want) > 0.95
    assert abs(_corr(got, exact) - _corr(want, exact)) < 0.01
