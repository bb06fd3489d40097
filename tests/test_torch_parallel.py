"""The port's data parallelism (``hvs_tpu_torch/parallel``, the data-parallel
train step, ``ShardedDataLoader``) against one process and against the JAX
package, on the CPU.

Two ``gloo`` processes, each with its own time limit, take one train step on
the two halves of a global batch whose halves hold different numbers of
positives; the step must equal the one-process step on the whole batch and
JAX's train step on it. The tiny model of ``scripts/train.py --tiny`` in
fp32, dropout off (as ``tests/test_torch_train.py``).
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hvs_tpu.data.loader import _ShardView as JaxShardView
from hvs_tpu.models import HybridVisionSystem as JaxHybridVisionSystem
from hvs_tpu.parallel import make_mesh as jax_make_mesh
from hvs_tpu.parallel import param_sharding as jax_param_sharding
from hvs_tpu.parallel import sharded_fraction as jax_sharded_fraction
from hvs_tpu.training import losses as jlosses
from hvs_tpu.training import schedule as jschedule
from hvs_tpu.training.optimizer import make_optimizer
from hvs_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from hvs_tpu.training.trainer import global_norm as jax_global_norm
from hvs_tpu_torch.convert import flatten, load_flax_params, to_flax_layout
from hvs_tpu_torch.data.loader import ShardedDataLoader, _ShardView
from hvs_tpu_torch.models import HybridVisionSystem
from hvs_tpu_torch.models.layers import Dropout
from hvs_tpu_torch.parallel import (DEFAULT_PARAM_RULES, Mesh, PartitionSpec, make_mesh,
                                    param_sharding, shard_batch, sharded_fraction)
from hvs_tpu_torch.train import TINY
from hvs_tpu_torch.training import losses as tlosses
from hvs_tpu_torch.training.trainer import (ManifoldConstrainedTrainer, TrainerConfig,
                                            batch_to, train_step)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES, IMAGE, WORLD = 8, 64, 2
# One process against two: the same sums in another order (the gradient
# all-reduce adds the halves' gradients; one process reduces over the whole
# batch), so equal to fp32 rounding.
DP_RTOL, DP_ATOL = 1e-5, 1e-6
# Adam's first update is lr·g / (|g| + 1e-8), about lr·sign(g): an entry
# whose gradient is rounding noise (|g| under 1e-6 of the global norm, e.g.
# the attention keys' directions that the softmax cancels) can move by up to
# 2·lr either way; every other entry is held to DP_RTOL.
NOISE_GRAD = 1e-6
LR = 1e-3
# tests/test_torch_train.py's end-to-end tolerance against JAX.
RTOL, ATOL = 2e-3, 5e-3
WORKER_TIMEOUT = 300  # seconds per process


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# Mesh, batch sharding, sharding rules, the sharded loader


def test_make_mesh_shapes_and_validation():
    mesh = make_mesh(n_data=4, n_model=2, devices=range(8))
    assert mesh.shape == {"data": 4, "model": 2} and not mesh.distributed
    mesh = make_mesh()  # no process group: this process alone, pure data parallelism
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    with pytest.raises(AssertionError):
        make_mesh(n_data=3, n_model=2, devices=range(8))  # 6 != 8, as JAX's


def test_shard_batch_takes_the_rank_slice():
    batch = {"x": np.arange(32, dtype=np.float32).reshape(16, 2),
             "y": np.arange(16, dtype=np.int32)}
    for rank in range(4):
        got = shard_batch(Mesh(data=4, rank=rank), batch, device="cpu")
        assert got["x"].shape == (4, 2)
        np.testing.assert_array_equal(got["y"].numpy(), np.arange(4 * rank, 4 * rank + 4))
    whole = shard_batch(make_mesh(), batch, device="cpu")
    np.testing.assert_array_equal(whole["y"].numpy(), batch["y"])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(Mesh(data=3), batch, device="cpu")


def test_param_sharding_matches_jax_rules_on_the_flagship():
    """The rule table picks out the same parameters of the flagship (8
    classes) as JAX's rules, with the same specs, so ``sharded_fraction``
    agrees (the counterpart of tests/test_parallel.py's real-model test)."""
    from hvs_tpu.config import ModelConfig

    mcfg = ModelConfig()
    mcfg.detection.num_classes = NUM_CLASSES
    jm = mcfg.build_model()
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, task="detection"),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))["params"]
    jspecs = jax_param_sharding(jax_make_mesh(n_data=4, n_model=2), shapes)
    jflat = {".".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
             for path, s in jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: hasattr(x, "spec"))[0]}
    model = HybridVisionSystem(num_classes=NUM_CLASSES, device="cpu")
    params = dict(model.named_parameters())
    specs = param_sharding(Mesh(data=4, model=2), params)
    assert set(specs) == set(jflat)
    for name, spec in specs.items():
        # A conv kernel's axes are OIHW here and HWIO in flax; no rule names one.
        want = jflat[name]
        want = tuple(want) + (None,) * (len(params[name].shape) - len(want)) if want else ()
        assert tuple(spec) == tuple(want) or (not spec and not any(want)), name
    sharded = {n for n, s in specs.items() if any(a is not None for a in s)}
    assert sharded == {n for n, s in jflat.items() if any(a is not None for a in s)}
    got = sharded_fraction(specs, params)
    want = jax_sharded_fraction(jspecs, shapes)
    assert got["sharded_params"] == want["sharded_params"] >= 40
    assert got["total_params"] == want["total_params"]
    assert abs(got["sharded_bytes_fraction"] - want["sharded_bytes_fraction"]) < 1e-12
    # Without a model axis every parameter is replicated.
    assert all(s == PartitionSpec() for s in param_sharding(Mesh(data=8), params).values())
    assert set(DEFAULT_PARAM_RULES) == {"qkv.kernel", "proj.kernel", "mlp_in_kernel",
                                        "mlp_out_kernel", "H_pre_raw", "H_post_raw"}


class _Items:
    """A dataset whose sample i records i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.array([i], np.int64)}


@pytest.mark.parametrize("n,shards", [(10, 3), (16, 4), (7, 2)])
def test_sharded_loader_indices_match_jax_shard_view(n, shards):
    """Each process reads its contiguous shard; the remainder is dropped."""
    data = _Items(n)
    for shard in range(shards):
        want = [JaxShardView(data, shard, shards)[i]["i"][0]
                for i in range(len(JaxShardView(data, shard, shards)))]
        view = _ShardView(data, shard, shards)
        assert [view[i]["i"][0] for i in range(len(view))] == want
        loader = ShardedDataLoader(data, Mesh(data=shards, rank=shard), per_process_batch=1,
                                   shuffle=False, num_workers=1, device_put=False)
        assert [int(b["i"][0, 0]) for b in loader] == want
    loader = ShardedDataLoader(data, Mesh(data=shards, rank=0), per_process_batch=1,
                               shuffle=False, num_workers=1, device="cpu")
    first = next(iter(loader))
    assert isinstance(first["i"], torch.Tensor) and int(first["i"][0, 0]) == 0


def test_setup_joins_before_it_takes_the_card(monkeypatch):
    """Under torchrun on two cards, the process of rank 1 joins an NCCL group
    and gets card 1 (``LOCAL_RANK``), made current before the group is
    joined, and the mesh's place 1 of 2. The card and the process group are
    stood in for, so the order shows here."""
    import types

    import torch.distributed as dist

    from hvs_tpu_torch.parallel import setup

    calls, current, joined = [], [0], [False]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])

    def set_device(d):
        current[0] = torch.device(d).index
        calls.append(("set_device", current[0]))

    def init_process_group(backend, init_method, world_size, rank):
        calls.append(("init_process_group", backend, init_method, world_size, rank))
        joined[0] = True

    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(dist, "is_initialized", lambda: joined[0])
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "group", types.SimpleNamespace(WORLD="world"))
    for k, v in {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": "29511"}.items():
        monkeypatch.setenv(k, v)
    mesh, device = setup(None)
    assert device == torch.device("cuda", 1)
    assert calls == [("set_device", 1),
                     ("init_process_group", "nccl", "tcp://127.0.0.1:29511", 2, 1)]
    assert mesh == Mesh(data=2, model=1, rank=1, group="world")


class _Stop(Exception):
    pass


@pytest.mark.parametrize("entry", ["train", "train_device", "train_multitask"])
def test_entry_points_train_on_the_device_setup_returns(entry, monkeypatch, tmp_path):
    """Each training entry point joins the processes through
    ``parallel.setup`` and hands its trainer the mesh and the device that
    ``setup`` returned (this process's card under torchrun), not a device
    resolved before the join."""
    import importlib

    import hvs_tpu_torch.parallel as parallel
    import hvs_tpu_torch.training as training

    seen = {}
    real_setup = parallel.setup

    def spy_setup(*args, **kwargs):
        seen["setup"] = real_setup(*args, **kwargs)
        return seen["setup"]

    class Trainer:
        def __init__(self, model, config, device=None, seed=0, mesh=None):
            seen["trainer"] = (mesh, torch.device(device))
            raise _Stop

    monkeypatch.setattr(parallel, "setup", spy_setup)
    monkeypatch.setattr(training, "ManifoldConstrainedTrainer", Trainer)
    argv = {"train": ["--synthetic", "--tiny", "--steps", "1", "--epochs", "1",
                      "--checkpoint-dir", str(tmp_path / "ckpt"),
                      "--log-dir", str(tmp_path / "logs")],
            "train_device": ["--synthetic", "4", "--tiny", "--run-dir", str(tmp_path / "run")],
            "train_multitask": ["--synthetic", "4", "--tiny", "--size", "64", "--num-val", "4",
                                "--output", str(tmp_path / "report.json")]}[entry]
    with pytest.raises(_Stop):
        importlib.import_module(f"hvs_tpu_torch.{entry}").main(argv + ["--device", "cpu"])
    mesh, device = seen["setup"]
    assert seen["trainer"][0] is mesh and seen["trainer"][1] == device == torch.device("cpu")


# ---------------------------------------------------------------------------
# The data-parallel step over two gloo processes


def _global_batch():
    """Four 64² images: two with four boxes each, two with one, each box in
    its own quadrant (no two boxes share a cell at any scale), so the
    halves of the batch hold 8 and 2 positives."""
    r = np.random.default_rng(5)
    images = r.standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    boxes = np.zeros((4, 4, 4), np.float32)
    mask = np.zeros((4, 4), np.float32)
    quadrants = [(0.25, 0.25), (0.75, 0.25), (0.25, 0.75), (0.75, 0.75)]
    for i, count in enumerate((4, 4, 1, 1)):
        for j in range(count):
            w, h = r.uniform(0.08, 0.45, 2)
            cx, cy = quadrants[j]
            boxes[i, j] = (cx + r.uniform(-0.05, 0.05), cy + r.uniform(-0.05, 0.05), w, h)
            mask[i, j] = 1.0
    labels = r.integers(0, NUM_CLASSES, (4, 4)).astype(np.int32)
    return {"images": images, "boxes": boxes, "labels": labels, "box_mask": mask}


def _config():
    return dict(num_classes=NUM_CLASSES, warmup_steps=0, total_steps=100,
                backbone_lr_factor=0.1, sk_iters=TINY["sk_iters"], max_boxes=4)


def _tiny_trainer(params, mesh=None):
    model = HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32, monitor=True,
                               device="cpu", **TINY)
    load_flax_params(model, params)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    trainer = ManifoldConstrainedTrainer(model, TrainerConfig(**_config()), device="cpu",
                                         mesh=mesh)
    trainer.init_state()
    return trainer


@pytest.fixture(scope="module")
def dp_reference():
    """The tiny JAX model's init, the global batch, and JAX's train step on
    the whole batch (the loss and gradients as ``make_train_step`` composes
    them, dropout off; the optax chain)."""
    jm = JaxHybridVisionSystem(num_classes=NUM_CLASSES, dtype=jnp.float32, monitor=True, **TINY)
    batch = _global_batch()
    params = jax.device_get(jax.jit(functools.partial(jm.init, task="detection"))(
        jax.random.PRNGKey(0), jnp.asarray(batch["images"]))["params"])
    cfg = JaxTrainerConfig(**_config())
    tx = make_optimizer(jschedule.cosine_annealing_with_warmup(cfg.learning_rate, 0, 100),
                        weight_decay=cfg.weight_decay, mhc_lr_factor=cfg.mhc_lr_factor,
                        clip_regular=cfg.clip_regular, clip_mhc=cfg.clip_mhc,
                        project_every=cfg.project_every, sk_iters=cfg.sk_iters,
                        backbone_lr_factor=cfg.backbone_lr_factor)
    grids = [(IMAGE // s, IMAGE // s) for s in (8, 16, 32)]

    @jax.jit
    def run(params, batch):
        targets = jlosses.build_targets(batch["boxes"], batch["labels"], batch["box_mask"],
                                        grids, NUM_CLASSES)

        def loss_fn(p):
            out, _ = jm.apply({"params": p}, batch["images"], task="detection",
                              deterministic=True, mutable=["stability"])
            det, det_m = jlosses.mhc_yolo_loss(out["detection"]["raw"], targets, NUM_CLASSES)
            reg, _ = jlosses.manifold_regularization_loss(p, sk_iters=cfg.sk_iters)
            return det + cfg.manifold_reg_alpha * reg, (det_m, det)

        (loss, (det_m, det)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        metrics = {**det_m, "detection_loss": det, "loss": loss,
                   "grad_norm": jax_global_norm(grads)}
        return metrics, optax.apply_updates(params, updates), targets

    metrics, new_params, targets = jax.device_get(
        run(params, {k: jnp.asarray(v) for k, v in batch.items()}))
    assigned = [int(np.asarray(t["obj"]).reshape(4, -1)[i].sum())
                for t in targets.values() for i in range(4)]
    assert sum(assigned) == int(batch["box_mask"].sum()) == 10  # no collisions
    return dict(params=params, batch=batch, metrics=metrics, new_params=flatten(new_params))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, mode):
    """``WORLD`` gloo processes running this file's ``_worker`` on the
    inputs in ``tmp_path``; each has its own time limit. Returns rank 0's
    results."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(rank),
                               str(WORLD), str(port), str(tmp_path)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    with open(tmp_path / "rank0.json") as f:
        return json.load(f)


def test_data_parallel_step_equals_one_process_and_jax(dp_reference, tmp_path):
    want = dp_reference
    batch = want["batch"]
    np.savez(tmp_path / "inputs.npz", **{f"param:{k}": v for k, v in
                                         flatten(want["params"]).items()},
             **{f"batch:{k}": v for k, v in batch.items()})

    # One process on the whole batch.
    one = _tiny_trainer(want["params"])
    m1, g1 = train_step(one.model, one.tx, one.config, one.state,
                        batch_to(batch, torch.device("cpu")), mesh=one.mesh)
    m1 = {k: float(v) for k, v in m1.items()}
    p1 = {k: to_flax_layout(k, v.detach().numpy()) for k, v in one.params().items()}

    got = _run_workers(tmp_path, "detection")
    assert got["positives_per_rank"] == [8.0, 2.0]
    for k in ("loss", "detection_loss", "box_loss", "obj_loss", "cls_loss", "num_positives",
              "grad_norm", "lr", "manifold_ds", "ds_error_max"):
        _close(got["metrics"][k], m1[k], DP_RTOL, 0.0, msg=k)
    # Telemetry, not the loss: each process's ratio of mean norms, averaged
    # over the processes (a ratio of means does not add up across them).
    _close(got["metrics"]["signal_ratio_mean"], m1["signal_ratio_mean"], 2e-3, 0.0)
    grads = dict(np.load(tmp_path / "rank0_grads.npz"))
    for name, value in g1.items():
        _close(grads[name], value.numpy(), DP_RTOL, DP_ATOL * m1["grad_norm"], msg=f"grad {name}")
    params = dict(np.load(tmp_path / "rank0_params.npz"))
    for name, value in p1.items():
        signal = np.abs(to_flax_layout(name, g1[name].numpy())) > NOISE_GRAD * m1["grad_norm"]
        _close(params[name][signal], value[signal], DP_RTOL, DP_ATOL, msg=name)
        _close(params[name], value, 0.0, 2 * LR, msg=name)
    # Both processes hold the same parameters after the step.
    assert got["max_param_gap_between_ranks"] == 0.0

    # The trap: the mean of per-process losses (each divided by its own
    # positives) is another loss, beyond the tolerance above.
    halves = []
    for rank in range(WORLD):
        part = shard_batch(Mesh(data=WORLD, rank=rank), batch, device="cpu")
        t = _tiny_trainer(want["params"])
        with torch.no_grad():
            t.model.train()
            out = t.model(part["images"])
            targets = tlosses.build_targets(part["boxes"], part["labels"], part["box_mask"],
                                            [(IMAGE // s, IMAGE // s) for s in (8, 16, 32)],
                                            NUM_CLASSES)
            det, _ = tlosses.mhc_yolo_loss(out["detection"]["raw"], targets, NUM_CLASSES)
            reg, _ = tlosses.manifold_regularization_loss(t.params(), sk_iters=TINY["sk_iters"])
        halves.append(float(det + t.config.manifold_reg_alpha * reg))
    mean_of_ranks = np.mean(halves)
    assert abs(mean_of_ranks - m1["loss"]) > 100 * DP_RTOL * abs(m1["loss"]), \
        (mean_of_ranks, m1["loss"])

    # And the data-parallel step is JAX's step on the global batch.
    for k in ("loss", "detection_loss", "box_loss", "obj_loss", "cls_loss", "num_positives",
              "grad_norm"):
        _close(got["metrics"][k], float(want["metrics"][k]), RTOL, ATOL, msg=f"jax {k}")
    for name, value in want["new_params"].items():
        _close(params[name], value, RTOL, ATOL, msg=f"jax {name}")


def test_data_parallel_multi_task_loss_equals_the_global_batch(tmp_path):
    """``multi_task_loss`` with its statistics summed over two processes:
    the processes' losses sum to the loss of the whole batch, and their
    gradients (with respect to the heads' outputs) are the whole batch's,
    the class-balanced segmentation weights and the Dice term included."""
    r = np.random.default_rng(11)
    b, h, k = 4, 8, NUM_CLASSES + 1
    outputs = {"segmentation": r.standard_normal((b, h, h, k)).astype(np.float32),
               "depth": r.uniform(0.2, 3.0, (b, h, h, 1)).astype(np.float32),
               "classification": r.standard_normal((b, NUM_CLASSES)).astype(np.float32)}
    seg = r.integers(0, k, (b, 2 * h, 2 * h)).astype(np.uint8)
    seg[2:] = np.where(seg[2:] > 3, 0, seg[2:])  # the halves hold other classes
    batch = {"seg_labels": seg, "depth": r.uniform(0.2, 3.0, (b, 2 * h, 2 * h)).astype(np.float32),
             "class_labels": r.integers(0, NUM_CLASSES, b).astype(np.int64)}
    np.savez(tmp_path / "mt_inputs.npz", **{f"out:{n}": v for n, v in outputs.items()},
             **{f"batch:{n}": v for n, v in batch.items()})
    leaves = {n: torch.from_numpy(v).requires_grad_() for n, v in outputs.items()}
    loss, metrics = tlosses.multi_task_loss(leaves, {n: torch.from_numpy(v)
                                                     for n, v in batch.items()}, NUM_CLASSES)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    got = _run_workers(tmp_path, "multi_task")
    _close(got["loss"], float(loss), DP_RTOL, 0.0, msg="loss")
    for name in ("segmentation_loss", "segmentation_dice_loss", "depth_loss",
                 "classification_loss"):
        _close(got["metrics"][name], float(metrics[name]), DP_RTOL, DP_ATOL, msg=name)
    parts = dict(np.load(tmp_path / "mt_grads.npz"))
    for name, g in zip(leaves, grads):
        _close(parts[name], g.numpy(), DP_RTOL, 1e-8, msg=f"grad {name}")


# ---------------------------------------------------------------------------
# The worker processes (run as ``python tests/test_torch_parallel.py MODE RANK
# WORLD PORT DIR``)


def _worker(mode, rank, world, port, tmp):
    import pathlib

    import torch.distributed as dist

    from hvs_tpu_torch.config.training import DistributedConfig
    from hvs_tpu_torch.convert import nest
    from hvs_tpu_torch.parallel import setup

    tmp = pathlib.Path(tmp)
    mesh, device = setup("cpu", DistributedConfig(enabled=True,
                                                  coordinator_address=f"127.0.0.1:{port}",
                                                  num_processes=world, process_id=rank))
    assert mesh.distributed and mesh.shape == {"data": world, "model": 1} and mesh.rank == rank
    assert device == torch.device("cpu") and dist.get_backend() == "gloo"
    if mode == "detection":
        data = np.load(tmp / "inputs.npz")
        params = nest({k[len("param:"):]: data[k] for k in data.files if k.startswith("param:")})
        batch = {k[len("batch:"):]: data[k] for k in data.files if k.startswith("batch:")}
        trainer = _tiny_trainer(params, mesh=mesh)
        part = shard_batch(mesh, batch, "cpu")
        positives = float(part["box_mask"].sum())
        metrics, grads = train_step(trainer.model, trainer.tx, trainer.config, trainer.state,
                                    part, mesh=mesh)
        metrics = {k: float(v) for k, v in metrics.items()}
        counts = [None] * world
        dist.all_gather_object(counts, positives)
        flat = torch.cat([p.detach().reshape(-1) for p in trainer.params().values()])
        first = flat.clone()
        dist.broadcast(first, src=0)
        gap = torch.tensor(float((flat - first).abs().max()))
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        if rank == 0:
            np.savez(tmp / "rank0_grads.npz", **{k: v.numpy() for k, v in grads.items()})
            np.savez(tmp / "rank0_params.npz",
                     **{k: to_flax_layout(k, v.detach().numpy())
                        for k, v in trainer.params().items()})
            with open(tmp / "rank0.json", "w") as f:
                json.dump({"metrics": metrics, "positives_per_rank": counts,
                           "max_param_gap_between_ranks": float(gap)}, f)
    else:
        data = np.load(tmp / "mt_inputs.npz")
        half = slice(rank * 4 // world, (rank + 1) * 4 // world)
        outs = {k[len("out:"):]: torch.from_numpy(data[k][half]).requires_grad_()
                for k in data.files if k.startswith("out:")}
        batch = {k[len("batch:"):]: torch.from_numpy(data[k][half])
                 for k in data.files if k.startswith("batch:")}
        loss, metrics = tlosses.multi_task_loss(outs, batch, NUM_CLASSES, mesh=mesh)
        grads = torch.autograd.grad(loss, list(outs.values()))
        total = mesh.all_sum(torch.stack([loss.detach()] + [
            metrics[k].detach() for k in ("segmentation_loss", "segmentation_dice_loss",
                                          "depth_loss", "classification_loss")]))
        gathered = {}
        for name, g in zip(outs, grads):
            parts = [torch.empty_like(g) for _ in range(world)]
            dist.all_gather(parts, g.contiguous())
            gathered[name] = torch.cat(parts).numpy()
        if rank == 0:
            np.savez(tmp / "mt_grads.npz", **gathered)
            names = ("segmentation_loss", "segmentation_dice_loss", "depth_loss",
                     "classification_loss")
            with open(tmp / "rank0.json", "w") as f:
                json.dump({"loss": float(total[0]),
                           "metrics": {n: float(total[i + 1]) for i, n in enumerate(names)}},
                          f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
