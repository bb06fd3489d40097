"""The port's tensor parallelism (``hvs_tpu_torch/parallel/tensor.py``, the
sharded layers, the trainer over a ``(data x model)`` mesh) against JAX's
sharded train step and against one process, on the CPU.

Gloo processes, each with its own time limit, run this file's ``_worker``:
a 1 x 2 mesh (two processes, one model group) and a 2 x 2 mesh (four
processes) take one train step of the tiny model of ``scripts/train.py
--tiny`` (fp32, dropout off, weights converted from JAX's init) on a global
batch whose halves hold different numbers of positives. JAX's reference is
its own sharded step: ``make_mesh(n_data=2, n_model=2)`` over four of the
eight virtual CPU devices with ``param_sharding`` applied, as
``tests/test_training.py``'s cross-topology test places it. The 2 x 2 run's
checkpoint is restored into a 2 x 1 data-parallel mesh and into one
process.
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

from hvs_tpu.models import HybridVisionSystem as JaxHybridVisionSystem
from hvs_tpu.parallel import make_mesh as jax_make_mesh
from hvs_tpu.parallel import param_sharding as jax_param_sharding
from hvs_tpu.parallel import shard_batch as jax_shard_batch
from hvs_tpu.parallel import sharded_fraction as jax_sharded_fraction
from hvs_tpu.training import losses as jlosses
from hvs_tpu.training import schedule as jschedule
from hvs_tpu.training.optimizer import make_optimizer
from hvs_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from hvs_tpu.training.trainer import global_norm as jax_global_norm
from hvs_tpu_torch.convert import flatten, load_flax_params, to_flax_layout
from hvs_tpu_torch.models import HybridVisionSystem
from hvs_tpu_torch.models.layers import Dropout
from hvs_tpu_torch.parallel import (Mesh, PartitionSpec, gather_parameters, held_fraction,
                                    make_mesh, param_sharding, shard_parameters,
                                    sharded_fraction)
from hvs_tpu_torch.parallel.tensor import block
from hvs_tpu_torch.train import TINY
from hvs_tpu_torch.training.optimizer import ManifoldAwareOptimizer
from hvs_tpu_torch.training.trainer import (ManifoldConstrainedTrainer, TrainerConfig,
                                            batch_to, train_step)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES, IMAGE, LR = 8, 64, 1e-3
# One process against a model group: the row-parallel products sum their
# blocks' fp32 partials in another order. At the init scale H_post is near 1
# and the sum x @ H_res + y @ H_post is near uniform across channels, so LN2
# amplifies that reordering: one mHC layer's output and input gradient lie
# 2e-6 and 3e-6 of their largest entry from one process's (1e-6 and 3e-7
# away from the init scale), and over the tiny model's 11 layers the gradient
# norm moved 6.6e-6 relative and single gradient entries up to 1e-6 of it.
# The limits are ten times those; the data-parallel tests hold 1e-5 and 1e-6.
TP_RTOL, TP_ATOL = 1e-4, 1e-5
# Adam's first update is about lr·sign(g): an entry whose gradient is
# rounding noise (|g| under 1e-6 of the global norm) can move by up to 2·lr
# either way; every other entry is held to TP_RTOL.
NOISE_GRAD = 1e-6
# tests/test_torch_train.py's end-to-end tolerance against JAX.
RTOL, ATOL = 2e-3, 5e-3
# The sharded deterministic forward against one process: the multi-chip dry
# run's tolerance (__graft_entry__.py), and a class index may differ only
# where the top-2 class-score margin is within ATOL (a tie).
FWD_RTOL, FWD_ATOL = 2e-3, 5e-3
WORKER_TIMEOUT = 300  # seconds per process
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
METRICS = ("loss", "detection_loss", "box_loss", "obj_loss", "cls_loss", "num_positives",
           "grad_norm")


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _global_batch():
    """Four 64² images: two with four boxes each, two with one, each box in
    its own quadrant, so the halves of the batch hold 8 and 2 positives."""
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


def _config(**kw):
    return dict(num_classes=NUM_CLASSES, warmup_steps=0, total_steps=100,
                backbone_lr_factor=0.1, sk_iters=TINY["sk_iters"], max_boxes=4, **kw)


def _tiny_trainer(params, mesh=None, dropout=False, checkpoint_dir="checkpoints"):
    """The tiny model in fp32 with ``params`` (a flax tree), through the
    trainer (EMA on, so checkpoints carry it), state initialised."""
    model = HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32, monitor=True,
                               device="cpu", **TINY)
    load_flax_params(model, params)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
    trainer = ManifoldConstrainedTrainer(
        model, TrainerConfig(**_config(ema_decay=0.9, checkpoint_dir=checkpoint_dir)),
        device="cpu", mesh=mesh)
    trainer.init_state()
    return trainer


def _forward(model, images):
    """The deterministic forward's decoded detections."""
    model.eval()
    with torch.no_grad():
        d = model(torch.from_numpy(images))["detection"]
    return {k: d[k].numpy() for k in ("boxes", "class_scores", "class_indices", "scores")}


def _one_process_step(params, batch, dropout=False, steps=1):
    """The step(s) of one process on the whole batch: metrics per step, the
    last step's gradients, the parameters after (flax layout)."""
    t = _tiny_trainer(params, dropout=dropout)
    losses = []
    for _ in range(steps):
        m, g = train_step(t.model, t.tx, t.config, t.state,
                          batch_to(batch, torch.device("cpu")), mesh=t.mesh)
        losses.append(float(m["loss"]))
    return ({k: float(v) for k, v in m.items()}, {k: v.numpy() for k, v in g.items()},
            {k: to_flax_layout(k, v.detach().numpy()) for k, v in t.params().items()}, losses)


# ---------------------------------------------------------------------------
# Blocks, refusals and the entry point's device choice (one process)


def test_blocks_are_jax_named_sharding_shards():
    """A parameter's block on model index k is the shard JAX's
    ``NamedSharding`` places on model index k, for both split axes."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    jmesh = jax_make_mesh(n_data=2, n_model=4, devices=jax.devices()[:8])
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    for spec, dim in ((JP(None, "model"), 1), (JP("model", None), 0)):
        arr = jax.device_put(x, NamedSharding(jmesh, spec))
        devices = np.asarray(jmesh.devices)
        for shard in arr.addressable_shards:
            _, k = map(int, np.argwhere(devices == shard.device)[0])
            mesh = Mesh(data=2, model=4, model_rank=k)
            got = block(torch.from_numpy(x), mesh, dim).numpy()
            np.testing.assert_array_equal(got, np.asarray(shard.data))


def test_sharded_routes_are_refused_where_absent():
    """A mesh with a model axis needs a model group; a captured step
    refuses one; a rule may shard only a parameter whose module has a
    sharded route; no rule may shard an H_res_raw."""
    from hvs_tpu_torch.training.chunk import TrainChunk, ValChunk

    model = HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32, device="cpu",
                               **TINY)
    with pytest.raises(ValueError, match="no model group"):
        ManifoldConstrainedTrainer(model, TrainerConfig(num_classes=NUM_CLASSES), device="cpu",
                                   mesh=make_mesh(n_data=1, n_model=2, devices=range(2)))
    stub = type("Trainer", (), {"mesh": Mesh(data=1, model=2, model_group="group")})()
    with pytest.raises(NotImplementedError, match="6b"):
        TrainChunk(stub, None, 64, 2, 2)
    with pytest.raises(NotImplementedError, match="6b"):
        ValChunk(stub, None, 2, 64, 1)
    mesh = Mesh(data=1, model=2, model_group="group")
    params = dict(model.named_parameters())
    conv = next(n for n, p in params.items() if n.endswith("kernel") and p.dim() == 4)
    with pytest.raises(ValueError, match="whole tensors only"):
        shard_parameters(model, mesh, {conv: PartitionSpec("model", None, None, None)})
    h_res = next(n for n in params if n.endswith("H_res_raw"))
    with pytest.raises(ValueError, match="whole square H_res_raw"):
        ManifoldAwareOptimizer(params, 1e-3, sharded={h_res}, mesh=mesh)


def test_processes_sharing_a_card_name_it_and_gloo(monkeypatch):
    """Two processes on one card: each names card 0 and the gloo backend;
    without a named card, a process whose LOCAL_RANK has no card raises
    instead of sharing card 0. The card and the process group are stood in
    for."""
    import torch.distributed as dist

    from hvs_tpu_torch.parallel import initialize_distributed

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, init_method, world_size, rank:
                        calls.append(("init", backend, world_size, rank)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k, v in {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": "29512"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="share a card"):
        initialize_distributed(device="cuda")
    assert calls == []
    dev = initialize_distributed(device="cuda:0", backend="gloo")
    assert dev == torch.device("cuda", 0)
    assert calls == [("set_device", "cuda:0"), ("init", "gloo", 2, 1)]


# ---------------------------------------------------------------------------
# The sharded step over gloo processes


@pytest.fixture(scope="module")
def tp_reference():
    """The tiny JAX model's init, the global batch, and JAX's train step on
    it over a 2 x 2 mesh with the parameters placed by ``param_sharding``
    (the loss and gradients as ``make_train_step`` composes them, dropout
    off; the optax chain)."""
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
        return metrics, optax.apply_updates(params, updates)

    mesh = jax_make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    shardings = jax_param_sharding(mesh, params)
    assert jax_sharded_fraction(shardings, params)["sharded_params"] > 0
    sharded = jax.device_put(params, shardings)
    assert any(not s.is_fully_replicated for s in
               (leaf.sharding for leaf in jax.tree_util.tree_leaves(sharded)))
    metrics, new_params = jax.device_get(
        run(sharded, jax_shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})))
    return dict(params=params, batch=batch, metrics=metrics, new_params=flatten(new_params))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, mode, world, n_model):
    """``world`` gloo processes running this file's ``_worker``; each has its
    own time limit. Returns rank 0's results."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(rank),
                               str(world), str(n_model), str(port), str(tmp_path)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]
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


@pytest.fixture(scope="module")
def tp_runs(tp_reference, tmp_path_factory):
    """The 1 x 2 and 2 x 2 runs, then the 2 x 2 checkpoint restored into a
    2 x 1 data-parallel mesh; each run's rank-0 results and directory."""
    runs = {}
    for name, (n_data, n_model) in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"tp{name}")
        np.savez(tmp / "inputs.npz", **{f"param:{k}": v for k, v in
                                        flatten(tp_reference["params"]).items()},
                 **{f"batch:{k}": v for k, v in tp_reference["batch"].items()})
        runs[name] = (_run_workers(tmp, "tp", n_data * n_model, n_model), tmp)
    tmp = runs["2x2"][1]
    runs["dp"] = (_run_workers(tmp, "restore", 2, 1), tmp)
    return runs


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_equals_jax_sharded_step(tp_reference, tp_runs, mesh):
    """(a) The port's step over the mesh is JAX's step over its 2 x 2 mesh:
    the loss and its terms, the grad norm, and every gathered parameter
    after the update."""
    got, tmp = tp_runs[mesh]
    want = tp_reference
    assert got["mesh"] == {"data": MESHES[mesh][0], "model": MESHES[mesh][1]}
    for k in METRICS:
        _close(got["metrics"][k], float(want["metrics"][k]), RTOL, ATOL, msg=f"jax {k}")
    params = dict(np.load(tmp / "rank0_params.npz"))
    assert set(params) == set(want["new_params"])
    for name, value in want["new_params"].items():
        _close(params[name], value, RTOL, ATOL, msg=f"jax {name}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_step_equals_one_process(tp_reference, tp_runs, mesh):
    """(b) The same step in one process on the whole batch: the metrics, the
    gathered gradients and parameters to fp32 rounding; every process of
    the mesh ends with the same whole parameters; each holds only its blocks
    of the rule-matched ones."""
    got, tmp = tp_runs[mesh]
    m1, g1, p1, _ = _one_process_step(tp_reference["params"], tp_reference["batch"])
    for k in METRICS + ("lr", "manifold_ds", "ds_error_max"):
        _close(got["metrics"][k], m1[k], TP_RTOL, 0.0, msg=k)
    grads = dict(np.load(tmp / "rank0_grads.npz"))
    for name, value in g1.items():
        _close(grads[name], value, TP_RTOL, TP_ATOL * m1["grad_norm"], msg=f"grad {name}")
    params = dict(np.load(tmp / "rank0_params.npz"))
    for name, value in p1.items():
        signal = np.abs(to_flax_layout(name, g1[name])) > NOISE_GRAD * m1["grad_norm"]
        _close(params[name][signal], value[signal], TP_RTOL, TP_ATOL, msg=name)
        _close(params[name], value, 0.0, 2 * LR, msg=name)
    assert got["max_param_gap_between_ranks"] == 0.0
    assert got["sharded_params"] > 0
    assert got["held_blocks_only"]


def test_checkpoint_restores_bit_exact_into_dp_and_one_process(tp_reference, tp_runs, tmp_path):
    """(c) The 2 x 2 run's checkpoint (one-process layout) restores bit-exact
    into a 2 x 1 data-parallel mesh and into one process, each of which then
    takes a finite step."""
    _, tmp = tp_runs["2x2"]
    ckpt = torch.load(tmp / "tp.pt", map_location="cpu")
    saved = dict(np.load(tmp / "rank0_params.npz"))
    assert set(ckpt["params"]) == set(saved)
    for name, value in ckpt["params"].items():
        np.testing.assert_array_equal(to_flax_layout(name, value.numpy()), saved[name])
    dp = tp_runs["dp"][0]
    assert dp["mesh"] == {"data": 2, "model": 1}
    assert dp["bit_exact"] and dp["step"] == ckpt["step"] + 1 and np.isfinite(dp["loss"])

    one = _tiny_trainer(tp_reference["params"], checkpoint_dir=str(tmp_path))
    one.load_checkpoint(str(tmp / "tp"))
    assert _state_equals(one, ckpt)
    m = one.train_step(tp_reference["batch"])
    assert np.isfinite(float(m["loss"])) and one.state.step == ckpt["step"] + 1


def _state_equals(trainer, ckpt) -> bool:
    """Whether a trainer's whole state is bitwise a checkpoint's."""
    opt = trainer.tx.state_dict()
    pairs = [(trainer.params(), ckpt["params"]), (trainer.state.ema_params, ckpt["ema_params"])]
    pairs += [(opt[k], ckpt["opt_state"][k]) for k in ("mu", "nu", "trace")]
    return (all(set(a) == set(b) and all(torch.equal(a[n].detach(), b[n]) for n in a)
                for a, b in pairs)
            and int(opt["count"]) == int(ckpt["opt_state"]["count"])
            and trainer.state.step == ckpt["step"])


def test_sharded_deterministic_forward_equals_one_process(tp_reference, tp_runs):
    """(d) The 1 x 2 mesh's deterministic forward (before the step) against
    one process: boxes and class scores within the multi-chip dry run's
    tolerance, class indices equal wherever the top-2 margin is not a tie;
    both processes' outputs equal."""
    got, tmp = tp_runs["1x2"]
    mesh_out = dict(np.load(tmp / "rank0_forward.npz"))
    model = HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32, monitor=True,
                               device="cpu", **TINY)
    load_flax_params(model, tp_reference["params"])
    solo = _forward(model, tp_reference["batch"]["images"])
    for name in ("boxes", "class_scores"):
        _close(mesh_out[name], solo[name], FWD_RTOL, FWD_ATOL, msg=name)
    scores = np.sort(solo["scores"], axis=-1)
    tie = scores[..., -1] - scores[..., -2] <= FWD_ATOL
    flips = mesh_out["class_indices"] != solo["class_indices"]
    assert not (flips & ~tie).any()
    assert got["forward_equal_between_ranks"]


def test_dropout_masks_keep_model_ranks_replicated(tp_reference, tp_runs):
    """(e) With dropout on, two steps of the 1 x 2 mesh: the two processes'
    replicated parameters and a third train-mode forward's outputs are
    equal, and each step's loss is one process's with the same generator
    (each block takes its block of the whole-width mask)."""
    got, _ = tp_runs["1x2"]
    assert got["dropout"]["replicated_gap"] == 0.0
    assert got["dropout"]["output_gap"] == 0.0
    _, _, _, losses = _one_process_step(tp_reference["params"], tp_reference["batch"],
                                        dropout=True, steps=2)
    _close(got["dropout"]["losses"], losses, TP_RTOL, 0.0)


def test_held_shards_fraction_on_the_flagship(tp_runs):
    """(f) On the flagship (8 classes) each process of the 1 x 2 mesh holds
    blocks whose ``sharded_fraction`` is the rule table's, and the
    parameter bytes it holds are the replicated bytes plus the sharded bytes
    over 2."""
    got, _ = tp_runs["1x2"]
    model = HybridVisionSystem(num_classes=NUM_CLASSES, device="cpu")
    params = dict(model.named_parameters())
    want = sharded_fraction(param_sharding(Mesh(data=1, model=2), params), params)
    held = got["flagship"]
    for k in ("sharded_params", "total_params"):
        assert held[k] == want[k]
    assert abs(held["sharded_bytes_fraction"] - want["sharded_bytes_fraction"]) < 1e-12
    assert held["held_bytes"] == held["replicated_bytes"] + held["sharded_bytes"] // 2
    assert held["held_bytes"] == got["flagship_held_bytes_rank1"]


def test_collectives_and_their_gradients(tp_runs):
    """The column- and row-parallel products over the 1 x 2 mesh and their
    gradients with respect to the input, the blocks and the bias, against
    the whole products in one process: within 1e-6 of each one's largest
    entry (fp32 sums of a few terms in another order)."""
    got, _ = tp_runs["1x2"]
    for k, gap in got["collectives"].items():
        assert gap < 1e-6, (k, gap)


@pytest.mark.parametrize("procs", [2, 4])
def test_train_entry_point_with_n_model_2(procs, tmp_path):
    """``python -m hvs_tpu_torch.train --n-model 2`` under torchrun on the
    CPU: a 1 x 2 and a 2 x 2 gloo mesh train the tiny model and write a
    checkpoint in the one-process layout."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(procs),
           "--master_port", str(_free_port()), "-m", "hvs_tpu_torch.train", "--synthetic",
           "--tiny", "--device", "cpu", "--n-model", "2", "--steps", "2", "--epochs", "1",
           "--num-classes", str(NUM_CLASSES), "--checkpoint-dir", str(tmp_path / "ckpt"),
           "--log-dir", str(tmp_path / "logs")]
    out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True,
                         timeout=WORKER_TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    # The processes print one summary each, which may share a line.
    decoder, text = json.JSONDecoder(), out.stdout
    summaries = [decoder.raw_decode(text, i)[0] for i in range(len(text))
                 if text.startswith('{"device"', i)]
    assert len(summaries) == procs
    assert all(s["mesh"] == {"data": procs // 2, "model": 2} and s["steps"] == 2
               and np.isfinite(s["train_loss"]).all() for s in summaries)
    best = torch.load(tmp_path / "ckpt" / "best.pt", map_location="cpu")
    model = HybridVisionSystem(num_classes=NUM_CLASSES, device="cpu", **TINY)
    assert {k: tuple(v.shape) for k, v in best["params"].items()} == \
        {k: tuple(v.shape) for k, v in model.named_parameters()}


# ---------------------------------------------------------------------------
# The worker processes (run as ``python tests/test_torch_tensor_parallel.py
# MODE RANK WORLD N_MODEL PORT DIR``)


def _max_gap(t: torch.Tensor) -> float:
    """The largest difference of ``t`` from the first process's."""
    import torch.distributed as dist

    first = t.clone()
    dist.broadcast(first, src=0)
    gap = (t - first).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def _collective_gaps(mesh) -> dict:
    """The sharded products and their gradients against the whole ones."""
    from hvs_tpu_torch.parallel.tensor import column_parallel, gather, row_parallel, split

    r = np.random.default_rng(3)
    x0 = torch.from_numpy(r.standard_normal((3, 8)).astype(np.float32))
    w0 = torch.from_numpy(r.standard_normal((8, 6)).astype(np.float32))
    b0 = torch.from_numpy(r.standard_normal(6).astype(np.float32))
    v0 = torch.from_numpy(r.standard_normal((6, 4)).astype(np.float32))
    probe = torch.from_numpy(r.standard_normal((3, 4)).astype(np.float32))

    def whole():
        x, w, b, v = (t.clone().requires_grad_() for t in (x0, w0, b0, v0))
        out = ((x @ w + b) @ v * probe).sum()
        return [out.detach()] + list(torch.autograd.grad(out, (x, w, b, v)))

    def sharded():
        x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
        w = block(w0, mesh, 1).clone().requires_grad_()
        v = block(v0, mesh, 0).clone().requires_grad_()
        y = gather(column_parallel(x, w, b, mesh), mesh)
        out = (row_parallel(split(y, mesh), v, mesh) * probe).sum()
        gx, gw, gb, gv = torch.autograd.grad(out, (x, w, b, v))
        return [out.detach(), gx, gather(gw, mesh, 1), gb, gather(gv, mesh, 0)]

    names = ("value", "grad_x", "grad_w", "grad_b", "grad_v")
    return {n: float((a - b).abs().max() / a.abs().max())
            for n, a, b in zip(names, whole(), sharded())}


def _worker(mode, rank, world, n_model, port, tmp):
    import pathlib

    import torch.distributed as dist

    from hvs_tpu_torch.config.training import DistributedConfig
    from hvs_tpu_torch.convert import nest
    from hvs_tpu_torch.parallel import gather_tensors, setup

    tmp = pathlib.Path(tmp)
    mesh, device = setup("cpu", DistributedConfig(enabled=True,
                                                  coordinator_address=f"127.0.0.1:{port}",
                                                  num_processes=world, process_id=rank),
                         n_model=n_model)
    assert device == torch.device("cpu") and dist.get_backend() == "gloo"
    assert (mesh.rank, mesh.model_rank) == divmod(rank, n_model)
    assert mesh.process_index == rank and mesh.sharded == (n_model > 1)
    assert mesh.distributed == (world // n_model > 1)
    data = np.load(tmp / "inputs.npz")
    params = nest({k[len("param:"):]: data[k] for k in data.files if k.startswith("param:")})
    batch = {k[len("batch:"):]: data[k] for k in data.files if k.startswith("batch:")}
    out = {"mesh": mesh.shape}
    if mode == "tp":
        if mesh.shape == {"data": 1, "model": 2}:
            out["collectives"] = _collective_gaps(mesh)
            flagship = HybridVisionSystem(num_classes=NUM_CLASSES, device="cpu")
            shard_parameters(flagship, mesh)
            out["flagship"] = held_fraction(flagship, mesh)
            sizes = [None] * world
            dist.all_gather_object(sizes, out["flagship"]["held_bytes"])
            out["flagship_held_bytes_rank1"] = sizes[1]
            del flagship
        trainer = _tiny_trainer(params, mesh=mesh, checkpoint_dir=str(tmp))
        whole = dict(HybridVisionSystem(num_classes=NUM_CLASSES, dtype=torch.float32,
                                        device="cpu", **TINY).named_parameters())
        out["sharded_params"] = len(trainer.sharded)
        out["held_blocks_only"] = all(
            p.shape[d] * n_model == whole[n].shape[d] if n in trainer.sharded
            else p.shape == whole[n].shape for n, p in trainer.params().items()
            for d in [trainer.sharded.get(n, 0)])
        if mesh.shape == {"data": 1, "model": 2}:
            fwd = _forward(trainer.model, batch["images"])
            out["forward_equal_between_ranks"] = all(
                _max_gap(torch.from_numpy(v).double()) == 0.0 for v in fwd.values())
            if rank == 0:
                np.savez(tmp / "rank0_forward.npz", **fwd)
        metrics, grads = train_step(trainer.model, trainer.tx, trainer.config, trainer.state,
                                    batch_to(_share(batch, mesh), device), mesh=mesh)
        grads = gather_tensors(grads, trainer.sharded, mesh)
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        whole_params = gather_parameters(trainer.model)
        out["max_param_gap_between_ranks"] = _max_gap(
            torch.cat([p.reshape(-1) for p in whole_params.values()]))
        trainer.save_checkpoint("tp")
        if mesh.shape == {"data": 1, "model": 2}:
            out["dropout"] = _dropout_run(params, mesh, batch)
        if rank == 0:
            np.savez(tmp / "rank0_grads.npz", **{k: v.numpy() for k, v in grads.items()})
            np.savez(tmp / "rank0_params.npz",
                     **{k: to_flax_layout(k, v.numpy()) for k, v in whole_params.items()})
    else:  # restore the 2 x 2 checkpoint into this 2 x 1 data-parallel mesh
        trainer = _tiny_trainer(params, mesh=mesh, checkpoint_dir=str(tmp / "dp"))
        trainer.load_checkpoint(str(tmp / "tp"))
        out["bit_exact"] = _state_equals(trainer, torch.load(tmp / "tp.pt", map_location="cpu"))
        metrics = trainer.train_step(batch)
        out["loss"], out["step"] = float(metrics["loss"]), trainer.state.step
    if rank == 0:
        with open(tmp / "rank0.json", "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _share(batch, mesh):
    from hvs_tpu_torch.parallel import shard_batch

    return shard_batch(mesh, batch, "cpu") if mesh.distributed else batch


def _dropout_run(params, mesh, batch) -> dict:
    """Two steps with dropout on, then a train-mode forward: the gaps
    between the processes and each step's loss."""
    trainer = _tiny_trainer(params, mesh=mesh, dropout=True)
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(2)]
    replicated = torch.cat([p.detach().reshape(-1) for n, p in trainer.params().items()
                            if n not in trainer.sharded])
    trainer.model.train()
    with torch.no_grad():
        raw = trainer.model(torch.from_numpy(batch["images"]))["detection"]["raw"]
    return {"losses": losses, "replicated_gap": _max_gap(replicated),
            "output_gap": max(_max_gap(t.float()) for t in raw.values())}


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
            int(sys.argv[5]), sys.argv[6])
