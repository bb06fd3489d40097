"""The fused mHC block of the port (hvs_tpu_torch.ops.mhc_block) and its layer.

The serve block's plain version is held against the JAX Pallas kernel
``mhc_block_pallas_packed`` and the unfolded block's against
``mhc_block_pallas``; both run in interpret mode on the CPU as the JAX
package's own tests run them. The layer is held against the JAX layer: the
serve branch against its XLA path, the training branch against its
non-precomputed path. The CUDA kernels run only on a card; their tests are
in test_torch_gpu.py.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvs_tpu.models import ManifoldHyperConnection as JaxMHC
from hvs_tpu.models import compute_constraints as jax_constraints
from hvs_tpu.ops.pallas import mhc_block_pallas, mhc_block_pallas_packed
from hvs_tpu.ops.sinkhorn import sinkhorn_log as jax_sinkhorn
from hvs_tpu_torch.models.constraints import compute_constraints, param_tree
from hvs_tpu_torch.models.layers import ManifoldHyperConnection
from hvs_tpu_torch.ops import mhc_block as mhc_mod

torch.set_num_threads(1)

# Same criteria as tests/test_pallas.py: the two sides round at the same
# points but sum in different orders, and LN2 can amplify a flipped rounding.
MIN_CORR, MAX_MEAN_ABS = 0.999, 0.05


def _block_inputs(n, d, seed):
    """Seeded fp32 inputs. W1/W2 are lecun-scaled and H_post is scaled by
    1/sqrt(d), so the pre-LN2 row is not a near-constant that LN2 cancels into
    rounding noise; H_res is near-identity, as in tests/test_pallas.py."""
    r = np.random.default_rng(seed)
    f = np.float32
    x = r.standard_normal((n, d)).astype(f)
    w1 = (r.standard_normal((d, d)) / math.sqrt(d)).astype(f)
    w2 = (r.standard_normal((d, d)) / math.sqrt(d)).astype(f)
    h_post = (2.0 / (1.0 + np.exp(-0.1 * r.standard_normal((d, d)))) / math.sqrt(d)).astype(f)
    h_res = np.array(jax_sinkhorn(jnp.asarray(6.0 * np.eye(d) + r.standard_normal((d, d)),
                                              jnp.float32), 20))
    b1, b2 = (0.01 * r.standard_normal(d)).astype(f), (0.01 * r.standard_normal(d)).astype(f)
    ln = [(1 + 0.1 * r.standard_normal(d)).astype(f), (0.1 * r.standard_normal(d)).astype(f),
          (1 + 0.1 * r.standard_normal(d)).astype(f), (0.1 * r.standard_normal(d)).astype(f)]
    return x, [w1, b1, w2, b2, h_post, h_res] + ln


@pytest.mark.parametrize("d,n", [(32, 1234), (64, 1234), (128, 300), (256, 300)])
def test_plain_version_matches_jax_pallas_kernel(d, n):
    x, args = _block_inputs(n, d, seed=d)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(mhc_block_pallas_packed(xj, *[jnp.asarray(a) for a in args]), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = mhc_mod.mhc_block_plain(xt, *[torch.from_numpy(a) for a in args])
    assert got.dtype == torch.bfloat16 and got.shape == (n, d)
    a, b = got.float().numpy().ravel(), want.ravel()
    assert np.corrcoef(a, b)[0, 1] > MIN_CORR
    assert np.mean(np.abs(a - b)) < MAX_MEAN_ABS


def test_wrapper_takes_plain_version_for_cpu_tensors():
    x, args = _block_inputs(200, 64, seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    targs = [torch.from_numpy(a) for a in args]
    before = mhc_mod.launches
    out = mhc_mod.mhc_block(xt, *targs)
    assert mhc_mod.launches == before  # nothing launched for a CPU tensor
    torch.testing.assert_close(out, mhc_mod.mhc_block_plain(xt, *targs), rtol=0, atol=0)


def _jax_layer(d, expansion, ratio, x_shape, seed, conditioned=False):
    layer = JaxMHC(dim=d, expansion_rate=expansion, mlp_ratio=ratio, sk_iters=10,
                   dropout_rate=0.0, precomputed_constraints=True, dtype=jnp.float32)
    x = jnp.zeros(x_shape, jnp.float32)
    params = jax.device_get(layer.init(jax.random.PRNGKey(seed), x)["params"])
    r = np.random.default_rng(seed)
    # Move every parameter off its init value so biases and norms are exercised.
    params = {k: (v + 0.1 * r.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()}
    if conditioned:
        params["H_res_raw"] = (6.0 * np.eye(d) + r.standard_normal((d, d))).astype(np.float32)
    return layer, params


@pytest.mark.parametrize("d,expansion,ratio,x_shape", [
    (64, 1, 1, (2, 5, 7, 64)),   # a backbone/FPN/head site (fused in bf16)
    (32, 1, 2, (3, 9, 32)),      # a ViT mhc_ffn site
    (16, 2, 2, (4, 16)),         # expanded hidden width
])
def test_mhc_layer_fp32_matches_jax_xla_path(d, expansion, ratio, x_shape):
    layer, params = _jax_layer(d, expansion, ratio, x_shape, seed=d)
    x = np.random.default_rng(1).standard_normal(x_shape).astype(np.float32)
    variables = {"params": params,
                 "constraints": jax_constraints({"l": params}, 10)["l"]}
    want = np.asarray(layer.apply(variables, jnp.asarray(x)))

    port = ManifoldHyperConnection(d, expansion, ratio, dtype=torch.float32,
                                   precomputed_constraints=True)
    with torch.no_grad():
        for k, v in params.items():
            getattr(port, k).copy_(torch.from_numpy(v))
    port.set_constraints(compute_constraints({"l": param_tree(port)}, 10)["l"])
    assert not port.fused  # fp32 runs the layer's own chain
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mhc_layer_bf16_fused_site_matches_jax():
    """A bf16 site with expansion 1 and mlp_ratio 1 takes the fused block
    (its plain version here) and agrees with the JAX layer in bf16."""
    d, shape = 64, (2, 6, 5, 64)
    layer, params = _jax_layer(d, 1, 1, shape, seed=5, conditioned=True)
    layer = layer.clone(dtype=jnp.bfloat16)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    variables = {"params": params, "constraints": jax_constraints({"l": params}, 10)["l"]}
    with jax.default_matmul_precision("bfloat16"):
        want = np.asarray(layer.apply(variables, jnp.asarray(x)), np.float32)

    port = ManifoldHyperConnection(d, 1, 1, dtype=torch.bfloat16, precomputed_constraints=True)
    with torch.no_grad():
        for k, v in params.items():
            getattr(port, k).copy_(torch.from_numpy(v))
    port.set_constraints(compute_constraints({"l": param_tree(port)}, 10)["l"])
    assert port.fused
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == shape
    a, b = got.float().numpy().ravel(), want.ravel()
    assert np.corrcoef(a, b)[0, 1] > MIN_CORR
    assert np.mean(np.abs(a - b)) < MAX_MEAN_ABS


def test_layer_without_constraints_raises():
    port = ManifoldHyperConnection(32, 1, 1, dtype=torch.float32, precomputed_constraints=True)
    with pytest.raises(RuntimeError, match="constraints"):
        port(torch.zeros(2, 32))


@pytest.mark.parametrize("d,expansion,ratio,dtype,fused", [
    (32, 1, 1, torch.bfloat16, True),
    (512, 1, 1, torch.bfloat16, True),
    (256, 1, 2, torch.bfloat16, False),   # mhc_ffn / mhc_features
    (48, 1, 1, torch.bfloat16, False),    # no kernel width
    (64, 1, 1, torch.float32, False),
])
def test_fused_sites(d, expansion, ratio, dtype, fused):
    assert ManifoldHyperConnection(d, expansion, ratio, dtype=dtype).fused == fused


def _h_pre(d, seed):
    """H_pre as the training forward makes it: sigmoid of logits at the init scale."""
    r = np.random.default_rng(seed)
    return (1.0 / (1.0 + np.exp(-0.1 * r.standard_normal((d, d))))).astype(np.float32)


@pytest.mark.parametrize("d,n", [(128, 300), (256, 300)])
def test_unfolded_plain_version_matches_jax_pallas_kernel(d, n):
    x, args = _block_inputs(n, d, seed=d + 1)
    h_pre = _h_pre(d, d)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(mhc_block_pallas(xj, jnp.asarray(h_pre), *[jnp.asarray(a) for a in args]),
                      np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = mhc_mod.mhc_block_unfolded_plain(xt, torch.from_numpy(h_pre),
                                           *[torch.from_numpy(a) for a in args])
    assert got.dtype == torch.bfloat16 and got.shape == (n, d)
    a, b = got.float().numpy().ravel(), want.ravel()
    assert np.corrcoef(a, b)[0, 1] > MIN_CORR
    assert np.mean(np.abs(a - b)) < MAX_MEAN_ABS


def test_unfolded_wrapper_takes_plain_version_for_cpu_tensors():
    x, args = _block_inputs(100, 32, seed=4)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    targs = [torch.from_numpy(_h_pre(32, 4))] + [torch.from_numpy(a) for a in args]
    before = mhc_mod.launches_unfolded
    out = mhc_mod.mhc_block_unfolded(xt, *targs)
    assert mhc_mod.launches_unfolded == before
    torch.testing.assert_close(out, mhc_mod.mhc_block_unfolded_plain(xt, *targs), rtol=0, atol=0)


def _training_layer_pair(d, shape, seed, dtype):
    """The JAX layer with per-forward constraints and the port's training
    branch with the same weights, conditioned: H_res near identity as above,
    H_pre = sigmoid(6·I - 3 + noise) and H_post = 2·sigmoid(6·I - 6 + noise)
    near identity too. At the init scale H_pre is ~0.5 and H_post ~1
    everywhere, so LN1(x) @ H_pre and y @ H_post are near-constant rows whose
    bf16 rounding (JAX rounds inside GELU, PyTorch does not) the LayerNorms
    would amplify over the signal."""
    layer, params = _jax_layer(d, 1, 1, shape, seed=seed, conditioned=True)
    r = np.random.default_rng(seed + 1)
    eye = np.eye(d)
    params["H_pre_raw"] = (6.0 * eye - 3.0 + 0.5 * r.standard_normal((d, d))).astype(np.float32)
    params["H_post_raw"] = (6.0 * eye - 6.0 + 0.5 * r.standard_normal((d, d))).astype(np.float32)
    layer = layer.clone(precomputed_constraints=False, dtype=dtype, monitor=True)
    port = ManifoldHyperConnection(d, 1, 1, dtype=torch.bfloat16 if dtype == jnp.bfloat16
                                   else torch.float32, sk_iters=10, monitor=True,
                                   dropout_rate=0.0)
    with torch.no_grad():
        for k, v in params.items():
            getattr(port, k).copy_(torch.from_numpy(v))
    return layer, params, port


@pytest.mark.parametrize("d,shape", [(32, (2, 7, 5, 32)), (64, (2, 6, 5, 64))])
def test_training_layer_eval_forward_takes_unfolded_block_and_matches_jax(d, shape):
    """A deterministic forward of the training model in bf16: the port runs
    the unfolded block (its plain version here), JAX its XLA chain."""
    layer, params, port = _training_layer_pair(d, shape, seed=d + 2, dtype=jnp.bfloat16)
    x = np.random.default_rng(d).standard_normal(shape).astype(np.float32)
    with jax.default_matmul_precision("bfloat16"):
        want, coll = layer.apply({"params": params}, jnp.asarray(x), mutable=["stability"])
    want = np.asarray(want, np.float32)
    assert port.fused and not port.precomputed_constraints
    port.eval()
    calls = []
    orig = mhc_mod.mhc_block_unfolded_plain
    mhc_mod.mhc_block_unfolded_plain = lambda *a: calls.append(1) or orig(*a)
    try:
        with torch.no_grad():
            got = port(torch.from_numpy(x))
    finally:
        mhc_mod.mhc_block_unfolded_plain = orig
    assert calls == [1]
    assert got.dtype == torch.bfloat16 and got.shape == shape
    a, b = got.float().numpy().ravel(), want.ravel()
    assert np.corrcoef(a, b)[0, 1] > MIN_CORR
    assert np.mean(np.abs(a - b)) < MAX_MEAN_ABS
    want_m = coll["stability"]["metrics"]
    for k in ("ds_error", "row_sum_error", "col_sum_error"):
        np.testing.assert_allclose(float(port.metrics[k]), float(want_m[k]), rtol=0, atol=1e-6)


def test_training_layer_train_forward_matches_jax_fp32():
    """The training branch in train mode (dropout 0) with its gradient, fp32."""
    d, shape = 32, (2, 6, 32)
    layer, params, port = _training_layer_pair(d, shape, seed=11, dtype=jnp.float32)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    w = np.random.default_rng(4).standard_normal(shape).astype(np.float32)

    def loss(p):
        out, coll = layer.apply({"params": p}, jnp.asarray(x), mutable=["stability"])
        return jnp.sum(out * w), (out, coll["stability"]["metrics"])

    (_, (want, want_m)), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port.train()
    got = port(torch.from_numpy(x))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for k, v in want_m.items():
        np.testing.assert_allclose(float(port.metrics[k]), float(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k, g in jax.device_get(want_g).items():
        gt = getattr(port, k).grad.numpy()
        np.testing.assert_allclose(gt, g, rtol=0, atol=1e-4 * max(np.abs(g).max(), 1e-3),
                                   err_msg=k)


# The kernels' launch (ops/mhc_block.py::launch_plan). The kernel itself runs
# only on a card (test_torch_gpu.py); it runs one block per row tile, block b
# on rows [b * tile, (b + 1) * tile) below N.
_SPREAD = (1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 400, 1234, 1352, 5408, 6400, 8447,
           8448, 8449, 16896, 16897, 25600, 86528, 102400, 409600)
_SOURCE = Path(__file__).resolve().parents[1] / "hvs_tpu_torch" / "csrc" / "mhc_block.cu"


@pytest.mark.parametrize("d", mhc_mod.SUPPORTED_WIDTHS)
def test_row_tile_matches_the_kernel_source(d):
    """The wrapper's tile and threads per width are the ones Config<d> in the
    CUDA source sets (the source dispatches on d alone)."""
    m = re.search(r"struct Config<%d> \{(?:\s*//[^\n]*)*\s*"
                  r"static constexpr int BM = (\d+), kThreads = (\d+),"
                  % d, _SOURCE.read_text())
    assert m, f"no Config<{d}> in {_SOURCE.name}"
    assert (mhc_mod.ROW_TILE[d], mhc_mod.THREADS) == (int(m[1]), int(m[2]))
    assert mhc_mod.ROW_TILE[d] % 16 == 0


@pytest.mark.parametrize("d", mhc_mod.SUPPORTED_WIDTHS)
def test_shared_memory_matches_the_kernel_source_and_fits(d):
    """The wrapper's ring per width is Config<d>'s; the block's shared memory
    (the fp32 residual sum included) stays within one block's 227 KB and
    lets kMinBlocks blocks share an SM (228 KB, 1 KB reserved per block)."""
    m = re.search(r"struct Config<%d> \{(?:\s*//[^\n]*)*\s*static constexpr int BM = \d+, "
                  r"kThreads = \d+, kMinBlocks = (\d+), WARPS_M = \d+, KC = (\d+),\s*"
                  r"kStages = (\d+);" % d, _SOURCE.read_text())
    assert m, f"no Config<{d}> in {_SOURCE.name}"
    min_blocks, kc, stages = int(m[1]), int(m[2]), int(m[3])
    assert mhc_mod.RING[d] == (kc, stages)
    smem = mhc_mod.launch_plan(1, d)["smem"]
    assert smem == mhc_mod.smem_bytes(d) <= 232448
    assert min_blocks * (smem + 1024) <= 228 * 1024
    assert mhc_mod.ROW_TILE[d] * (d + 8) * 4 <= smem  # the fp32 sum fits


@pytest.mark.parametrize("d", mhc_mod.SUPPORTED_WIDTHS)
def test_launch_plan_covers_every_row_exactly_once(d):
    for n in _SPREAD:
        plan = mhc_mod.launch_plan(n, d)
        assert plan["bm"] == mhc_mod.ROW_TILE[d] and plan["threads"] == mhc_mod.THREADS
        seen = np.zeros(n, np.int64)
        for block in range(plan["grid"]):
            rows = seen[block * plan["bm"]:min(n, (block + 1) * plan["bm"])]
            assert rows.size > 0, (n, plan)  # no block without rows
            rows += 1
        assert (seen == 1).all(), (n, plan)


def test_launch_plan_at_the_flagship_sites():
    """Grids of the 640² batch-16 serve forward's widest sites and of its
    d = 512 fusion, whose 200 blocks of 32 rows fill the card's 132 SMs."""
    assert [mhc_mod.launch_plan(n, d)["grid"] for n, d in (
        (409600, 32), (102400, 64), (25600, 128), (102400, 256), (6400, 256), (6400, 512),
        (400, 512))] == [3200, 800, 400, 1600, 100, 200, 13]
