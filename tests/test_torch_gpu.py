"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import math

import numpy as np
import pytest
import torch

from hvs_tpu_torch.ops import mhc_block as mhc_mod
from hvs_tpu_torch.ops import sinkhorn as sink_mod
from hvs_tpu_torch.ops.sinkhorn import sinkhorn_log

# The kernel and its plain version round at the same points (the GELU with
# the exact tanh on both sides) but sum in different orders (LN2 can amplify
# a flipped rounding). The limits sit between what sound builds read and
# what a build without the GELU reads (chip_smoke.py's KERNEL_MIN_CORR).
MIN_CORR, MAX_MEAN_ABS = 0.9999, 5e-3
# chip_smoke.py's GELU_FP64_MARGIN: on inputs ill-conditioned in their GELUs
# the kernel's corr to the fp64 chain may fall short of the plain version's
# by at most this much.
GELU_FP64_MARGIN = 1e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _cuda_inputs(n, d, seed):
    r = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dtype)

    bf = torch.bfloat16
    x = t(r.standard_normal((n, d)), bf)
    mats = [t(r.standard_normal((d, d)) / math.sqrt(d), bf) for _ in range(2)]
    h_post = t(2.0 / (1.0 + np.exp(-0.1 * r.standard_normal((d, d)))) / math.sqrt(d), bf)
    h_res = sinkhorn_log(t(6.0 * np.eye(d) + r.standard_normal((d, d))), 20).to(bf)
    vecs = [t(0.01 * r.standard_normal(d)) for _ in range(2)]
    ln = [t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d)),
          t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d))]
    return x, [mats[0], vecs[0], mats[1], vecs[1], h_post, h_res.contiguous()] + ln


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("n", [1, 1234])
def test_mhc_block_kernel_matches_plain_version(d, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, args = _cuda_inputs(n, d, seed=d + n)
    before = mhc_mod.launches
    out = mhc_mod.mhc_block(x, *args)
    torch.cuda.synchronize()
    assert mhc_mod.launches == before + 1
    assert out.shape == (n, d) and out.dtype == torch.bfloat16
    a = out.float().cpu().numpy().ravel()
    b = mhc_mod.mhc_block_plain(x, *args).float().cpu().numpy().ravel()
    assert np.isfinite(a).all()
    if n > 1:
        assert np.corrcoef(a, b)[0, 1] > MIN_CORR
    assert np.mean(np.abs(a - b)) < MAX_MEAN_ABS


def _ill_conditioned_inputs(n, d, seed):
    """The residual sum ill-conditioned, as chip_smoke.py's ILL_ROWS rows:
    x = 3 ± 0.3, a near-uniform H_res and a small H_post."""
    r = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dtype)

    bf = torch.bfloat16
    x = t(3.0 + 0.3 * r.standard_normal((n, d)), bf)
    mats = [t(r.standard_normal((d, d)) / math.sqrt(d), bf) for _ in range(2)]
    h_post = t(0.05 * r.standard_normal((d, d)) / math.sqrt(d), bf)
    h_res = sinkhorn_log(t(0.1 * r.standard_normal((d, d))), 20).to(bf)
    vecs = [t(0.01 * r.standard_normal(d)) for _ in range(2)]
    ln = [t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d)),
          t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d))]
    return x, [mats[0], vecs[0], mats[1], vecs[1], h_post, h_res.contiguous()] + ln


@pytest.mark.gpu
@pytest.mark.parametrize("unfolded", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128, 256, 512])
def test_mhc_block_kernels_sum_the_residual_in_fp32(d, unfolded):
    """Kernels A and C against their plain versions where the residual sum
    is ill-conditioned: the sum and LN2 in fp32 on both sides (a kernel that
    rounds the sum reads corr ~0.97 here)."""
    _need_card()
    x, args = _ill_conditioned_inputs(4096, d, seed=d)
    if unfolded:
        args = [torch.sigmoid(torch.eye(d, device="cuda") * 6.0 - 3.0).to(torch.bfloat16)] + args
        out = mhc_mod.mhc_block_unfolded(x, *args)
        ref = mhc_mod.mhc_block_unfolded_plain(x, *args)
    else:
        out, ref = mhc_mod.mhc_block(x, *args), mhc_mod.mhc_block_plain(x, *args)
    torch.cuda.synchronize()
    a = out.float().cpu().numpy().ravel()
    b = ref.float().cpu().numpy().ravel()
    assert np.isfinite(a).all()
    assert np.corrcoef(a, b)[0, 1] > MIN_CORR
    assert np.mean(np.abs(a - b)) < MAX_MEAN_ABS


def _chain64(x, w1, b1, w2, b2, h_post, h_res, ln1s, ln1b, ln2s, ln2b, h_pre=None):
    """The mHC block in fp64, rounding nowhere."""
    import torch.nn.functional as F

    def ln(v, scale, bias):
        mu = v.mean(-1, keepdim=True)
        var = (v - mu).square().mean(-1, keepdim=True)
        return (v - mu) / torch.sqrt(var + 1e-6) * scale.double() + bias.double()

    x = x.double()
    y = ln(x, ln1s, ln1b)
    if h_pre is not None:
        y = y @ h_pre.double()
    y = F.gelu(y @ w1.double() + b1.double(), approximate="tanh")
    y = F.gelu(y @ w2.double() + b2.double(), approximate="tanh")
    return ln(x @ h_res.double() + y @ h_post.double(), ln2s, ln2b)


@pytest.mark.gpu
@pytest.mark.parametrize("unfolded", [False, True])
def test_mhc_block_kernels_on_gelu_conditioned_inputs(unfolded):
    """chip_smoke.py's kernel_gelu_conditioned inputs at d = 256: H_post
    near 1 (2·sigmoid(0.01·noise)), so LN2 amplifies each GELU's last bit.
    The kernels (exact tanh) lie no farther from the fp64 chain than their
    plain versions, and far closer to them than the hardware tanh left them
    (corr 0.95 there; 0.996-0.997 with the exact tanh, the fp32 summation
    order's flips: under 0.9999, so the row gates on fp64)."""
    _need_card()
    d = 256
    x, args = _ill_conditioned_inputs(4096, d, seed=d)
    r = np.random.default_rng(d + 7)
    args[4] = torch.from_numpy((2.0 / (1.0 + np.exp(-0.01 * r.standard_normal((d, d)))))
                               .astype(np.float32)).to("cuda", torch.bfloat16)
    h_pre = None
    if unfolded:
        h_pre = torch.sigmoid(torch.eye(d, device="cuda") * 6.0 - 3.0).to(torch.bfloat16)
        out = mhc_mod.mhc_block_unfolded(x, h_pre, *args)
        ref = mhc_mod.mhc_block_unfolded_plain(x, h_pre, *args)
    else:
        out, ref = mhc_mod.mhc_block(x, *args), mhc_mod.mhc_block_plain(x, *args)
    exact = _chain64(x, *args, h_pre=h_pre).cpu().numpy().ravel()
    a = out.float().cpu().numpy().ravel()
    b = ref.float().cpu().numpy().ravel()
    assert np.isfinite(a).all()
    assert np.corrcoef(a, exact)[0, 1] >= np.corrcoef(b, exact)[0, 1] - GELU_FP64_MARGIN
    assert np.corrcoef(a, b)[0, 1] > 0.99


@pytest.mark.gpu
def test_manifold_attention_encoder_serves_with_kernels_a_and_b():
    """A manifold-attention encoder's serve forward on the card: B once per
    mHC layer at load (4 per block in the attention, the FFN, the fusion:
    11 at depth 2), A once per forward at mhc_fuse (d = 512), finite."""
    _need_card()
    from hvs_tpu_torch.models import (HybridVisionEncoder, compute_constraints,
                                      load_constraints, param_tree)
    from hvs_tpu_torch.models.layers import init_weights

    enc = HybridVisionEncoder(512, 64, 2, 4, use_manifold_attention=True, dropout_rate=0.0,
                              precomputed_constraints=True)
    init_weights(enc, 0)
    enc = enc.cuda().eval()
    before = sink_mod.launches_forward
    assert load_constraints(enc, compute_constraints(param_tree(enc))) == 11
    assert sink_mod.launches_forward == before + 11
    feat = torch.randn(2, 5, 5, 512, device="cuda", dtype=torch.bfloat16)
    before = mhc_mod.launches
    with torch.inference_mode():
        out = enc(feat)
    torch.cuda.synchronize()
    assert mhc_mod.launches == before + 1
    assert out.shape == feat.shape and bool(torch.isfinite(out.float()).all())


@pytest.mark.gpu
def test_mhc_block_wrapper_raises_instead_of_falling_back():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, args = _cuda_inputs(64, 128, seed=0)
    with pytest.raises(TypeError):
        mhc_mod.mhc_block(x.float(), *args)  # the kernel takes bf16 only
    with pytest.raises(ValueError):
        mhc_mod.mhc_block(x[:, :96].contiguous(), *args)  # no kernel width
    with pytest.raises(ValueError):
        mhc_mod.mhc_block(x.t().contiguous().t(), *args)  # not contiguous
    bad = list(args)
    bad[0] = bad[0].float()
    with pytest.raises(ValueError):
        mhc_mod.mhc_block(x, *bad)


def _unfolded_args(args, d, seed):
    """The serve block's operands with an H_pre (sigmoid of small logits, as
    at init) in front: the unfolded block's (h_pre, w1, b1, w2, ...)."""
    r = np.random.default_rng(seed)
    h_pre = torch.sigmoid(torch.from_numpy(0.1 * r.standard_normal((d, d)).astype(np.float32)))
    return [h_pre.to("cuda", torch.bfloat16)] + list(args)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 128, 256, 512])
@pytest.mark.parametrize("n", [1, 1234])
def test_mhc_block_unfolded_kernel_matches_plain_version(d, n):
    _need_card()
    x, args = _cuda_inputs(n, d, seed=d + n + 1)
    args = _unfolded_args(args, d, seed=d)
    before = mhc_mod.launches_unfolded
    out = mhc_mod.mhc_block_unfolded(x, *args)
    torch.cuda.synchronize()
    assert mhc_mod.launches_unfolded == before + 1
    assert out.shape == (n, d) and out.dtype == torch.bfloat16
    a = out.float().cpu().numpy().ravel()
    b = mhc_mod.mhc_block_unfolded_plain(x, *args).float().cpu().numpy().ravel()
    assert np.isfinite(a).all()
    if n > 1:
        assert np.corrcoef(a, b)[0, 1] > MIN_CORR
    assert np.mean(np.abs(a - b)) < MAX_MEAN_ABS


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(25600, 32), (6400, 256), (400, 512)])
def test_mhc_block_plain_products_ignore_the_precision_flags(n, d):
    """The plain versions, the kernels' references, sum every product in
    fp32 whether TF32 and reduced-precision bf16 reductions are on or off
    (bf16 operands are exact in TF32): the two settings differ only in sum
    order, so two bf16 results differ by at most one bf16 ulp plus the fp32
    sum-order bound 2·K·2^-24·(|x| @ |w|) (a bf16 sum would miss it by
    ~2^-8·(|x| @ |w|))."""
    _need_card()
    cuda_mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (cuda_mm.allow_tf32, cudnn.allow_tf32,
             cuda_mm.allow_bf16_reduced_precision_reduction)
    x, args = _cuda_inputs(n, d, seed=d + 3)
    outs = []
    try:
        for on in (True, False):
            cuda_mm.allow_tf32 = cudnn.allow_tf32 = on
            cuda_mm.allow_bf16_reduced_precision_reduction = on
            outs.append(mhc_mod._mm(x, args[0]).float())
    finally:
        (cuda_mm.allow_tf32, cudnn.allow_tf32,
         cuda_mm.allow_bf16_reduced_precision_reduction) = saved
    a, b = outs
    scale = (x.double().abs() @ args[0].double().abs()).float()
    assert torch.isfinite(a).all()
    bound = 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 2 * d * 2.0 ** -24 * scale
    assert bool(((a - b).abs() <= bound).all())


NAN_BITS = 0x7FC0  # a bf16 NaN: no output of the kernel


def _launch_into_larger_buffer(unfolded, x, args, extra=40):
    """One launch of the kernel (the wrapper's plan) into a buffer of
    ``extra`` more rows than x, filled with NaN; returns the first N rows
    after checking that the rest still hold the NaN bits."""
    n, d = x.shape
    out = torch.full((n + extra, d), NAN_BITS, dtype=torch.int16, device="cuda")
    out = out.view(torch.bfloat16)
    if unfolded:
        mhc_mod._launch("hvs_mhc_block_unfolded", x, mhc_mod.UNFOLDED_OPERANDS, args, out=out)
    else:
        mhc_mod._launch("hvs_mhc_block", x, mhc_mod.SERVE_OPERANDS, args, out=out)
    torch.cuda.synchronize()
    assert (out[n:].view(torch.int16) == NAN_BITS).all(), "a row past N was written"
    return out[:n]


def _edge_row_counts(d):
    """Row counts where a tiled launch goes wrong: 1, one under and one over
    the tile, and more tiles than the card holds at once (every SM full of
    blocks, by threads) with a last tile of one row."""
    bm = mhc_mod.ROW_TILE[d]
    props = torch.cuda.get_device_properties(0)
    per_sm = getattr(props, "max_threads_per_multi_processor", 2048) // mhc_mod.THREADS
    return [1, bm - 1, bm + 1, props.multi_processor_count * per_sm * bm + 1]


@pytest.mark.gpu
@pytest.mark.parametrize("unfolded", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128, 256, 512])
def test_mhc_block_kernel_edge_row_counts(d, unfolded):
    """Kernel against plain at the edge row counts, in both modes; no row
    past N is written."""
    _need_card()
    for n in _edge_row_counts(d):
        x, args = _cuda_inputs(n, d, seed=n + d)
        if unfolded:
            args = _unfolded_args(args, d, seed=d)
        plan = mhc_mod.launch_plan(n, d)
        out = _launch_into_larger_buffer(unfolded, x, args)
        plain = mhc_mod.mhc_block_unfolded_plain if unfolded else mhc_mod.mhc_block_plain
        a = out.float().cpu().numpy().ravel()
        b = plain(x, *args).float().cpu().numpy().ravel()
        assert np.isfinite(a).all(), n
        if n > 1:
            assert np.corrcoef(a, b)[0, 1] > MIN_CORR, (n, plan)
        assert np.mean(np.abs(a - b)) < MAX_MEAN_ABS, (n, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("unfolded", [False, True])
def test_mhc_block_kernel_is_deterministic(unfolded):
    """No atomics, a fixed sum order: two launches give the same bits, at
    d = 64, 256 and 512."""
    _need_card()
    for n, d in ((5000 * 64 + 17, 64), (25600, 256), (6400, 256), (1352, 512)):
        x, args = _cuda_inputs(n, d, seed=d)
        if unfolded:
            args = _unfolded_args(args, d, seed=d)
        fn = mhc_mod.mhc_block_unfolded if unfolded else mhc_mod.mhc_block
        first, second = fn(x, *args), fn(x, *args)
        torch.cuda.synchronize()
        assert torch.equal(first.view(torch.int16), second.view(torch.int16)), (n, d)


def _sinkhorn_logits(shape, seed, scale=1.0):
    """Logits at the mHC init scale plus ``scale`` standard normal noise."""
    r = np.random.default_rng(seed)
    n = shape[-1]
    limit = math.sqrt(3.0 * 0.1 / n)
    x = r.uniform(-limit, limit, shape) + scale * r.standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 32, 64, 77, 128, 256, 384, 512, 640])
def test_sinkhorn_kernel_forward_and_backward_match_plain_version(n):
    """P to 1e-6 absolute, row sums exact to fp32 (1e-5), the unrolled
    gradient to 1e-5 of its largest magnitude."""
    _need_card()
    logits = _sinkhorn_logits((n, n), seed=n)
    weight = _sinkhorn_logits((n, n), seed=n + 1)
    x = logits.clone().requires_grad_()
    before = (sink_mod.launches_forward, sink_mod.launches_backward)
    p = sinkhorn_log(x, 20)
    (p * weight).sum().backward()
    torch.cuda.synchronize()
    assert (sink_mod.launches_forward, sink_mod.launches_backward) == \
        (before[0] + 1, before[1] + 1)
    ref = logits.clone().requires_grad_()
    p_ref = sink_mod.sinkhorn_log_plain(ref, 20)
    (p_ref * weight).sum().backward()
    assert float((p - p_ref).abs().max()) <= 1e-6
    assert float((p.sum(dim=-1) - 1.0).abs().max()) <= 1e-5
    g, g_ref = x.grad, ref.grad
    assert torch.isfinite(g).all()
    assert float((g - g_ref).abs().max()) <= 1e-5 * float(g_ref.abs().max())


@pytest.mark.gpu
def test_sinkhorn_kernel_batch_and_temperature():
    """One launch over a batch of matrices, with tau != 1."""
    _need_card()
    logits = _sinkhorn_logits((3, 48, 48), seed=7)
    x = logits.clone().requires_grad_()
    p = sinkhorn_log(x, 7, 0.7)
    p.square().sum().backward()
    ref = logits.clone().requires_grad_()
    p_ref = sink_mod.sinkhorn_log_plain(ref, 7, 0.7)
    p_ref.square().sum().backward()
    assert float((p - p_ref).abs().max()) <= 1e-6
    assert float((x.grad - ref.grad).abs().max()) <= 1e-5 * float(ref.grad.abs().max())


def _check_against_plain(logits, weight, n_iters=20, tau=1.0, cluster=0):
    """Forward and backward launches (``cluster`` blocks per matrix, 0: the
    wrapper's choice) against the plain version: P to 1e-6, row sums to 1e-5,
    the gradient to 1e-5 of its largest magnitude, per matrix."""
    p, hist = sink_mod.sinkhorn_forward(logits, n_iters, tau, keep_history=True, cluster=cluster)
    grad = sink_mod.sinkhorn_backward(logits, p, weight, hist, n_iters, tau, cluster=cluster)
    torch.cuda.synchronize()
    ref = logits.clone().requires_grad_()
    p_ref = sink_mod.sinkhorn_log_plain(ref, n_iters, tau)
    (p_ref * weight).sum().backward()
    assert torch.isfinite(p).all() and torch.isfinite(grad).all()
    for i in range(logits.shape[0]):
        assert float((p[i] - p_ref[i]).abs().max()) <= 1e-6, i
        assert float((p[i].sum(dim=-1) - 1.0).abs().max()) <= 1e-5, i
        g_ref = ref.grad[i]
        assert float((grad[i] - g_ref).abs().max()) <= 1e-5 * float(g_ref.abs().max()), i


@pytest.mark.gpu
@pytest.mark.parametrize("n", [32, 77, 128, 256, 384, 512, 640])
def test_sinkhorn_kernel_batch_of_matrices_matches_plain_version(n):
    """One launch over three matrices of one width (a cluster per matrix up
    to 512, the streamed kernels at 640)."""
    _need_card()
    logits = _sinkhorn_logits((3, n, n), seed=n + 5)
    weight = _sinkhorn_logits((3, n, n), seed=n + 6)
    before = (sink_mod.launches_forward, sink_mod.launches_backward)
    _check_against_plain(logits, weight)
    assert (sink_mod.launches_forward, sink_mod.launches_backward) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("n,cluster", [(8, 1), (77, 2), (77, 4), (128, 4), (200, 8),
                                       (256, 8), (384, 16), (512, 16)])
def test_sinkhorn_kernel_every_cluster_size_matches_plain_version(n, cluster):
    """Cluster sizes other than the wrapper's choice, with uneven row splits (77 over
    4 blocks: 20, 20, 20, 17 rows; 200 over 8: 25 each; 384 over 16)."""
    _need_card()
    for backward in (False, True):
        plan = sink_mod.launch_plan(n, backward=backward, cluster=cluster)
        assert plan["cluster"] == cluster and plan["max_active_clusters"] >= 1
    logits = _sinkhorn_logits((2, n, n), seed=n + cluster)
    weight = _sinkhorn_logits((2, n, n), seed=n + cluster + 1)
    _check_against_plain(logits, weight, n_iters=7, tau=0.7, cluster=cluster)


@pytest.mark.gpu
def test_sinkhorn_launch_plans_fit_the_card():
    """Every width's cluster, in both directions, can be scheduled: up to 512
    a cluster (16 blocks for the backward at 512, a non-portable size), above
    it one block per matrix."""
    _need_card()
    for n in (8, 32, 64, 77, 128, 256, 384, 512, 640, 1024):
        for backward in (False, True):
            plan = sink_mod.launch_plan(n, backward=backward)
            assert plan["max_active_clusters"] >= 1, (n, backward, plan)
            assert plan["smem_bytes"] <= 232448
            assert (plan["cluster"] == 1) if n > sink_mod.CLUSTER_MAX_N else plan["cluster"] >= 1


@pytest.mark.gpu
def test_sinkhorn_grouped_call_launches_once_per_width():
    """sinkhorn_log_many over widths 32, 256, 32, 512, 256, 64, 256: one
    forward and one backward launch per width; each P and gradient as the
    plain version's."""
    _need_card()
    widths = [32, 256, 32, 512, 256, 64, 256]
    logits = [_sinkhorn_logits((n, n), seed=40 + i) for i, n in enumerate(widths)]
    weights = [_sinkhorn_logits((n, n), seed=60 + i) for i, n in enumerate(widths)]
    xs = [x.clone().requires_grad_() for x in logits]
    before = (sink_mod.launches_forward, sink_mod.launches_backward)
    ps = sink_mod.sinkhorn_log_many(xs, 20)
    sum((p * w).sum() for p, w in zip(ps, weights)).backward()
    torch.cuda.synchronize()
    assert (sink_mod.launches_forward, sink_mod.launches_backward) == \
        (before[0] + 4, before[1] + 4)
    with torch.no_grad():
        sink_mod.sinkhorn_log_many(logits, 20)
    assert sink_mod.launches_forward == before[0] + 8
    for x, p, w, logit in zip(xs, ps, weights, logits):
        ref = logit.clone().requires_grad_()
        p_ref = sink_mod.sinkhorn_log_plain(ref, 20)
        (p_ref * w).sum().backward()
        assert float((p - p_ref).abs().max()) <= 1e-6
        assert float((x.grad - ref.grad).abs().max()) <= 1e-5 * float(ref.grad.abs().max())


@pytest.mark.gpu
def test_sinkhorn_plain_version_passes_gradcheck():
    _need_card()
    x = _sinkhorn_logits((8, 8), seed=3).double().requires_grad_()
    assert torch.autograd.gradcheck(lambda v: sink_mod.sinkhorn_log_plain(v, 20), (x,))


@pytest.mark.gpu
def test_sinkhorn_wrapper_raises_instead_of_falling_back():
    _need_card()
    x = _sinkhorn_logits((32, 32), seed=0)
    with pytest.raises(TypeError):
        sinkhorn_log(x.double(), 20)  # the kernel takes fp32 only
    with pytest.raises(TypeError):
        sinkhorn_log(x.to(torch.bfloat16), 20)
    with pytest.raises(ValueError):
        sinkhorn_log(x[:, :16].contiguous(), 20)  # not square
    with pytest.raises(ValueError):
        sinkhorn_log(torch.zeros(2048, 2048, device="cuda"), 20)  # larger than the kernel takes
    with pytest.raises(ValueError):
        sinkhorn_log(x.t(), 20)  # not contiguous


@pytest.mark.gpu
def test_sinkhorn_kernel_is_deterministic():
    """The cluster exchange merges partials in a fixed order: the same inputs
    give the same bits, run after run (a race between blocks would not)."""
    _need_card()
    for n, batch in ((32, 2), (77, 3), (256, 15), (512, 1)):
        logits = _sinkhorn_logits((batch, n, n), seed=n + 9)
        dp = _sinkhorn_logits((batch, n, n), seed=n + 10)
        runs = []
        for _ in range(3):
            p, hist = sink_mod.sinkhorn_forward(logits, 20, keep_history=True)
            runs.append((p, hist, sink_mod.sinkhorn_backward(logits, p, dp, hist, 20)))
        torch.cuda.synchronize()
        for other in runs[1:]:
            for a, b in zip(runs[0], other):
                assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# The serving engine: one CUDA graph per bucket


def _tiny_card_engine(seed=0, variables=None):
    """A small bf16 engine on the card whose mHC sites at d = 32, 64, 128 and
    256 run kernel A; threshold 1e-4 so that random weights detect (their
    scores sit near sigmoid(-4)^2 = 3e-4)."""
    from hvs_tpu_torch.config import InferenceConfig, ModelConfig
    from hvs_tpu_torch.inference import InferenceEngine

    mc = ModelConfig(input_size=64, device="cuda")
    mc.backbone.stage_blocks, mc.backbone.stage_channels = (1, 1, 1, 1), (32, 64, 128, 256)
    mc.vit.dim, mc.vit.depth, mc.vit.num_heads = 64, 1, 4
    mc.fusion.fpn_channels, mc.detection.head_channels = 64, 64
    mc.detection.num_classes, mc.mhc.sinkhorn_iterations = 3, 5
    ic = InferenceConfig(device="cuda")
    ic.preprocessing.image_size = 64
    ic.performance.batch_buckets = (1, 2)
    ic.postprocessing.score_threshold = 1e-4
    ic.postprocessing.pre_nms_top_k = 64
    ic.postprocessing.max_detections = 16
    return InferenceEngine(mc, ic, variables=variables, rng_seed=seed)


def _tiny_rag_card_engine(buckets=(4,)):
    """``_tiny_card_engine``'s model with ``rag.enabled`` (the shapes
    classes) and its gate open: the knowledge module's mHC layer (d = 256)
    is one more kernel-A site."""
    from hvs_tpu_torch.config import InferenceConfig, ModelConfig
    from hvs_tpu_torch.data.shapes import SHAPE_CLASSES
    from hvs_tpu_torch.inference import InferenceEngine

    base = _tiny_card_engine()
    mc, ic = base.model_config, base.config
    mc.rag.enabled, mc.rag.class_names = True, SHAPE_CLASSES
    ic.performance.batch_buckets = buckets
    engine = InferenceEngine(mc, ic)
    with torch.no_grad():
        engine.model.rag_gate.fill_(0.5)
    return engine, base.kernel_sites


def _frames(seed, n, h=48, w=64):
    return list(np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("raw", [False, True])
def test_engine_graph_replay_equals_eager(raw):
    _need_card()
    engine = _tiny_card_engine()
    engine.warmup([(48, 64)] if raw else [])
    entry = engine._serve_fn_raw(2, (48, 64)) if raw else engine._serve_fn(2)
    frames = _frames(1, 2, *((48, 64) if raw else (64, 64)))
    with engine._serve_lock, torch.cuda.stream(engine._stream):
        entry.stage(frames, engine._stream)
        out, done = entry.run(engine._stream)
        eager = entry.serve_eager(entry.static_in)
        torch.cuda.synchronize()
    assert entry.graph is not None
    assert out[:, 0, 6].sum() > 0  # detections to compare
    assert torch.equal(out, eager.cpu())


@pytest.mark.gpu
def test_rag_engine_bucket_4_graph_replays_as_eager():
    """A retrieval model's bucket-4 graph (top-k and gather of the knowledge
    base inside it) replays bitwise as its eager serve function, with kernel
    A at one more site than the same model without retrieval."""
    _need_card()
    engine, plain_sites = _tiny_rag_card_engine()
    assert engine.kernel_sites == plain_sites + 1 and engine.model.rag.mhc_fuse.fused
    before = mhc_mod.launches
    entry = engine._serve_fn(4)
    assert mhc_mod.launches > before  # captured with the kernel
    frames = _frames(2, 4, 64, 64)
    with engine._serve_lock, torch.cuda.stream(engine._stream):
        entry.stage(frames, engine._stream)
        out, done = entry.run(engine._stream)
        eager = entry.serve_eager(entry.static_in)
        torch.cuda.synchronize()
    assert entry.graph is not None
    assert out[:, 0, 6].sum() > 0
    assert torch.equal(out, eager.cpu())


@pytest.mark.gpu
def test_engine_reload_after_capture_reaches_the_graph():
    """reload copies into the captured parameters and constraint buffers,
    so the graph serves the new weights; as an engine built on them."""
    _need_card()
    engine = _tiny_card_engine(seed=0)
    engine.warmup()
    frame = _frames(2, 1, 64, 64)[0]
    before = engine.infer(frame)
    other = _tiny_card_engine(seed=1)
    new = {k: v.detach().clone() for k, v in other.model.named_parameters()}
    engine.reload({"params": new})
    after = engine.infer(frame)
    want = other.infer(frame)
    assert len(before) != len(after) or not np.allclose(before.scores, after.scores)
    assert len(after) == len(want)
    np.testing.assert_allclose(after.scores, want.scores, atol=1e-6)
    np.testing.assert_allclose(after.boxes, want.boxes, atol=1e-3)


@pytest.mark.gpu
def test_engine_threads_dispatching_at_once_get_their_own_results():
    import threading

    _need_card()
    engine = _tiny_card_engine()
    engine.warmup([(48, 64)])
    frames = _frames(3, 2)
    # Thread i serves bucket 1 + i: its reference comes from the same graph.
    want = [engine.infer_batch([f] * (1 + i))[0] for i, f in enumerate(frames)]
    errors = []

    def serve(i):
        try:
            for _ in range(20):
                got = engine.infer_batch([frames[i]] * (1 + i))
                for det in got:
                    assert len(det) == len(want[i])
                    np.testing.assert_allclose(det.scores, want[i].scores, atol=1e-6)
        except Exception as err:  # surfaced below
            errors.append(err)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


@pytest.mark.gpu
def test_engine_counts_replays_and_kernel_a_counts_captures():
    """Kernel A's counter counts launches at capture (and the eager warm-up
    calls before it), not replays; the engine counts replays per graph, so
    A's launches on the serve path are replays x kernel sites."""
    _need_card()
    engine = _tiny_card_engine()
    assert engine.kernel_sites >= 4
    engine.warmup()
    launches = mhc_mod.launches
    replays = sum(engine.replays.values())
    for frame in _frames(4, 5, 64, 64):
        engine.infer(frame)
    assert mhc_mod.launches == launches
    assert sum(engine.replays.values()) == replays + 5
    assert engine.replays[1] >= 5


# ---------------------------------------------------------------------------
# The on-device training loop: one captured train step per resolution


def _card_trainer(seed=0, **config):
    """A small bf16 flagship-shaped model on the card (kernel C at its
    fused sites of d = 32, 64 and 128, kernel B at five widths), trained
    with warm-up 2, a projection every second step and an EMA."""
    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.training import ManifoldConstrainedTrainer, TrainerConfig

    model = HybridVisionSystem(num_classes=4, stage_blocks=(1, 1, 1, 1),
                               stage_channels=(32, 64, 128, 256), vit_dim=64, vit_depth=1,
                               vit_heads=4, fpn_channels=64, head_channels=64, feature_dim=64,
                               sk_iters=5, monitor=True, seed=seed, device="cuda")
    trainer = ManifoldConstrainedTrainer(
        model, TrainerConfig(num_classes=4, warmup_steps=2, project_every=2, ema_decay=0.9,
                             sk_iters=5, **config), seed=seed)
    trainer.init_state()
    return trainer


def _card_data(seed=0, n=8, size=80, boxes=8):
    from hvs_tpu_torch.data import put_device_data

    r = np.random.default_rng(seed)
    wh = r.uniform(0.1, 0.5, (n, boxes, 2))
    return put_device_data(r.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
                           np.concatenate([r.uniform(wh / 2, 1 - wh / 2), wh], -1),
                           r.integers(0, 4, (n, boxes)), (r.uniform(size=(n, boxes)) > 0.3),
                           device="cuda")


def _widths(trainer):
    return len({leaf.shape[-1] for name, leaf in trainer.model.named_parameters()
                if name.endswith("H_res_raw")})


@pytest.mark.gpu
def test_captured_train_step_replays_as_the_eager_step():
    """From one state (parameters, optimizer state and count, EMA,
    generator), a replay of the captured step and the same step run eagerly
    draw the same batch and compute the same loss; the updates agree to the
    fp32 train-parity limits (backward atomics may reorder sums). A
    projection step (count 1 -> 2)."""
    from hvs_tpu_torch.data import AugmentConfig
    from hvs_tpu_torch.training.chunk import TrainChunk

    _need_card()
    trainer = _card_trainer()
    chunk = TrainChunk(trainer, _card_data(), 64, 2, 3, AugmentConfig())
    w = _widths(trainer)
    assert chunk.graph is not None
    assert chunk.launches == {"mhc_block": 0, "mhc_block_unfolded": 0,
                              "sinkhorn_forward": 3 * w, "sinkhorn_backward": 2 * w}
    assert int(trainer.tx.count) == 0  # the warm-up steps were undone
    trainer.tx.count.fill_(1)
    state = trainer.state_tensors()
    start = [x.detach().clone() for x in state]
    gen = trainer.generator.get_state()

    def run(replay):
        chunk.pos.zero_()
        chunk.replay() if replay else chunk.step()
        torch.cuda.synchronize()
        out = dict(row=chunk.metrics[0].clone(), state=[x.detach().clone() for x in state],
                   draws=[d.clone() for d in chunk.last_draws],
                   images=chunk.last_batch["images"].clone())
        with torch.no_grad():
            for x, v in zip(state, start):
                x.copy_(v)
        trainer.generator.set_state(gen)
        return out

    g, e = run(True), run(False)
    assert all(torch.equal(a, b) for a, b in zip(g["draws"], e["draws"]))
    assert torch.equal(g["images"], e["images"])
    row = dict(zip(chunk.keys, zip(g["row"].tolist(), e["row"].tolist())))
    for k in ("loss", "detection_loss", "box_loss", "obj_loss", "cls_loss", "lr",
              "ds_error_max", "signal_ratio_mean", "num_positives"):
        assert row[k][0] == row[k][1], (k, row[k])
    assert abs(row["grad_norm"][0] - row["grad_norm"][1]) <= 1e-3 * row["grad_norm"][1]
    lr = trainer.schedule(1)
    n_params = len(list(trainer.model.parameters()))
    upd_g = torch.cat([(a - s).flatten() for a, s in zip(g["state"][:n_params], start)])
    upd_e = torch.cat([(a - s).flatten() for a, s in zip(e["state"][:n_params], start)])
    cos = float((upd_g * upd_e).sum() / (upd_g.norm() * upd_e.norm()))
    assert cos > 0.999 and float((upd_g - upd_e).abs().max()) <= 2 * lr + 1e-6
    assert int(g["state"][n_params]) == int(e["state"][n_params]) == 2  # the count


@pytest.mark.gpu
def test_two_replays_draw_new_batches_and_dropout():
    """The trainer's generator is registered with the graph: each replay
    advances it, so the indices, augmentations and dropout masks differ."""
    from hvs_tpu_torch.data import AugmentConfig
    from hvs_tpu_torch.training.chunk import TrainChunk

    _need_card()
    trainer = _card_trainer(seed=1)
    chunk = TrainChunk(trainer, _card_data(seed=1, n=64), 64, 4, 2, AugmentConfig())
    offset = trainer.generator.get_offset()
    draws = []
    chunk.pos.zero_()
    for _ in range(2):
        chunk.replay()
        draws.append([d.clone() for d in chunk.last_draws])
    torch.cuda.synchronize()
    assert trainer.generator.get_offset() > offset
    assert not torch.equal(draws[0][5], draws[1][5])  # zoom
    assert not torch.equal(draws[0][0], draws[1][0])  # indices
    rows = chunk.metrics.cpu()
    assert rows[0, chunk.keys.index("loss")] != rows[1, chunk.keys.index("loss")]


@pytest.mark.gpu
@pytest.mark.parametrize("n,count", [(32, 2), (64, 3), (128, 4), (256, 15), (512, 1), (640, 1)])
def test_sinkhorn_cluster_launches_replay_in_a_graph_as_eager(n, count):
    """Kernel B's cluster launches (cudaLaunchKernelEx) and the streamed
    ones captured in a CUDA graph: a replay gives exactly the eager results."""
    _need_card()
    r = np.random.default_rng(n)
    logits = torch.from_numpy(r.standard_normal((count, n, n)).astype(np.float32)).cuda()
    dp = torch.from_numpy(r.standard_normal((count, n, n)).astype(np.float32)).cuda()
    p, hist = sink_mod.sinkhorn_forward(logits, 20, keep_history=True)
    grad = sink_mod.sinkhorn_backward(logits, p, dp, hist, 20)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sink_mod.sinkhorn_forward(logits, 20, keep_history=True)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        gp, ghist = sink_mod.sinkhorn_forward(logits, 20, keep_history=True)
        ggrad = sink_mod.sinkhorn_backward(logits, gp, dp, ghist, 20)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gp, p) and torch.equal(ghist, hist) and torch.equal(ggrad, grad)


@pytest.mark.gpu
def test_train_chunked_on_the_card():
    """Two sizes, two chunks of 3 steps each, validation after the last:
    one pull per chunk (the replays run under sync debug mode "error"), the
    step count on the device, finite metrics, a row of lr per step equal to
    the schedule, and kernel C at every fused site of the validation graph."""
    from hvs_tpu_torch.models.layers import ManifoldHyperConnection

    _need_card()
    trainer = _card_trainer(seed=2)
    data = _card_data(seed=2, n=16)
    result = trainer.train_chunked(data, total_steps=12, out_sizes=(64, 96),
                                   batch_sizes={64: 4, 96: 2}, chunk_steps=3, val_data=data,
                                   val_batch_size=4, val_every_chunks=4, eig_every_chunks=2)
    assert trainer.state.step == 12 and int(trainer.tx.count) == 12
    assert {o: (c.pulls, c.replays) for o, c in trainer.chunks.items()} == {64: (2, 6),
                                                                            96: (2, 6)}
    assert trainer.val_chunk.pulls == 1 and trainer.val_chunk.replays == 4
    fused = sum(1 for m in trainer.model.modules()
                if isinstance(m, ManifoldHyperConnection) and m.fused)
    assert fused >= 3
    assert trainer.val_chunk.launches["mhc_block_unfolded"] == fused
    assert trainer.val_chunk.launches["sinkhorn_forward"] == _widths(trainer)
    assert np.isfinite(result["best_val_loss"])
    assert np.isfinite(result["history"]["train_loss"]).all()
    for chunk in trainer.chunks.values():
        assert all(np.isfinite(t["device_ms"]) and t["device_ms"] > 0 for t in chunk.timings)


# ---------------------------------------------------------------------------
# The multi-task model and the lightweight variant


@pytest.mark.gpu
@pytest.mark.parametrize("n", [24, 48, 96, 192])
def test_sinkhorn_kernel_at_the_lightweight_widths_matches_plain_version(n):
    """The lightweight model's bottleneck widths (24 and 48 leave warps
    partly idle in the column exchanges), three matrices in one launch."""
    _need_card()
    logits = _sinkhorn_logits((3, n, n), seed=n + 7)
    weight = _sinkhorn_logits((3, n, n), seed=n + 8)
    before = (sink_mod.launches_forward, sink_mod.launches_backward)
    _check_against_plain(logits, weight)
    assert (sink_mod.launches_forward, sink_mod.launches_backward) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_captured_multi_task_step_replays_as_the_eager_step():
    """The multi-task step (uniform indices, both dense heads,
    ``multi_task_loss``) captured by ``MultiTaskChunk``: from one state a
    replay and the eager step draw the same rows and compute the same loss,
    and the updates agree to the fp32 train-parity limits; the validation
    graph runs kernel C at every fused site."""
    from hvs_tpu_torch.data import put_dense_data
    from hvs_tpu_torch.models import HybridVisionSystem
    from hvs_tpu_torch.models.layers import ManifoldHyperConnection
    from hvs_tpu_torch.train_multitask import synthetic_dense_arrays
    from hvs_tpu_torch.training import (ManifoldConstrainedTrainer, MultiTaskChunk,
                                        MultiTaskEval, TrainerConfig)

    _need_card()
    model = HybridVisionSystem(num_classes=4, stage_blocks=(1, 1, 1, 1),
                               stage_channels=(32, 64, 128, 256), vit_dim=64, vit_depth=1,
                               vit_heads=4, fpn_channels=64, head_channels=64, feature_dim=64,
                               sk_iters=5, use_segmentation=True, use_depth=True,
                               task="multi_task", device="cuda")
    trainer = ManifoldConstrainedTrainer(
        model, TrainerConfig(num_classes=4, warmup_steps=2, project_every=2, sk_iters=5))
    trainer.init_state()
    data = put_dense_data(*synthetic_dense_arrays(8, 64, 6, 4, seed=0), device="cuda")
    chunk = MultiTaskChunk(trainer, data, 2, 3)
    w = _widths(trainer)
    assert chunk.graph is not None and int(trainer.tx.count) == 0
    assert chunk.launches == {"mhc_block": 0, "mhc_block_unfolded": 0,
                              "sinkhorn_forward": 3 * w, "sinkhorn_backward": 2 * w}
    trainer.tx.count.fill_(1)
    state = trainer.state_tensors()
    start = [x.detach().clone() for x in state]
    gen = trainer.generator.get_state()

    def run(replay):
        chunk.pos.zero_()
        chunk.replay() if replay else chunk.step()
        torch.cuda.synchronize()
        out = dict(row=chunk.metrics[0].clone(), state=[x.detach().clone() for x in state],
                   idx=chunk.last_draws.clone())
        with torch.no_grad():
            for x, v in zip(state, start):
                x.copy_(v)
        trainer.generator.set_state(gen)
        return out

    g, e = run(True), run(False)
    assert torch.equal(g["idx"], e["idx"])
    row = dict(zip(chunk.keys, zip(g["row"].tolist(), e["row"].tolist())))
    for k in ("loss", "detection_loss", "segmentation_loss", "segmentation_dice_loss",
              "depth_loss", "total_loss", "lr"):
        assert row[k][0] == row[k][1], (k, row[k])
    assert abs(row["grad_norm"][0] - row["grad_norm"][1]) <= 1e-3 * row["grad_norm"][1]
    n_params = len(list(trainer.model.parameters()))
    upd_g = torch.cat([(a - s).flatten() for a, s in zip(g["state"][:n_params], start)])
    upd_e = torch.cat([(a - s).flatten() for a, s in zip(e["state"][:n_params], start)])
    cos = float((upd_g * upd_e).sum() / (upd_g.norm() * upd_e.norm()))
    assert cos > 0.999 and float((upd_g - upd_e).abs().max()) <= 2 * trainer.schedule(1) + 1e-6

    evaluator = MultiTaskEval(trainer, data, 4)
    means, iou = evaluator.run()
    fused = sum(1 for m in model.modules() if isinstance(m, ManifoldHyperConnection) and m.fused)
    assert fused >= 3
    assert evaluator.launches == {"mhc_block": 0, "mhc_block_unfolded": fused,
                                  "sinkhorn_forward": w, "sinkhorn_backward": 0}
    assert evaluator.replays == 2 and evaluator.pulls == 1
    assert np.isfinite(list(means.values())).all() and np.isfinite(iou).all()


@pytest.mark.gpu
def test_lightweight_detector_launches_kernel_a_at_its_six_sites():
    from hvs_tpu_torch.inference import Detector
    from hvs_tpu_torch.models import LightweightHybridVision

    _need_card()
    det = Detector(LightweightHybridVision(precomputed_constraints=True, dropout_rate=0.0,
                                           num_classes=4))
    before = mhc_mod.launches
    boxes, scores, classes = det(torch.rand(2, 128, 128, 3, device="cuda"))
    torch.cuda.synchronize()
    assert mhc_mod.launches == before + 6
    assert boxes.shape == (2, 100, 4) and classes.dtype == torch.int32
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()


# ---------------------------------------------------------------------------
# Kernel A as the operator hvs::mhc_block: captured in a graph, exported


@pytest.mark.gpu
def test_mhc_block_operator_captures_in_a_graph():
    """The operator is capturable: a replay gives the eager launch's bits,
    and the counter counts the launch at capture, not at replay."""
    _need_card()
    x, args = _cuda_inputs(5000, 128, seed=3)
    eager = mhc_mod.mhc_block(x, *args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mhc_mod.mhc_block(x, *args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = mhc_mod.launches
    with torch.cuda.graph(graph):
        out = torch.ops.hvs.mhc_block(x, *args)
    assert mhc_mod.launches == before + 1
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert mhc_mod.launches == before + 1
    assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


@pytest.mark.gpu
def test_exported_program_launches_kernel_a_at_every_site(tmp_path):
    """``ModelExporter`` on the card: the saved program records one
    ``hvs::mhc_block`` per fused site, each call of the loaded program
    launches the kernel at every site, and its outputs equal the serve
    function's."""
    from hvs_tpu_torch.deployment.model_server import ModelExporter

    _need_card()
    engine = _tiny_card_engine()
    exporter = ModelExporter(engine.model, image_size=64)
    path = exporter.export_program(str(tmp_path / "model.pt2"), batch=2)
    program = exporter.load_program(path)
    nodes = sum("hvs.mhc_block" in str(n.target) for n in program.graph.nodes)
    assert nodes == engine.kernel_sites >= 4
    x = exporter.example_input(2)
    before = mhc_mod.launches
    with torch.no_grad():
        got = program(x)
        program(x)
        torch.cuda.synchronize()
        assert mhc_mod.launches == before + 2 * engine.kernel_sites
        want = exporter._serve_fn()(x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert exporter.consistency_check(path, batch=2)["consistent"]


@pytest.mark.gpu
def test_engine_recaptures_after_rebuild_serve_fns():
    """A config change drops every graph (``rebuild_serve_fns``); the next
    call captures anew, in a new memory pool, and reads the new threshold."""
    _need_card()
    engine = _tiny_card_engine()
    engine.warmup()
    frame = _frames(6, 1, 64, 64)[0]
    before = engine.infer(frame)
    threshold = float(np.sort(before.scores)[len(before) // 2])
    engine.config.postprocessing.score_threshold = threshold
    engine.rebuild_serve_fns()
    assert engine.replays == {}
    after = engine.infer(frame)
    assert engine.replays == {1: 1}
    keep = before.scores >= threshold
    assert 0 < len(after) == int(keep.sum()) < len(before)
    np.testing.assert_array_equal(after.classes, before.classes[keep])
    np.testing.assert_allclose(after.scores, before.scores[keep], atol=1e-6)
    engine.warmup()


@pytest.mark.gpu
def test_load_coco_arrays_uploads_equal_the_host_arrays(tmp_path):
    _need_card()
    from hvs_tpu_torch.data import (generate_shapes_dataset, load_coco_arrays, put_dense_data,
                                    put_device_data)

    root = str(tmp_path / "shapes")
    generate_shapes_dataset(root, num_train=4, num_val=2, size=96, seed=0, with_dense=True)
    for split in ("train", "val"):
        host = load_coco_arrays(root, split, max_boxes=16, dense=True)
        for data in (put_device_data(*host[:4]), put_dense_data(*host)):
            for t, a in zip(data, host):
                assert t.device.type == "cuda" and t.dtype == torch.from_numpy(a).dtype
                assert np.array_equal(t.cpu().numpy(), a)


@pytest.mark.gpu
def test_batch_augment_on_the_card_matches_the_cpu():
    _need_card()
    from hvs_tpu_torch.data import apply_batch_augment, batch_augment_device, draw_batch_augment

    images = torch.rand(8, 64, 48, 3, generator=torch.Generator().manual_seed(0)) * 4 - 2
    draws = draw_batch_augment(8, torch.Generator().manual_seed(1))
    cpu, cpu_flip = apply_batch_augment(images, draws)
    card, card_flip = apply_batch_augment(images.cuda(), draws)
    assert card.device.type == "cuda" and torch.equal(card_flip.cpu(), cpu_flip)
    # The same fp32 operations; only each image's mean is summed in another
    # order on the card (values within [-3, 3]).
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-6, atol=1e-5)
    # A generator on the card draws there.
    out, flipped = batch_augment_device(images.cuda(), torch.Generator("cuda").manual_seed(2))
    assert out.device.type == "cuda" and flipped.shape == (8,) and torch.isfinite(out).all()


# --- int8 serving: torch._int_mm against the exact integer product ---------


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(5, 20, 12), (17, 8, 8), (300, 36, 3), (409600, 288, 32),
                                   (25600, 2304, 256), (401, 64, 192)])
def test_int_mm_matches_the_plain_integer_product(m, k, n):
    """Ragged shapes take the zero padding (M <= 16, K or N not a multiple
    of 8); the others are flagship site shapes at 640² b16 (stage 1's 3x3,
    a head tower's 3x3) and the ViT's QKV at b1."""
    _need_card()
    from hvs_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b_t = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    before = quant.launches
    got = quant.int_mm(a.cuda(), b_t.cuda())
    assert quant.launches == before + 1 and got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), quant.int_mm_plain(a, b_t))


def _int8_flagship(**flags):
    """The full-width int8 serve model on the card, calibrated on two
    seeded 320² batches of 2."""
    from hvs_tpu_torch.models import ProductionHybridVision, compute_constraints, \
        load_constraints, param_tree
    from hvs_tpu_torch.models.quantize import calibrate_quant_scales, load_quant_scales

    float_model = ProductionHybridVision(device="cuda").eval()
    load_constraints(float_model, compute_constraints(param_tree(float_model)))
    g = torch.Generator().manual_seed(0)
    batches = [torch.randn(2, 320, 320, 3, generator=g).cuda() for _ in range(2)]
    scales = calibrate_quant_scales(float_model, batches)
    model = ProductionHybridVision(device="cuda", **flags).eval()
    model.load_state_dict(float_model.state_dict())
    load_constraints(model, compute_constraints(param_tree(model)))
    load_quant_scales(model, scales)
    return model, scales


@pytest.mark.gpu
def test_int8_products_at_every_site_shape_of_a_b16_forward():
    _need_card()
    from hvs_tpu_torch.ops import quant

    model, _ = _int8_flagship(act_quant=True, act_quant_fpn=True, act_quant_mhc=True,
                              act_quant_vit=True)
    seen, orig = {}, quant.int_mm

    def spy(a, b_t):
        seen.setdefault((a.shape[0], a.shape[1], b_t.shape[0]), (a, b_t))
        return orig(a, b_t)

    quant.int_mm = spy
    try:
        with torch.inference_mode():
            model(torch.randn(16, 640, 640, 3, device="cuda"))
    finally:
        quant.int_mm = orig
    assert len(seen) >= 20
    for (m, k, n), (a, b_t) in seen.items():
        assert torch.equal(orig(a, b_t).cpu(), quant.int_mm_plain(a, b_t)), (m, k, n)


@pytest.mark.gpu
def test_int8_engine_replay_matches_eager_and_reload_reaches_the_graph(tmp_path):
    _need_card()
    from hvs_tpu_torch.config import InferenceConfig, ModelConfig
    from hvs_tpu_torch.inference import InferenceEngine

    model, scales = _int8_flagship(act_quant=True, act_quant_mhc=True)
    torch.save(scales, tmp_path / "scales.pt")
    mcfg = ModelConfig()
    mcfg.quantization.enabled, mcfg.quantization.quantize_mhc = True, True
    mcfg.quantization.scales_path = str(tmp_path / "scales.pt")
    icfg = InferenceConfig()
    icfg.preprocessing.image_size = 320
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    engine = InferenceEngine(mcfg, icfg, variables={"params": params})
    assert engine.kernel_sites == 7
    entry = engine._serve_fn(2)
    frames = np.random.default_rng(0).integers(0, 255, (2, 320, 320, 3), np.uint8)

    def replay_and_eager():
        with engine._serve_lock, torch.cuda.stream(engine._stream):
            entry.static_in.copy_(torch.from_numpy(frames))
            out, _ = entry.run(engine._stream)
            eager = entry.serve_eager(entry.static_in)
        torch.cuda.synchronize()
        return out.numpy().copy(), eager.cpu().numpy()

    before, eager = replay_and_eager()
    assert np.array_equal(before, eager)
    engine.reload({"params": params, "quant": {k: v * 1.5 for k, v in scales.items()}})
    after, eager = replay_and_eager()
    assert np.array_equal(after, eager) and not np.array_equal(before, after)


# ---------------------------------------------------------------------------
# Soft and matrix NMS in the engine's graphs; the inference CLI


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["soft", "matrix"])
def test_engine_soft_and_matrix_nms_replay_equals_eager(method):
    """A graph captured with soft or matrix NMS at bucket 4 (soft NMS runs
    all pre_nms_top_k trips under the capture) equals its eager run. The
    head is conditioned (kernels x4, objectness and class biases 1) so that
    decayed scores pass matrix NMS's final threshold of 0.05."""
    _need_card()
    engine = _tiny_card_engine()
    params = {k: v.detach().clone() for k, v in engine.model.named_parameters()}
    for name, value in params.items():
        if ".predict." in name and name.endswith("kernel"):
            value.mul_(4.0)
        elif ".predict." in name:
            value.view(3, -1)[:, 4:] = 1.0
    engine.reload({"params": params})
    engine.config.postprocessing.nms_method = method
    engine.config.performance.batch_buckets = (1, 4)
    engine.rebuild_serve_fns()
    entry = engine._serve_fn(4)
    with engine._serve_lock, torch.cuda.stream(engine._stream):
        entry.stage(_frames(3, 4, 64, 64), engine._stream)
        out, done = entry.run(engine._stream)
        eager = entry.serve_eager(entry.static_in)
        torch.cuda.synchronize()
    assert entry.graph is not None and entry.nms_method == method
    assert out[:, 0, 6].sum() > 0
    assert torch.equal(out, eager.cpu())


@pytest.mark.gpu
def test_infer_cli_on_the_card(tmp_path):
    """``python -m hvs_tpu_torch.infer --tiny`` on one image on the card: the
    results file's keys, and the image's detections bitwise those of
    ``engine.infer`` on the decoded frame."""
    _need_card()
    import json

    import cv2

    from hvs_tpu_torch import infer

    image = str(tmp_path / "frame.jpg")
    cv2.imwrite(image, _frames(4, 1, 120, 160)[0])
    run = infer.main(["--tiny", "--image", image, "--score-threshold", "1e-4",
                      "--output", str(tmp_path / "out")])
    assert run.engine.device.type == "cuda" and run.engine._serve_fns[1].graph is not None
    det = run.engine.infer(cv2.imread(image))
    got = run.results[0]["detections"]
    assert run.results[0]["num_detections"] == len(det) > 0
    assert np.array_equal(np.asarray(got["boxes"], np.float32).reshape(-1, 4), det.boxes)
    assert np.array_equal(np.asarray(got["scores"], np.float32), det.scores)
    assert np.array_equal(np.asarray(got["classes"]), det.classes)
    with open(run.results_file) as f:
        assert set(json.load(f)) == {"results", "performance"}


@pytest.mark.gpu
def test_probe_is_healthy_on_the_card_and_launches_a_and_b_once():
    from hvs_tpu_torch import build
    from hvs_tpu_torch.deployment import probe

    _need_card()
    build.build(build.sources())
    a0, b0 = mhc_mod.launches, sink_mod.launches_forward
    report = probe.run()
    assert report["capability"] == [9, 0]
    assert set(report["libraries"]) == set(build.sources())
    assert report["a_corr"] > MIN_CORR and report["memory_in_use"] < probe.MEMORY_LIMIT
    assert (mhc_mod.launches - a0, sink_mod.launches_forward - b0) == (1, 1)
    assert probe.main([]) == 0


@pytest.mark.gpu
def test_two_processes_share_the_card_in_a_tensor_parallel_step(tmp_path):
    """``python -m hvs_tpu_torch.train --n-model 2`` under torchrun with both
    processes on card 0 over gloo (NCCL refuses two processes on one
    device): a 1 x 2 mesh trains the tiny model for two steps, each process
    on ``cuda:0``, and writes a checkpoint in the one-process layout."""
    import json
    import os
    import socket
    import subprocess
    import sys

    _need_card()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(port), "-m", "hvs_tpu_torch.train", "--synthetic", "--tiny",
           "--device", "cuda:0", "--backend", "gloo", "--n-model", "2", "--steps", "2",
           "--epochs", "1", "--num-classes", "8", "--checkpoint-dir", str(tmp_path / "ckpt"),
           "--log-dir", str(tmp_path / "logs")]
    out = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1"),
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    decoder, text = json.JSONDecoder(), out.stdout
    summaries = [decoder.raw_decode(text, i)[0] for i in range(len(text))
                 if text.startswith('{"device"', i)]
    assert len(summaries) == 2
    assert all(s["device"] == "cuda:0" and s["mesh"] == {"data": 1, "model": 2}
               and s["steps"] == 2 and np.isfinite(s["train_loss"]).all() for s in summaries)
    best = torch.load(tmp_path / "ckpt" / "best.pt", map_location="cpu")
    assert all(torch.isfinite(v).all() for v in best["params"].values())


def _conditioned_flagship_checkpoint(path):
    """The flagship's seeded weights with the prediction convs conditioned
    (kernels x4, objectness and class biases 1), saved as a port checkpoint."""
    from hvs_tpu_torch.models import ProductionHybridVision

    model = ProductionHybridVision(seed=0, device="cpu")
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    for name, value in params.items():
        if ".predict." in name and name.endswith("kernel"):
            value.mul_(4.0)
        elif ".predict." in name:
            value.view(3, -1)[:, 4:] = 1.0
    torch.save({"params": params}, path)
    return path


@pytest.mark.gpu
def test_bench_replay_equals_its_eager_call(tmp_path):
    """``python -m hvs_tpu_torch.bench``'s serve program on conditioned
    flagship weights at 640² batch 2: the captured graph's replay equals an
    eager call exactly, on detections; kernel A at 18 launches per forward."""
    from hvs_tpu_torch import bench

    _need_card()
    det = bench.build_detector(0, _conditioned_flagship_checkpoint(str(tmp_path / "w.pt")),
                               "cuda")
    serve = bench.serve_fn(det)
    images = torch.rand((2, bench.IMAGE, bench.IMAGE, 3),
                        generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    a0 = mhc_mod.launches
    serve(images)
    torch.cuda.synchronize()
    assert mhc_mod.launches - a0 == 18
    graph = bench.CapturedServe(serve, images)
    assert graph.graph is not None and graph.replay_equals_eager()
    assert int((graph.eager_out[1] >= 0).sum()) > 0


@pytest.mark.gpu
def test_serve_bench_overload_sheds_on_the_card(tmp_path):
    """``python -m hvs_tpu_torch.serve_bench --mode overload`` on the card
    (the flagship at bucket 1, slower than the one thread that decodes and
    submits the JPEGs; a queue of 4): requests are shed, and every request
    accepted completes without an error."""
    from hvs_tpu_torch import serve_bench

    _need_card()
    report = serve_bench.main(["--seconds", "2", "--bucket", "1", "--mode", "overload",
                               "--rate", "5000", "--policy", "shed_oldest", "--queue-depth", "4",
                               "--output", str(tmp_path / "overload.json")])
    assert report["frames"] > 0 and report["shed_or_rejected"] > 0
    assert report["frames"] + report["shed_or_rejected"] == report["submitted"]


@pytest.mark.gpu
def test_accuracy_sweep_equals_evaluate_on_the_card(tmp_path):
    """``python -m hvs_tpu_torch.accuracy_sweep`` at one resolution against
    ``python -m hvs_tpu_torch.evaluate`` on the same conditioned flagship
    weights and 8 generated 320² images: the same accuracy numbers."""
    import json

    from hvs_tpu_torch import accuracy_sweep, evaluate, make_shapes_dataset

    _need_card()
    root = str(tmp_path / "shapes")
    make_shapes_dataset.main(["--root", root, "--train", "1", "--val", "8", "--size", "320",
                              "--num-classes", "80"])
    ckpt = _conditioned_flagship_checkpoint(str(tmp_path / "w.pt"))
    sweep = accuracy_sweep.main(["--checkpoint", ckpt, "--data-root", root, "--resolutions",
                                 "320", "--output", str(tmp_path / "sweep.json")])
    report = evaluate.main(["--data-root", root, "--split", "val", "--checkpoint", ckpt,
                            "--image-size", "320", "--output", str(tmp_path / "eval.json")])
    got = sweep["resolution_sweep"]["320"]
    assert {k: got[k] for k in report["accuracy"]} == {
        k: round(v, 4) for k, v in report["accuracy"].items()}
    assert got["fps_per_chip_batch16"] > 0
    with open(tmp_path / "sweep.json") as f:
        assert json.load(f) == sweep


@pytest.mark.gpu
def test_kernel_b_and_c_operators_launch_and_count_as_on_the_cpu():
    """B's and C's operators on the card: one launch each, the results their
    CPU versions give (B bitwise in its row sums' tolerance), and the same
    count of flops, transcendentals and bytes on both devices."""
    _need_card()
    from hvs_tpu_torch.utils.profiler import ModelProfiler

    x, args = _cuda_inputs(700, 64, seed=7)
    h_pre = args[0].clone()
    before = mhc_mod.launches_unfolded
    got = mhc_mod.mhc_block_unfolded(x, h_pre, *args)
    torch.cuda.synchronize()
    assert mhc_mod.launches_unfolded == before + 1
    cpu = [t.cpu() for t in (x, h_pre, *args)]
    want = mhc_mod.mhc_block_unfolded(*cpu)
    a, b = got.float().cpu().numpy().ravel(), want.float().numpy().ravel()
    assert np.corrcoef(a, b)[0, 1] > MIN_CORR
    counts = [ModelProfiler(mhc_mod.mhc_block_unfolded, *t).cost_analysis()
              for t in ((x, h_pre, *args), cpu)]
    assert counts[0] == counts[1] and counts[0]["flops"] == 10 * 700 * 64 * 64

    logits = torch.randn(5, 64, 64, device="cuda", requires_grad=True)
    f0, b0 = sink_mod.launches_forward, sink_mod.launches_backward

    def step(t):
        return torch.autograd.grad((sinkhorn_log(t, 20) ** 2).sum(), t)[0]

    g = step(logits)
    torch.cuda.synchronize()
    assert (sink_mod.launches_forward - f0, sink_mod.launches_backward - b0) == (1, 1)
    ref = logits.detach().cpu().requires_grad_(True)
    np.testing.assert_allclose(g.cpu().numpy(), step(ref).numpy(), rtol=1e-4, atol=1e-6)
    counts = [ModelProfiler(step, t).cost_analysis() for t in (logits, ref)]
    assert counts[0] == counts[1] and counts[0]["transcendentals"] == (42 + 40) * 5 * 64 * 64
