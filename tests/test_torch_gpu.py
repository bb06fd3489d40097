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

# The kernel and its plain version round at the same points but sum in
# different orders; LN2 can amplify a flipped rounding (tests/test_pallas.py).
MIN_CORR, MAX_MEAN_ABS = 0.999, 0.05


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


def _sinkhorn_logits(shape, seed, scale=1.0):
    """Logits at the mHC init scale plus ``scale`` standard normal noise."""
    r = np.random.default_rng(seed)
    n = shape[-1]
    limit = math.sqrt(3.0 * 0.1 / n)
    x = r.uniform(-limit, limit, shape) + scale * r.standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 32, 64, 77, 128, 256, 512])
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
