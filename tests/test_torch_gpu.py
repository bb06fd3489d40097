"""Tests of the port's CUDA kernels; they need a card and skip without one.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import math

import numpy as np
import pytest
import torch

from hvs_tpu_torch.ops import mhc_block as mhc_mod
from hvs_tpu_torch.ops.sinkhorn import sinkhorn_log

# The kernel and its plain version round at the same points but sum in
# different orders; LN2 can amplify a flipped rounding (tests/test_pallas.py).
MIN_CORR, MAX_MEAN_ABS = 0.999, 0.05


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
