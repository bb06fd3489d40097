"""How the mHC block's residual sum and its GELU move its output, on the CPU.

For the serve block's plain chain (``hvs_tpu_torch/ops/mhc_block.py``) at
each width, on two kinds of ill-conditioned inputs (x = 3 ± 0.3, H_res the
Sinkhorn projection of 0.1·noise, so near uniform):

  * ``h_post_near_1``: H_post = 2·sigmoid(0.01·noise), near 1 everywhere (an
    mHC layer at its init scale);
  * ``h_post_small``: H_post = 0.05·N(0, 1/d), so that y @ H_post carries
    the row's spread and only the residual sum is ill-conditioned (the
    inputs of ``chip_smoke.py``'s ``kernel_ill_conditioned`` rows);

prints the correlation of the chain with itself when only the GELU's tanh
is perturbed by a relative 2^-12 (about what the hardware tanh,
``tanh.approx.f32``, differs by), and of the chain against the same chain with the sum rounded
to bf16 before LN2. A kernel-vs-plain check separates a rounded sum from a
sound kernel only where the first stays near 1 and the second does not.

With ``--sites``, the same two readings on trained weights instead: the
sites that ``scripts/torch_trained_checks.py --dump`` saved (each site's
input and operands and the card's kernel and plain outputs), beside the
card's kernel-vs-plain correlation.

    python scripts/torch_mhc_sum_conditioning.py [--rows 4096]
    python scripts/torch_mhc_sum_conditioning.py --sites sites.pt
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from hvs_tpu_torch.ops.mhc_block import SUPPORTED_WIDTHS, _mm, layernorm
from hvs_tpu_torch.ops.sinkhorn import sinkhorn_log

BF = torch.bfloat16
TANH_REL = 2.0 ** -12


def gelu_exact(v: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")


def gelu_perturbed(v: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """The tanh form with tanh times (1 + u·2^-12), u uniform in [-1, 1],
    in fp32, rounded to ``v``'s dtype once."""
    v32 = v.float()
    t = torch.tanh(0.7978845608028654 * (v32 + 0.044715 * v32 ** 3))
    t = t * (1.0 + TANH_REL * (2.0 * torch.rand(v.shape, generator=g) - 1.0))
    return (v32 * (0.5 * (1.0 + t))).to(v.dtype)


def chain(x, w1, b1, w2, b2, h_post, h_res, ln, gelu, g, round_sum=False, h_pre=None):
    """The plain serve chain (``ops/mhc_block.py::mhc_block_plain``; the
    unfolded one with ``h_pre``) with the GELU given and the sum optionally
    rounded to bf16."""
    y = layernorm(x, ln[0], ln[1]).to(BF)
    if h_pre is not None:
        y = _mm(y, h_pre)
    y = gelu(_mm(y, w1) + b1.to(BF), g)
    y = gelu(_mm(y, w2) + b2.to(BF), g)
    y, res = _mm(y, h_post), _mm(x, h_res)
    s = res + y if round_sum else res.float() + y.float()
    return layernorm(s, ln[2], ln[3]).to(BF)


def inputs(n: int, d: int, h_post_kind: str, seed: int):
    r = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    x = t(3.0 + 0.3 * r.standard_normal((n, d))).to(BF)
    w1 = t(r.standard_normal((d, d)) / math.sqrt(d)).to(BF)
    w2 = t(r.standard_normal((d, d)) / math.sqrt(d)).to(BF)
    h_res = sinkhorn_log(t(0.1 * r.standard_normal((d, d))), 20).to(BF)
    if h_post_kind == "h_post_near_1":
        h_post = t(2.0 / (1.0 + np.exp(-0.01 * r.standard_normal((d, d))))).to(BF)
    else:
        h_post = t(0.05 * r.standard_normal((d, d)) / math.sqrt(d)).to(BF)
    b1, b2 = t(0.01 * r.standard_normal(d)), t(0.01 * r.standard_normal(d))
    ln = [t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d)),
          t(1 + 0.1 * r.standard_normal(d)), t(0.1 * r.standard_normal(d))]
    return x, (w1, b1, w2, b2, h_post, h_res, ln)


def corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(np.corrcoef(a.float().flatten().numpy(), b.float().flatten().numpy())[0, 1])


def trained_sites(path: str) -> None:
    for (kernel, site), d in torch.load(path, map_location="cpu").items():
        w1, b1, w2, b2, h_post, h_res, *ln = d["args"]
        ops = (w1, b1, w2, b2, h_post, h_res, ln)
        g = torch.Generator().manual_seed(0)
        exact = chain(d["x"], *ops, gelu_exact, g, h_pre=d["h_pre"])
        print(json.dumps({
            "kernel": kernel, "site": site, "rows": d["x"].shape[0], "d": d["x"].shape[1],
            "card_kernel_vs_plain_corr": corr(d["kernel_out"], d["plain_out"]),
            "plain_here_vs_card_plain_corr": corr(exact, d["plain_out"]),
            "corr_tanh_perturbed": corr(exact, chain(d["x"], *ops, gelu_perturbed, g,
                                                     h_pre=d["h_pre"])),
            "corr_sum_rounded": corr(exact, chain(d["x"], *ops, gelu_exact, g, round_sum=True,
                                                  h_pre=d["h_pre"])),
        }), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rows", type=int, default=4096)
    p.add_argument("--sites", default=None, help="a --dump of torch_trained_checks.py")
    args = p.parse_args()
    torch.set_num_threads(4)
    if args.sites:
        trained_sites(args.sites)
        return
    for kind in ("h_post_near_1", "h_post_small"):
        for d in SUPPORTED_WIDTHS:
            x, ops = inputs(args.rows, d, kind, seed=d)
            g = torch.Generator().manual_seed(0)
            exact = chain(x, *ops, gelu_exact, g)
            print(json.dumps({
                "inputs": kind, "d": d, "rows": args.rows,
                "corr_tanh_perturbed": corr(exact, chain(x, *ops, gelu_perturbed, g)),
                "corr_sum_rounded": corr(exact, chain(x, *ops, gelu_exact, g, round_sum=True)),
            }), flush=True)


if __name__ == "__main__":
    main()
