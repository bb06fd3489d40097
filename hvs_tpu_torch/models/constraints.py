"""The mHC constrained matrices, computed once at model load.

Counterpart of ``hvs_tpu/models/constraints.py``. For every subtree of a
parameter tree that holds ``H_pre_raw``/``H_post_raw``/``H_res_raw``,
``compute_constraints`` emits ``h_pre``, ``h_post``, ``h_res`` (and
``w1_folded`` = h_pre @ mlp_in_kernel) at the same path, in fp32.
``param_tree`` gives a model's parameters as such a tree (paths are the
flax paths), and ``load_constraints`` installs a constraints tree on the
model's mHC layers (and, for an int8 model, prepares the int8 weights, which
also depend on the weights alone).
"""

from __future__ import annotations

import torch
from torch import nn

from ..convert import Tree, nest
from ..ops.sinkhorn import sinkhorn_log
from .layers import ManifoldHyperConnection, QuantConv, QuantDense


def param_tree(model: nn.Module) -> Tree:
    """The model's parameters as nested dicts keyed by module path."""
    return nest(dict(model.named_parameters()))


@torch.no_grad()
def compute_constraints(params: Tree, sk_iters: int = 20) -> Tree:
    """The ``constraints`` tree matching a parameter tree (fp32 tensors)."""

    def walk(node: Tree) -> Tree:
        out: Tree = {}
        for key, value in node.items():
            if isinstance(value, dict):
                sub = walk(value)
                if sub:
                    out[key] = sub
        if "H_res_raw" in node:
            h_pre = torch.sigmoid(node["H_pre_raw"].float())
            out["h_pre"] = h_pre
            out["h_post"] = 2.0 * torch.sigmoid(node["H_post_raw"].float())
            out["h_res"] = sinkhorn_log(node["H_res_raw"].float(), n_iters=sk_iters)
            if "mlp_in_kernel" in node:
                out["w1_folded"] = h_pre @ node["mlp_in_kernel"].float()
        return out

    return walk(params)


def load_constraints(model: nn.Module, constraints: Tree) -> int:
    """Install ``constraints`` on every mHC layer of ``model`` (an int8 layer
    also quantizes its chain's matrices) and prepare the int8 weights of
    every ``QuantConv`` and ``QuantDense``, in place; returns the number of
    mHC layers set. Raises if a layer has no entry."""
    count = 0
    for name, module in model.named_modules():
        if isinstance(module, (QuantConv, QuantDense)):
            module.refresh_quant()
        elif isinstance(module, ManifoldHyperConnection):
            node = constraints
            for key in name.split(".") if name else ():
                node = node[key]
            module.set_constraints(node)
            count += 1
    return count
