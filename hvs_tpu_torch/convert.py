"""Carries flax weights across: a flax ``params`` tree onto the port's modules.

The port's modules carry the flax module and parameter names (including the
flax auto-names ``GroupNorm_N``, ``Dense_N``, ``LayerNorm_0``, and
``stage{i}_block{j}``), so a flax leaf at path ``a/b/kernel`` is the
parameter ``a.b.kernel``. One layout differs: convolution kernels are HWIO in
flax and OIHW here. Transposed-convolution kernels (flax auto-name
``ConvTranspose_N``) stay HWIO, as do Dense kernels ([in, out], applied as
``x @ W``).

A retrieval model's knowledge base is a constant in both packages (a
non-persistent buffer here, rebuilt from the class names), so it is in no
tree; its gate ``rag_gate`` is a scalar parameter like any other.

The tree is given as nested dicts of numpy arrays; a caller holding JAX
arrays converts them first (``jax.device_get``). This module imports no JAX.

The int8 scales (the JAX ``quant`` collection) cross the same way:
``load_flax_quant`` turns a ``quant`` tree into the port's scales,
``{dotted site name: fp32 scalar}``, and ``export_flax_quant`` turns them back.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

Tree = Dict[str, Any]

HWIO_TO_OIHW = (3, 2, 0, 1)
OIHW_TO_HWIO = (2, 3, 1, 0)


def flatten(tree: Tree, prefix: Tuple[str, ...] = ()) -> Dict[str, np.ndarray]:
    """Leaves of a nested dict by dotted path."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[".".join(path)] = np.asarray(value)
    return out


def nest(flat: Dict[str, Any]) -> Tree:
    """Nested dicts from leaves keyed by dotted path (the inverse of ``flatten``)."""
    tree: Tree = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _is_conv_kernel(name: str, ndim: int) -> bool:
    *owner, leaf = name.split(".")
    return (leaf == "kernel" and ndim == 4
            and not (owner and owner[-1].startswith("ConvTranspose")))


def to_port_layout(name: str, array: np.ndarray) -> np.ndarray:
    """A flax leaf in the port's layout (conv kernels HWIO -> OIHW)."""
    return array.transpose(HWIO_TO_OIHW) if _is_conv_kernel(name, array.ndim) else array


def to_flax_layout(name: str, array: np.ndarray) -> np.ndarray:
    """A port parameter in flax's layout (conv kernels OIHW -> HWIO)."""
    return array.transpose(OIHW_TO_HWIO) if _is_conv_kernel(name, array.ndim) else array


def load_flax_params(model: nn.Module, params: Tree) -> None:
    """Copy a flax ``params`` tree into ``model`` in place.

    Every flax leaf must match one parameter of the model by path and shape,
    and every parameter must be covered; anything else raises.
    """
    flat = flatten(params)
    named = dict(model.named_parameters())
    missing = sorted(set(named) - set(flat))
    extra = sorted(set(flat) - set(named))
    if missing or extra:
        raise KeyError(f"flax tree does not match the model: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    with torch.no_grad():
        for name, p in named.items():
            value = to_port_layout(name, flat[name])
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: flax shape {flat[name].shape} does not map onto "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


def export_flax_params(model: nn.Module) -> Tree:
    """The model's parameters as a flax-layout tree of numpy arrays."""
    return nest({name: to_flax_layout(name, p.detach().cpu().numpy())
                 for name, p in model.named_parameters()})


def load_flax_quant(model: nn.Module, quant: Tree) -> Dict[str, torch.Tensor]:
    """A flax ``quant`` tree (calibrated scales) as the port's scales for
    ``model``. Every leaf must be a scalar at the path of an int8 site of the
    model (``models.quantize.quant_site_names``); anything else raises."""
    from .models.quantize import quant_site_names

    flat = flatten(quant)
    unknown = sorted(set(flat) - set(quant_site_names(model)))
    if unknown:
        raise KeyError(f"quant tree does not match the model's int8 sites: {unknown[:8]}")
    out = {}
    for name, value in flat.items():
        if value.size != 1:
            raise ValueError(f"{name}: a scale is a scalar, got shape {value.shape}")
        out[name] = torch.tensor(float(value.reshape(())), dtype=torch.float32)
    return out


def export_flax_quant(scales: Dict[str, Any]) -> Tree:
    """The port's scales as a flax ``quant`` tree of fp32 numpy scalars."""
    return nest({name: np.asarray(float(v), np.float32) for name, v in scales.items()})
