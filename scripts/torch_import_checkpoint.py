#!/usr/bin/env python
"""Convert a checkpoint of the JAX package into the port's checkpoint format.

Reads what ``hvs_tpu/inference/engine.py::load_checkpoint`` reads:

  * an orbax directory (as ``hvs_tpu/training/trainer.py::save_checkpoint``
    writes it): its ``params`` and, when present, its ``ema_params``;
  * a flax msgpack file: its ``params`` (the JAX engine serves a msgpack
    file's params whatever ``use_ema`` says, so its EMA is not carried).

and writes ``{"params": {name: tensor}, "ema_params": {name: tensor}}`` with
``torch.save``, in the port's parameter names and layouts, which
``InferenceEngine.load_checkpoint`` (with ``use_ema`` picking the EMA weights
as the JAX engine does), ``python -m hvs_tpu_torch.evaluate``, ``quantize``,
``export_model`` and ``infer`` read. Every tree goes through
``convert.load_flax_params`` into the port's model of the given
configuration, so a tree that does not match it raises. The optimizer state
is not carried over: the JAX package has no cross-framework resume.

Needs JAX, flax and orbax (the host that wrote the checkpoint); the port
itself imports none of them::

    python scripts/torch_import_checkpoint.py checkpoints/best out/best.pt
    python scripts/torch_import_checkpoint.py model.msgpack out/model.pt --tiny
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Convert a JAX checkpoint for the PyTorch port")
    p.add_argument("checkpoint", help="orbax checkpoint directory or flax msgpack file")
    p.add_argument("output", help="the port's checkpoint file to write (.pt)")
    p.add_argument("--config", default=None, help="model YAML of the checkpoint's model")
    p.add_argument("--tiny", action="store_true", help="the tiny model of the smoke runs")
    return p.parse_args(argv)


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """``{"params": tree[, "ema_params": tree]}`` as numpy arrays, from an
    orbax directory or a flax msgpack file."""
    import jax
    import numpy as np

    if os.path.isdir(path):
        import orbax.checkpoint as ocp

        with ocp.PyTreeCheckpointer() as ckptr:
            restored = ckptr.restore(os.path.abspath(path))
        trees = {"params": restored.get("params", restored)}
        if isinstance(restored, dict) and restored.get("ema_params") is not None:
            trees["ema_params"] = restored["ema_params"]
    else:
        from flax import serialization

        with open(path, "rb") as f:
            restored = serialization.msgpack_restore(f.read())
        trees = {"params": restored.get("params", restored)}
    return jax.tree_util.tree_map(np.asarray, jax.device_get(trees))


def model_config(args: argparse.Namespace):
    from hvs_tpu_torch.config import InferenceConfig, ModelConfig, from_dict
    from hvs_tpu_torch.config.base import _read
    from hvs_tpu_torch.export_model import tiny_configs

    data = _read(args.config) if args.config else {}
    mcfg = from_dict(ModelConfig, {**data, "device": "cpu"})
    if args.tiny:
        tiny_configs(mcfg, InferenceConfig(device="cpu"), 64)
    mcfg.precision = "fp32"
    return mcfg


def convert(trees: Dict[str, Any], mcfg) -> Dict[str, Dict[str, Any]]:
    """Each tree in the port's names and layouts, through
    ``convert.load_flax_params`` into the serve model of ``mcfg``."""
    from hvs_tpu_torch.convert import load_flax_params

    model = mcfg.build_model(production=True)
    out = {}
    for key, tree in trees.items():
        load_flax_params(model, tree)
        out[key] = {name: p.detach().clone() for name, p in model.named_parameters()}
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, Any]]:
    import torch

    args = parse_args(argv)
    ckpt = convert(read_jax_checkpoint(args.checkpoint), model_config(args))
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.save(ckpt, args.output)
    print(f"wrote {args.output}: {sorted(ckpt)} "
          f"({len(ckpt['params'])} parameters each)")
    return ckpt


if __name__ == "__main__":
    main()
