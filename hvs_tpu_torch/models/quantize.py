"""Offline int8 calibration of the serve model, and its scales.

Counterpart of ``hvs_tpu/models/quantize.py``: ``calibrate_quant_scales``
runs the float serve model over calibration batches, records max|x| at every
int8 site (whatever the model's ``act_quant`` flags: the calibration is a
superset of what any int8 variant reads), merges the batches by max (or by a
percentile below 100) and returns the scales. The port holds scales flat,
``{dotted site name: fp32 scalar}``; the names are the flax paths of the JAX
``quant`` collection (``convert.load_flax_quant`` carries a JAX tree across).
``load_quant_scales`` installs scales on a model's int8 sites, in place.

While it calibrates, every mHC layer runs its unfused bf16 chain (as the JAX
calibration does off the TPU) and every backbone block its standard tail.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping

import torch
from torch import nn

from ..ops.quant import build_quant_collection, merge_max_stats, merge_percentile_stats
from .layers import ManifoldHyperConnection, QuantSites, _set_buffer


def quant_site_names(model: nn.Module) -> List[str]:
    """Every int8 site the model records while calibrating, by dotted name."""
    return [f"{name}.{site}" if name else site
            for name, m in model.named_modules() if isinstance(m, QuantSites)
            for site in m.quant_sites]


def _set_recording(model: nn.Module, stats) -> None:
    for name, m in model.named_modules():
        if isinstance(m, QuantSites):
            m.quant_stats = stats
            m.quant_prefix = f"{name}." if name else ""


@torch.no_grad()
def calibrate_quant_scales(model: nn.Module, image_batches: Iterable[torch.Tensor],
                           task: str = "detection", margin: float = 1.0,
                           percentile: float = 100.0) -> Dict[str, torch.Tensor]:
    """Scales of every int8 site of ``model`` from calibration batches.

    ``model``: a float serve model (constraints computed at load and
    installed, as ``Detector`` or ``InferenceEngine`` leave them) with the
    weights that will serve; its int8 twin then serves with the result (as
    JAX calibrates a clone with the ``act_quant`` flags off).
    ``image_batches``: normalized NHWC images
    on the model's device, as the serve path feeds it. ``margin`` multiplies
    each calibrated range. Returns ``{site: fp32 scalar}`` on the CPU.
    """
    if any(isinstance(m, ManifoldHyperConnection) and not m.precomputed_constraints
           for m in model.modules()):
        raise ValueError("calibrate a serve model (precomputed_constraints=True, its "
                         "constraints installed); a training model records no mHC sites")
    if int8_sites_read(model):
        raise ValueError("calibrate the float twin of the serve model: this one reads int8 "
                         "scales (build it with quantization off)")
    was_training = model.training
    model.eval()
    stats = []
    try:
        for images in image_batches:
            record: Dict[str, torch.Tensor] = {}
            _set_recording(model, record)
            model(images, task=task)
            names = list(record)
            values = torch.stack([record[n] for n in names]).cpu()  # one pull per batch
            stats.append(dict(zip(names, values)))
    finally:
        _set_recording(model, None)
        model.train(was_training)
    if not stats:
        raise ValueError("calibration requires at least one image batch")
    merged = (merge_max_stats(stats) if percentile >= 100.0
              else merge_percentile_stats(stats, percentile))
    return build_quant_collection(merged, margin=margin)


@torch.no_grad()
def load_quant_scales(model: nn.Module, scales: Mapping[str, Any]) -> int:
    """Install ``scales`` on every int8 site the model reads, copying into
    existing buffers (a CUDA graph captured over the model then serves the
    new scales). A name that is not a site of the model, or a site the model
    reads without a scale, raises. Returns the number of scales installed."""
    unknown = sorted(set(scales) - set(quant_site_names(model)))
    if unknown:
        raise KeyError(f"scales for sites this model does not have: {unknown[:8]}")
    device = next(model.parameters()).device
    count = 0
    for name, m in model.named_modules():
        if not isinstance(m, QuantSites):
            continue
        for site in m.quant_reads:
            full = f"{name}.{site}" if name else site
            if full not in scales:
                raise KeyError(f"no calibrated scale for the int8 site {full}")
            value = torch.as_tensor(scales[full], dtype=torch.float32)
            if value.numel() != 1:
                raise ValueError(f"{full}: a scale is a scalar, got shape {tuple(value.shape)}")
            _set_buffer(m, site, value.reshape(()).to(device))
            count += 1
    return count


def int8_sites_read(model: nn.Module) -> List[str]:
    """The sites whose scale the model reads (its int8 flags), by name."""
    return [f"{name}.{site}" if name else site
            for name, m in model.named_modules() if isinstance(m, QuantSites)
            for site in m.quant_reads]
