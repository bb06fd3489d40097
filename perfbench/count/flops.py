"""The benchmark's own operation count of a served frame: the plain
reference's forward under ``torch.utils.flop_counter.FlopCounterMode`` on
the meta device. Product flops, 2 per multiply-add of every matmul and
convolution, a SAME convolution's padded taps included; each mHC layer
counts its four products (the first folded, as a served model holds it)."""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

META = torch.device("meta")


def _meta_model(cfg, ref):
    weights = {n: torch.empty(s, device=META) for n, s, _, _ in ref.param_spec(cfg)}
    return ref.Model(cfg, ref.prepare(weights, 1))


def frame_flops(cfg, ref, size: int) -> int:
    """Flops of one frame's forward at ``size``² (the head's logits), by
    the reference ``ref``."""
    model = _meta_model(cfg, ref)
    x = torch.empty(1, size, size, 3, device=META)
    with FlopCounterMode(display=False) as counter:
        model.raw(x)
    return int(counter.get_total_flops())


def mhc_sites(cfg, ref, size: int) -> List[Tuple[int, int, int, int]]:
    """Every mHC layer of one frame's forward: (rows, d, hidden, mlp)."""
    model = _meta_model(cfg, ref)
    model.sites = []
    model.raw(torch.empty(1, size, size, 3, device=META))
    return model.sites



