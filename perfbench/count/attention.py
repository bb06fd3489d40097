"""The relative-position attention kernel's work at each attention site of
one forward of a plain-ViT configuration (``vitdet_b``), and its least time
there (its bound), from the configuration's keys.

A site is one block's attention: windows of ``window_size``² tokens (the
grid zero-padded to a multiple of the window) or the whole grid. Only real
queries are counted, the keys each sees are all of its window's (padding
included) or the grid's, so a kernel that skips the padded queries can
never read above its bound:

- flops: 4 · 64 · heads · real queries · keys each sees (q k^T and p v);
- exponentials: heads · real queries · keys each sees;
- bytes: bf16 q and out of the real tokens, bf16 k and v of every key
  (window padding included), fp32 rel_h and rel_w of the real queries.

The least time is the largest of flops over the bf16 peak, exponentials
over 16 a clock on each of 132 SMs at 1.98 GHz, and bytes over the HBM
peak."""

from __future__ import annotations

import math
from typing import List, NamedTuple

from perfbench.count.bounds import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

KERNEL_NAME = "relpos_attention_kernel"
HEAD_DIM = 64
PEAK_EXP_PER_S = 16 * 132 * 1.98e9


class Site(NamedTuple):
    windowed: bool
    side: int      # the window's side, or the grid's
    windows: int   # windows per frame (1 for a global site)
    real: int      # real query tokens per frame
    heads: int


def sites(cfg, size: int) -> List[Site]:
    """Every attention site of one frame's forward at ``size``², in block
    order."""
    grid = size // cfg["patch_size"]
    heads = cfg["num_heads"]
    out = []
    for i in range(cfg["depth"]):
        if i in cfg["window_block_indexes"]:
            w = cfg["window_size"]
            out.append(Site(True, w, math.ceil(grid / w) ** 2, grid * grid, heads))
        else:
            out.append(Site(False, grid, 1, grid * grid, heads))
    return out


def flops(site: Site, batch: int) -> int:
    return 4 * HEAD_DIM * site.heads * site.real * site.side ** 2 * batch


def exponentials(site: Site, batch: int) -> int:
    return site.heads * site.real * site.side ** 2 * batch


def bytes_moved(site: Site, batch: int) -> int:
    row = site.heads * HEAD_DIM
    keys = site.windows * site.side ** 2
    return batch * (2 * 2 * site.real * row + 2 * 2 * keys * row
                    + 4 * site.real * site.heads * 2 * site.side)


def bound_s(site: Site, batch: int) -> float:
    """The kernel's least time at ``site`` for ``batch`` frames."""
    return max(flops(site, batch) / PEAK_BF16_FLOPS,
               exponentials(site, batch) / PEAK_EXP_PER_S,
               bytes_moved(site, batch) / PEAK_HBM_BYTES)
