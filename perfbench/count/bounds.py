"""The card's published peaks and the kernels' least times (their bounds),
as the port's kernel table states them (PERF.md, "Kernel table")."""

from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Kernel A (the fused serve mHC block) serves these widths, at sites whose
# matrices are all [d, d].
KERNEL_A_WIDTHS = (32, 64, 128, 256, 512)
KERNEL_A_NAME = "mhc_block_kernel"


def kernel_a_bound_s(rows: int, d: int) -> float:
    """Kernel A at one site: max(8 N d² flops / peak, (4 N d + 8 d² + 24 d)
    bytes / HBM peak): bf16 rows in and out, four bf16 [d, d] matrices, six
    fp32 vectors."""
    return max(8.0 * rows * d * d / PEAK_BF16_FLOPS,
               (4.0 * rows * d + 8.0 * d * d + 24.0 * d) / PEAK_HBM_BYTES)


def kernel_a_sites(sites: Iterable[Tuple[int, int, int, int]]):
    """The mHC sites kernel A serves: (rows, d) of those at one width with a
    width it takes."""
    return [(n, d) for n, d, hidden, mlp in sites
            if hidden == d and mlp == d and d in KERNEL_A_WIDTHS]
