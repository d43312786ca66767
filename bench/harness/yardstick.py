"""The yardstick of the kernels' roofline shares, frozen.

Copied from ``chip_smoke.py`` (``PEAK_*``, ``bound()``, ``b2_bound()`` and
phase_b1's byte and operation count of an ``imc_eval`` call), so that a
later change to that script cannot move the benchmark's numbers.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM, dense peaks at 700 W (data sheet): HBM3 bytes/s,
# float32 operations/s outside the tensor cores, bf16 tensor-core
# operations/s (chip_smoke.py: PEAK_BYTES_S, PEAK_FP32_S, PEAK_BF16_S)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12


def bound(bytes_moved: float, ops: float, peak_ops_s: float = PEAK_FP32_S):
    """The least time (ms) the chip could take, and what bounds it
    (chip_smoke.py: bound)."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b1_bound(B: int, P: int, W: int, L: int, layers: float):
    """Bytes and operations of one ``imc_eval`` launch over designs (B, P,
    9), feats (B, W, L, 6), mask (B, W, L) with ``layers`` unmasked layers
    in all, and its three (B, W, P) sums (chip_smoke.py: phase_b1)."""
    n_bytes = B * P * 9 * 4 + B * W * L * 6 * 4 + B * W * L + 3 * B * W * P * 4
    ops = 40.0 * P * float(layers)
    return n_bytes, ops


def b2_bound(B, P, W, tot, R, C, Bc, Gn):
    """Bytes each input read once and each output written once, and
    operations counted from the kernel source per generation; survival as
    the function needs it, a comparison sort of the 2P candidates
    (2P log2(2P) comparisons of 3 operations), whatever method the kernel
    uses (chip_smoke.py: b2_bound)."""
    n = 9
    n_pairs = (P + 1) // 2
    sort_ops = 2 * P * max(1, math.ceil(math.log2(2 * P))) * 3
    tab = W * (R * C * Bc + C * Bc + Gn + 4)
    n_bytes = 4 * B * (P * n + P + tot + tab + 2) + 4 * B * (2 * P * n + 2 * P)
    ops = B * (n_pairs * n * 16 + P * n * 20 + P * (n + 30 + 30 * W) + sort_ops)
    return n_bytes, ops
