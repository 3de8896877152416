"""The least time a block step could take on one H100.

Counted from the configuration's own sizes, whatever kernels implement
the step: the block's IQ read once (complex64) and its decisions written
once (2 bits a symbol and carrier, and one 32-bit count a carrier), at
the memory rate; or the channelizer's forward transform of the block
and one inverse transform a carrier of the block's symbols at two
samples a symbol (5 n log2 n operations a complex transform of n
points), at the float32 rate.  The larger of the two is the bound.
"""

from __future__ import annotations

import math

# one NVIDIA H100 SXM (data sheet; at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SYMBOL_RATE = 18_000.0


def fft_ops(n: int) -> float:
    return 5.0 * n * math.log2(n) if n > 1 else 0.0


def step_work(fs: float, n_carriers: int, block_len: int) -> tuple:
    """(bytes, operations) the block step of one block needs."""
    syms = block_len / fs * SYMBOL_RATE
    nbytes = 8.0 * block_len + n_carriers * (syms / 4.0 + 4.0)
    ops = fft_ops(block_len) + n_carriers * fft_ops(int(round(2 * syms)))
    return nbytes, ops


def least_step_s(fs: float, n_carriers: int, block_len: int) -> tuple:
    """(least seconds, "memory" or "compute") of one block step."""
    nbytes, ops = step_work(fs, n_carriers, block_len)
    tm, tc = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (tm, "memory") if tm >= tc else (tc, "compute")
