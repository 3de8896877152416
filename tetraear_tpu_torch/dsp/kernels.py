"""Real <-> complex boundary helpers (tetraear_tpu/dsp/kernels.py).

The JAX package keeps every complex quantity at its public boundaries
as float32 with a trailing [re, im] axis, or as PLANAR (..., 2, N)
float32 for the wideband block.  The port keeps the same layouts so
states and outputs compare like with like.
"""

from __future__ import annotations

import numpy as np
import torch


def c2r_np(z: np.ndarray) -> np.ndarray:
    """complex (..., N) -> float32 (..., N, 2)."""
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


def c2p_np(z: np.ndarray) -> np.ndarray:
    """complex (..., N) -> float32 PLANAR (..., 2, N): the wideband block
    layout the fft2p front end reads as-is."""
    return np.stack([z.real, z.imag], axis=-2).astype(np.float32)


def r2c(a: torch.Tensor) -> torch.Tensor:
    """float32 (..., N, 2) -> complex64 (..., N)."""
    return torch.complex(a[..., 0], a[..., 1])


def c2r(z: torch.Tensor) -> torch.Tensor:
    """complex (..., N) -> float32 (..., N, 2)."""
    return torch.stack([z.real, z.imag], dim=-1)
