"""Batched training-sequence sync correlation + CRC in plain torch
(tetraear_tpu/dsp/sync.py).

The same correlation the host decoder runs per position, as one conv
over (C, N) bit planes, and burst CRC checking as a GF(2) matrix
multiply (integer matmul mod 2).

Host-side peak selection (threshold cascade, skip-ahead dedup) stays in
frame.decoder: it is O(hits), data-dependent, and tiny.
"""

from __future__ import annotations

import numpy as np
import torch

from tetraear_tpu_torch.frame import burst as burst_mod
from tetraear_tpu_torch.frame import crc as crc_mod

SYNC_LEN = 22

_PATTERNS = np.stack([burst_mod.SYNC_CONTINUOUS_DOWNLINK,
                      burst_mod.SYNC_DISCONTINUOUS_DOWNLINK]).astype(
                          np.float32)


def sync_correlate(bits: torch.Tensor) -> torch.Tensor:
    """(C, N) bits in {0,1} -> (C, N-21) best TS1/TS2 agreement ratio.

    agreement = (corr_pm + 22) / 44 where corr_pm is the +-1 correlation:
    one conv with 2 output channels, then a max.
    """
    x = bits.to(torch.float32) * 2.0 - 1.0            # {0,1} -> {-1,+1}
    pat = torch.from_numpy(_PATTERNS).to(bits.device) * 2.0 - 1.0
    out = torch.nn.functional.conv1d(x[:, None, :], pat[:, None, :])
    best = torch.amax(out, dim=1)
    return (best + SYNC_LEN) / (2.0 * SYNC_LEN)


def crc16_batch_device(bits: torch.Tensor) -> torch.Tensor:
    """(B, L) bit rows -> (B, 16) CRC-16-CCITT bits, as a matmul.

    Same GF(2)-affine formulation as frame.crc.crc16_matrix.  The
    products are sums of at most L ones, exact in float32.
    """
    m, c0 = crc_mod.crc16_matrix(int(bits.shape[1]))
    mt = torch.from_numpy(np.ascontiguousarray(m.T, np.float32)).to(
        bits.device)
    prod = torch.matmul(bits.to(torch.float32), mt).to(torch.int32)
    c0_t = torch.from_numpy(np.asarray(c0, np.uint8)).to(bits.device)
    return (prod & 1).to(torch.uint8) ^ c0_t[None, :]


def crc_error_counts(data_bits: torch.Tensor) -> torch.Tensor:
    """(B, 216) burst data views -> (B,) min CRC bit-error count.

    Device formulation of the soft CRC gate: compares the computed CRC
    of the payload (and of the reversed payload) against the received
    tail and returns the smaller Hamming distance.  Callers apply the
    <=2 budget.
    """
    payload = data_bits[:, :-16]
    received = data_bits[:, -16:].to(torch.uint8)
    fwd = crc16_batch_device(payload)
    rev = crc16_batch_device(torch.flip(payload, dims=(1,)))
    e_fwd = (fwd ^ received).sum(dim=1)
    e_rev = (rev ^ received).sum(dim=1)
    errs = torch.minimum(e_fwd, e_rev).to(torch.int32)
    # degenerate all-0/all-1 rows never pass
    ones = data_bits.sum(dim=1)
    degenerate = (ones == 0) | (ones == data_bits.shape[1])
    return torch.where(degenerate, 99, errs).to(torch.int32)
