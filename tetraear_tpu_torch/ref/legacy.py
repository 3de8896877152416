"""Faithful re-derivation of the reference demod chain (for parity runs).

This is the chain actually shipped by the reference
(tetraear/signal/processor.py:221-273), re-derived step by step so the
new framework's sync/CRC rates can be compared against it on identical
IQ — the parity bound in BASELINE.md ("sync rate / CRC rate match the CPU
reference within its SNR bounds"):

  1. scipy.signal.decimate to ~240 kHz (processor.py:243-257)
  2. complex frequency shift (processor.py:85-100)
  3. 4th-order Butterworth low-pass +-12.5 kHz via filtfilt
     (processor.py:51-83)
  4. best-phase power-search symbol extraction at int(fs/18000)
     samples/symbol (processor.py:168-219)
  5. hard pi/4-DQPSK quantization with the reference's exact thresholds,
     including the wrap-region defect that maps +3pi/4 to symbol 3
     (processor.py:152-161)

Kept separate from ref/demod.py (the corrected oracle) so tests can
measure both chains on the same captures.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as ss

from tetraear_tpu_torch.ref.demod import dqpsk_demod

SYMBOL_RATE = 18_000


def legacy_process(samples: np.ndarray, sample_rate: float = 2.4e6,
                   freq_offset: float = 0.0) -> np.ndarray:
    """Reference pipeline: IQ -> hard 0-3 symbols (processor.py:221-273)."""
    samples = np.asarray(samples)
    current_rate = sample_rate
    target_rate = 240_000
    if current_rate > target_rate * 2:
        factor = int(current_rate / target_rate)
        if factor > 1:
            samples = ss.decimate(samples, factor)
            current_rate = current_rate / factor

    if freq_offset != 0:
        t = np.arange(len(samples)) / current_rate
        samples = samples * np.exp(-1j * 2 * np.pi * freq_offset * t)

    nyq = current_rate / 2
    cutoff = min(0.99, max(0.01, (25_000 / 2) / nyq))
    b, a = ss.butter(4, cutoff, btype="low")
    filtered = ss.filtfilt(b, a, samples)

    sps = int(current_rate / SYMBOL_RATE)
    if sps > 1:
        step = max(1, sps // 8)
        best_phase, max_power = 0, -1.0
        for phase in range(0, sps, step):
            n = (len(filtered) - phase) // sps
            if n <= 0:
                continue
            idx = phase + np.arange(n) * sps
            power = float(np.mean(np.abs(filtered[idx]) ** 2))
            if power > max_power:
                max_power, best_phase = power, phase
        n = (len(filtered) - best_phase) // sps
        symbols = filtered[best_phase + np.arange(n) * sps]
    else:
        symbols = filtered

    # normalization + legacy hard quantization (processor.py:124-161)
    m = np.abs(symbols).max()
    if m > 0:
        symbols = symbols / m
    hard, _, _ = dqpsk_demod(symbols.astype(np.complex64), None,
                             quantizer="legacy")
    # the reference consumes symbols[1:] (differential, first is reference)
    return hard


def chain_stats(symbols: np.ndarray) -> dict:
    """Sync/CRC statistics for a hard-symbol stream: the parity metrics."""
    from tetraear_tpu_torch.frame.decoder import TetraDecoder
    dec = TetraDecoder(auto_decrypt=False)
    frames = dec.decode(symbols)
    stats = dec.protocol_parser.get_statistics()
    return {
        "frames": len(frames),
        "crc_pass": stats["crc_pass"],
        "crc_rate": stats["crc_success_rate"] / 100.0,
        "sync_rate": len(frames),
    }
