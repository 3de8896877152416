"""Wideband FM demodulation for raw-audio monitoring.

Equivalent of the reference's optional raw-FM recording path
(tetraear/ui/modern.py:2040-2061, 2258-2300): demodulate the raw channel
as FM and resample to 48 kHz so an operator can listen to the channel
"as radio" while the digital decode runs.
"""

from __future__ import annotations

import numpy as np

from tetraear_tpu_torch.dsp import design
from tetraear_tpu_torch.ref import polyphase

AUDIO_RATE = 48_000.0


def fm_demod(iq: np.ndarray, prev: complex = 1.0 + 0j) -> tuple:
    """Quadrature FM discriminator: phase difference per sample.

    Returns (audio at the input rate, last sample for streaming)."""
    iq = np.asarray(iq, np.complex64)
    if len(iq) == 0:
        return np.zeros(0, np.float32), prev
    seq = np.concatenate([[np.complex64(prev)], iq])
    d = seq[1:] * np.conj(seq[:-1])
    audio = np.arctan2(d.imag, d.real).astype(np.float32) / np.pi
    return audio, complex(iq[-1])


def fm_to_audio(iq: np.ndarray, fs: float,
                audio_rate: float = AUDIO_RATE) -> np.ndarray:
    """IQ -> FM audio at audio_rate (one-shot convenience)."""
    audio, _ = fm_demod(iq)
    from fractions import Fraction
    frac = Fraction(int(round(audio_rate)), int(round(fs)))
    L, M = frac.numerator, frac.denominator
    h = design.kaiser_lowpass(min(15_000.0, audio_rate * 0.4),
                              audio_rate * 0.1, fs * L, atten_db=50.0)
    st = design.ResampleStage(up=L, down=M,
                              taps=tuple((h * L).astype(np.float32)))
    n = len(audio) - len(audio) % M
    hist = np.zeros(polyphase.stage_history_len(st), np.complex64)
    y, _ = polyphase.stage_apply(st, audio[:n].astype(np.complex64), hist)
    return y.real.astype(np.float32)
