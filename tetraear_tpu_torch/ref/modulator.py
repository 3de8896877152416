"""TETRA pi/4-DQPSK modulator — golden signal source for tests and benches.

The reference repo has no transmitter; its tests use ad-hoc noise fixtures
(reference: tests/conftest.py:53-67).  The new framework needs golden
IQ <-> bits vectors, so we build the proper ETSI EN 300 392-2 modulator:

  bits -> dibits -> phase increments {+-pi/4, +-3pi/4} -> RRC pulse shaping
  -> rational upsampling to the capture rate -> carrier offset -> AWGN.

Symbol/bit mapping matches the reference demodulator
(tetraear/signal/processor.py:143-161):
  symbol 0 (bits 00) -> +pi/4      symbol 1 (bits 01) -> +3pi/4
  symbol 2 (bits 10) -> -pi/4      symbol 3 (bits 11) -> -3pi/4
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from tetraear_tpu_torch.dsp import design
from tetraear_tpu_torch.ref import polyphase

_PHASE_INC = np.array([np.pi / 4, 3 * np.pi / 4, -np.pi / 4, -3 * np.pi / 4],
                      dtype=np.float64)

# TETRA normal continuous downlink burst layout in bits (510 bits/slot), as
# modelled by the reference decoder (tetraear/core/decoder.py:863-877,
# tetraear/core/protocol.py:277-290): block1 bits 0..107, training sequence
# at bits 216..237 within the slot (TS starts at bit 216 = symbol 108).
TS1_BITS = np.array([1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0,
                     1, 0, 0], dtype=np.uint8)
TS2_BITS = np.array([0, 1, 1, 1, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 1,
                     1, 0, 0], dtype=np.uint8)
SLOT_BITS = 510
TS_OFFSET_BITS = 216            # training sequence position inside the slot


def bits_to_symbols(bits: np.ndarray) -> np.ndarray:
    """Pack a bit vector (even length) into 0-3 dibit symbols, MSB first."""
    bits = np.asarray(bits, dtype=np.uint8).reshape(-1, 2)
    return (bits[:, 0] << 1) | bits[:, 1]


def symbols_to_baseband(symbols: np.ndarray, sps: int = design.SPS,
                        span: int = 10, phase0: float = 0.0) -> np.ndarray:
    """Differentially encode + RRC shape. Output rate = sps * 18 kHz.

    Returns complex64 baseband with one leading reference symbol (carrying
    ``phase0``) so that the differential demodulator recovers all N symbols.
    """
    inc = _PHASE_INC[np.asarray(symbols, dtype=np.int64)]
    phases = phase0 + np.concatenate([[0.0], np.cumsum(inc)])
    points = np.exp(1j * phases).astype(np.complex64)

    up = np.zeros(len(points) * sps, dtype=np.complex64)
    up[::sps] = points
    h = design.rrc_taps(sps=sps, span_symbols=span).astype(np.float32)
    bb = np.convolve(up, h, mode="full")[: len(up)]
    return bb.astype(np.complex64)


def make_slot_bits(payload_bits: np.ndarray, training: np.ndarray = TS1_BITS,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Assemble one 510-bit TETRA slot with the training sequence at bit 216.

    payload fills the remaining positions (padded with random bits if short).
    """
    rng = rng or np.random.default_rng(0)
    slot = rng.integers(0, 2, SLOT_BITS).astype(np.uint8)
    payload_bits = np.asarray(payload_bits, dtype=np.uint8)
    n_head = min(TS_OFFSET_BITS, len(payload_bits))
    slot[:n_head] = payload_bits[:n_head]
    slot[TS_OFFSET_BITS:TS_OFFSET_BITS + len(training)] = training
    tail_src = payload_bits[n_head:]
    tail_dst_start = TS_OFFSET_BITS + len(training)
    n_tail = min(SLOT_BITS - tail_dst_start, len(tail_src))
    slot[tail_dst_start:tail_dst_start + n_tail] = tail_src[:n_tail]
    return slot


def upconvert(baseband: np.ndarray, fs_in: float, fs_out: float,
              freq_offset_hz: float = 0.0) -> np.ndarray:
    """Rational-resample baseband to the capture rate and mix to an offset."""
    if fs_out != fs_in:
        frac = Fraction(int(round(fs_out)), int(round(fs_in)))
        L, M = frac.numerator, frac.denominator
        # Interpolation lowpass: pass the TETRA channel, stop the first image.
        cut = 13_000.0
        trans = max(fs_in - 2 * cut, 10_000.0)
        h = design.kaiser_lowpass(cut, trans, fs_in * L, atten_db=70.0)
        h = (h * L).astype(np.float32)
        st = design.ResampleStage(up=L, down=M, taps=tuple(h.tolist()))
        hist = np.zeros(polyphase.stage_history_len(st), np.complex64)
        n = len(baseband)
        n -= n % M if M > 1 else 0
        y, _ = polyphase.stage_apply(st, baseband[:n].astype(np.complex64),
                                     hist)
    else:
        y = baseband.astype(np.complex64)
    if freq_offset_hz != 0.0:
        t = np.arange(len(y), dtype=np.float64) / fs_out
        y = y * np.exp(2j * np.pi * freq_offset_hz * t)
    return y.astype(np.complex64)


def add_awgn(x: np.ndarray, snr_db: float,
             rng: np.random.Generator | None = None) -> np.ndarray:
    rng = rng or np.random.default_rng(1234)
    p_sig = float(np.mean(np.abs(x) ** 2))
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    noise = (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    noise = noise.astype(np.complex64) * np.sqrt(p_noise / 2.0).astype(
        np.float32)
    return (x + noise).astype(np.complex64)


def generate_carrier(bits: np.ndarray, fs: float = 2.4e6,
                     freq_offset_hz: float = 0.0, snr_db: float | None = None,
                     sps: int = design.SPS,
                     rng: np.random.Generator | None = None) -> np.ndarray:
    """bits -> IQ at the capture rate: the full golden TX chain."""
    syms = bits_to_symbols(bits)
    bb = symbols_to_baseband(syms, sps=sps)
    iq = upconvert(bb, fs_in=design.SYMBOL_RATE * sps, fs_out=fs,
                   freq_offset_hz=freq_offset_hz)
    if snr_db is not None:
        iq = add_awgn(iq, snr_db, rng)
    return iq


def generate_multi_carrier(bits_per_carrier: list, fs: float,
                           offsets_hz: list, snr_db: float | None = None,
                           rng: np.random.Generator | None = None
                           ) -> np.ndarray:
    """Sum several TETRA carriers at different offsets into one wideband IQ."""
    parts = [generate_carrier(b, fs=fs, freq_offset_hz=off)
             for b, off in zip(bits_per_carrier, offsets_hz)]
    n = min(len(p) for p in parts)
    x = np.sum([p[:n] for p in parts], axis=0).astype(np.complex64)
    if snr_db is not None:
        x = add_awgn(x, snr_db, rng)
    return x
