"""Filter design and rate-conversion planning (trace-time, NumPy).

All taps are designed once on the host in float64 and cast to float32; both the
NumPy oracle (`tetraear_tpu_torch.ref`) and the device path share the exact same
taps so that the two can be compared bit-for-bit at the symbol level.

Replaces the reference's ad-hoc `scipy.signal.decimate` + Butterworth
`filtfilt` chain (reference: tetraear/signal/processor.py:51-83, 243-257) with
a properly designed polyphase rational resampler + RRC matched filter, which is
both more correct (linear phase, controlled aliasing) and maps onto the
device as strided convolutions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache

import numpy as np

# TETRA air-interface constants (ETSI EN 300 392-2)
SYMBOL_RATE = 18_000.0          # sym/s
CHANNEL_SPACING = 25_000.0      # Hz
RRC_ROLLOFF = 0.35              # spec root-raised-cosine roll-off
SPS = 4                         # samples/symbol after the front-end resampler
BASEBAND_RATE = SYMBOL_RATE * SPS  # 72 kHz internal processing rate


def kaiser_beta(atten_db: float) -> float:
    """Kaiser window beta for a given stopband attenuation in dB."""
    if atten_db > 50.0:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21.0:
        return 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    return 0.0


def kaiser_lowpass(cutoff_hz: float, transition_hz: float, fs: float,
                   atten_db: float = 60.0, force_odd: bool = True) -> np.ndarray:
    """Windowed-sinc lowpass FIR (Kaiser window), unity DC gain.

    cutoff_hz is the -6 dB edge; the stopband starts at
    cutoff_hz + transition_hz.
    """
    beta = kaiser_beta(atten_db)
    # Kaiser length estimate: N ~= (A - 8) / (2.285 * delta_omega)
    dw = 2.0 * math.pi * transition_hz / fs
    n = int(math.ceil((atten_db - 8.0) / (2.285 * dw)))
    if force_odd and n % 2 == 0:
        n += 1
    m = np.arange(n, dtype=np.float64)
    center = (n - 1) / 2.0
    fc = (cutoff_hz + transition_hz / 2.0) / fs  # place edge mid-transition
    x = m - center
    h = 2.0 * fc * np.sinc(2.0 * fc * x)
    h *= np.kaiser(n, beta)
    h /= np.sum(h)
    return h.astype(np.float64)


def rrc_taps(sps: int = SPS, span_symbols: int = 10,
             rolloff: float = RRC_ROLLOFF) -> np.ndarray:
    """Root-raised-cosine taps, unit energy, odd length ``span*sps + 1``.

    The reference approximates the TETRA pulse with a 4th-order Butterworth
    (tetraear/signal/processor.py:72-78); we build the true RRC the spec
    implies, which also gives the matched-filter SNR gain needed for soft
    bits.
    """
    n = span_symbols * sps + 1
    t = (np.arange(n, dtype=np.float64) - (n - 1) / 2.0) / float(sps)
    a = float(rolloff)
    h = np.empty(n, dtype=np.float64)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-12:
            h[i] = 1.0 - a + 4.0 * a / math.pi
        elif a > 0 and abs(abs(ti) - 1.0 / (4.0 * a)) < 1e-9:
            h[i] = (a / math.sqrt(2.0)) * (
                (1.0 + 2.0 / math.pi) * math.sin(math.pi / (4.0 * a))
                + (1.0 - 2.0 / math.pi) * math.cos(math.pi / (4.0 * a))
            )
        else:
            num = (math.sin(math.pi * ti * (1.0 - a))
                   + 4.0 * a * ti * math.cos(math.pi * ti * (1.0 + a)))
            den = math.pi * ti * (1.0 - (4.0 * a * ti) ** 2)
            h[i] = num / den
    h /= math.sqrt(np.sum(h * h))
    return h


@dataclass(frozen=True)
class ResampleStage:
    """One polyphase rational resampling stage: out_rate = in_rate * L / M."""
    up: int              # L
    down: int            # M
    taps: tuple          # float32 taps at the L-upsampled rate (immutable)

    @property
    def taps_array(self) -> np.ndarray:
        return np.asarray(self.taps, dtype=np.float32)


@dataclass(frozen=True)
class ResamplePlan:
    """A chain of stages taking ``in_rate`` to ``out_rate`` exactly."""
    in_rate: float
    out_rate: float
    stages: tuple  # tuple[ResampleStage, ...]


def _stage(fs_in: float, up: int, down: int, cutoff_hz: float,
           transition_hz: float, atten_db: float = 60.0) -> ResampleStage:
    fs_up = fs_in * up
    h = kaiser_lowpass(cutoff_hz, transition_hz, fs_up, atten_db)
    # Polyphase gain compensation for the L-fold zero-stuffing.
    h = (h * up).astype(np.float32)
    return ResampleStage(up=up, down=down, taps=tuple(h.tolist()))


@lru_cache(maxsize=32)
def build_resample_plan(fs_in: float, fs_out: float = BASEBAND_RATE,
                        channel_halfband_hz: float = 12_500.0,
                        atten_db: float = 60.0) -> ResamplePlan:
    """Plan an exact-rational decimation chain fs_in -> fs_out.

    Strategy: first an integer decimation stage with a wide transition band
    (cheap at high rate), then one rational clean-up stage that also performs
    channel selection down to +-channel_halfband_hz.

    For the canonical RTL-SDR rate 2.4 Msps -> 72 kHz this yields
    (1/25) then (3/4), mirroring (but correcting) the reference's
    decimate-to-240 kHz + Butterworth design
    (tetraear/signal/processor.py:243-264).
    """
    frac = Fraction(int(round(fs_out)), int(round(fs_in)))
    total_up, total_down = frac.numerator, frac.denominator
    stages = []
    fs = fs_in

    # Integer pre-decimation: peel the largest factor d of total_down such
    # that the intermediate rate stays >= ~3x the output rate (wide
    # transition => short filter where the data rate is highest).
    pre = 1
    rem = total_down
    for p in (2, 3, 5, 7):
        while rem % p == 0 and fs / (pre * p) >= 3.0 * fs_out:
            pre *= p
            rem //= p
    if pre > 1:
        fs_mid = fs / pre
        # Protect the channel band from aliasing: stopband must start where
        # the first alias would fold back onto +-halfband.
        stop = fs_mid - 1.5 * channel_halfband_hz
        cut = 1.2 * channel_halfband_hz
        stages.append(_stage(fs, 1, pre, cut, max(stop - cut, fs_mid * 0.1),
                             atten_db))
        fs = fs_mid

    # Final rational stage with channel-select cutoff.
    last_frac = Fraction(int(round(fs_out)), int(round(fs)))
    lu, ld = last_frac.numerator, last_frac.denominator
    if (lu, ld) != (1, 1):
        cut = channel_halfband_hz
        trans = max(fs_out / 2.0 - cut, 2_000.0)
        stages.append(_stage(fs, lu, ld, cut, trans, atten_db))
        fs = fs * lu / ld

    if abs(fs - fs_out) > 1e-6:
        raise ValueError(f"resample plan failed: got {fs}, wanted {fs_out} "
                         f"from {fs_in}")
    return ResamplePlan(in_rate=fs_in, out_rate=fs_out, stages=tuple(stages))


def fold_fir_into_stage(stage: ResampleStage,
                        fir_taps: np.ndarray) -> ResampleStage:
    """Fold a post-decimation FIR into a polyphase stage's taps.

    Noble identity: filtering at the stage's *output* rate with h is
    equivalent to filtering at the upsampled rate with h zero-stuffed by
    the stage's down factor, so the combined stage computes
    ``fir(resample(x))`` in one pass.  Used to eliminate separate stride-1
    convolutions (one fewer pass over every carrier stream).
    """
    h = stage.taps_array.astype(np.float64)
    fir = np.asarray(fir_taps, np.float64)
    up = np.zeros((len(fir) - 1) * stage.down + 1, np.float64)
    up[::stage.down] = fir
    combined = np.convolve(h, up).astype(np.float32)
    return ResampleStage(up=stage.up, down=stage.down,
                         taps=tuple(combined.tolist()))


def plan_min_block(plan: ResamplePlan) -> int:
    """Smallest input-block size that every stage divides evenly."""
    n = 1
    for st in plan.stages:
        # Input block must be a multiple of down/gcd per stage, propagated.
        n = n * st.down // math.gcd(n, st.down)
    return n


def plan_history(plan: ResamplePlan) -> list:
    """Per-stage input history (overlap/halo) lengths in input samples.

    Stage i needs ceil((T_i - 1) / L_i) trailing input samples from the
    previous block so that block-streamed output equals offline filtering —
    this is the overlap-save halo that gets exchanged between time shards
    (SURVEY.md section 5.7).
    """
    hist = []
    for st in plan.stages:
        t = len(st.taps)
        hist.append(int(math.ceil((t - 1) / st.up)))
    return hist
