"""NumPy oracle demodulation chain — the CPU bit-exactness contract
(the port's copy of tetraear_tpu/ref/demod.py; the scanners' detector
demodulates with it).

Chain (same algorithm and taps as the device path in ``tetraear_tpu_torch.dsp``):

  1. NCO mix by -freq_offset (phase-continuous across blocks)
     [reference: tetraear/signal/processor.py:85-100]
  2. Polyphase rational resample fs -> 72 kHz (4 samples/symbol), replacing
     decimate + Butterworth [processor.py:243-264]
  3. RRC matched filter (the true TETRA pulse; reference used Butterworth,
     processor.py:72-78)
  4. Oerder-Meyr square-law symbol-timing estimation + Catmull-Rom cubic
     interpolation to 18 ksym/s (replaces the best-phase power search,
     processor.py:186-215, with a parallel, state-carrying estimator)
  5. pi/4-DQPSK differential demod producing BOTH soft bits (new; needed for
     the voice codec path) and hard 0-3 symbols with the reference's exact
     quantization thresholds [processor.py:152-161]

Every step carries explicit streaming state so results are independent of the
block size — the property that lets the sharded runtime cut the time axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tetraear_tpu_torch.dsp import design
from tetraear_tpu_torch.ref import polyphase

TWO_PI = 2.0 * np.pi


# ---------------------------------------------------------------------------
# NCO mixer
# ---------------------------------------------------------------------------

def mix(x: np.ndarray, freq_hz: float, fs: float,
        phase0: float = 0.0) -> tuple[np.ndarray, float]:
    """Multiply by exp(-j(2*pi*f*n/fs + phase0)); returns (y, next_phase)."""
    n = np.arange(len(x), dtype=np.float64)
    ph = phase0 + TWO_PI * freq_hz * n / fs
    y = (x * np.exp(-1j * ph)).astype(np.complex64)
    next_phase = (phase0 + TWO_PI * freq_hz * len(x) / fs) % TWO_PI
    return y, next_phase


# ---------------------------------------------------------------------------
# Timing recovery (Oerder-Meyr + cubic interpolation)
# ---------------------------------------------------------------------------

@dataclass
class TimingState:
    tail: np.ndarray                    # last 4 samples of previous block
    next_t: float = 4.0                 # next symbol instant, tail coords
    acc: complex = 0j                   # smoothed O&M timing phasor
    locked: bool = False

    @staticmethod
    def init() -> "TimingState":
        return TimingState(tail=np.zeros(4, np.complex64))


def _catmull_rom(z: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Cubic interpolation of complex samples at fractional positions t."""
    i = np.floor(t).astype(np.int64)
    f = (t - i).astype(np.float32)
    p0, p1, p2, p3 = z[i - 1], z[i], z[i + 1], z[i + 2]
    f2 = f * f
    f3 = f2 * f
    return (0.5 * (2.0 * p1
                   + (p2 - p0) * f
                   + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * f2
                   + (3.0 * (p1 - p2) + p3 - p0) * f3)).astype(np.complex64)


def timing_recover(y: np.ndarray, state: TimingState, sps: int = design.SPS,
                   acc_decay: float = 0.5
                   ) -> tuple[np.ndarray, TimingState]:
    """Estimate symbol timing over a block and emit symbol-spaced samples.

    Requires len(y) % sps == 0 so the block-local Oerder-Meyr exponential
    stays phase-consistent across blocks.
    """
    if len(y) % sps != 0:
        raise ValueError(f"block length {len(y)} not divisible by sps={sps}")

    n = np.arange(len(y), dtype=np.float64)
    c = np.sum((np.abs(y) ** 2) * np.exp(-2j * np.pi * n / sps))
    acc = acc_decay * state.acc + c
    # Fractional timing offset in samples, in [0, sps).
    mu = (-np.angle(acc) / TWO_PI * sps) % sps

    z = np.concatenate([state.tail, y])
    tail_len = len(state.tail)          # == 4
    next_t = state.next_t
    # Snap the symbol clock's fractional phase to mu (nearest wrap).
    cur_frac = (next_t - tail_len) % sps
    delta = (mu - cur_frac + sps / 2.0) % sps - sps / 2.0
    next_t = next_t + delta
    if next_t < 1.0:
        next_t += sps

    t_max = len(z) - 3                  # cubic needs z[i+2]
    n_sym = int(np.floor((t_max - next_t) / sps)) + 1 if next_t <= t_max else 0
    if n_sym > 0:
        t_k = next_t + sps * np.arange(n_sym, dtype=np.float64)
        syms = _catmull_rom(z, t_k)
        next_t = float(t_k[-1] + sps)
    else:
        syms = np.zeros(0, np.complex64)

    shift = len(z) - tail_len
    new_state = TimingState(tail=z[-tail_len:], next_t=next_t - shift,
                            acc=acc, locked=True)
    return syms, new_state


# ---------------------------------------------------------------------------
# pi/4-DQPSK differential demodulation
# ---------------------------------------------------------------------------

def dqpsk_demod(symbols: np.ndarray, prev: complex | None,
                quantizer: str = "quadrant"
                ) -> tuple[np.ndarray, np.ndarray, complex | None]:
    """Differential demod of symbol-spaced complex samples.

    Returns (hard_symbols 0-3, soft_bits (N,2) float32, new_prev).

    quantizer="quadrant" (default): maximum-likelihood decision regions for
    the pi/4-DQPSK transition set {+-pi/4, +-3pi/4} — boundaries at 0 and
    +-pi/2, i.e. msb = [Im(d) < 0], lsb = [Re(d) < 0].  NOTE: this corrects a
    bug in the reference demodulator (tetraear/signal/processor.py:152-161),
    whose quantizer assigns the whole region |delta-phi| > 5pi/8 to symbol 3,
    so a clean +3pi/4 transition (symbol 1) is *always* misdecoded as 3.

    quantizer="legacy": replicates the reference's exact thresholds
    (-5pi/8, -3pi/8, 3pi/8, 5pi/8 with wrap->3) for parity experiments.

    Soft bits are matched-filter LLR proxies: msb = -Im(d)/|d|,
    lsb = -Re(d)/|d| (positive = bit 1); sign(soft) agrees with the quadrant
    hard decisions.  The reference has no soft output at all; the voice-codec
    path needs one (tetraear/ui/modern.py:2324-2356 fakes it from hard bits).
    """
    if len(symbols) == 0:
        return (np.zeros(0, np.uint8), np.zeros((0, 2), np.float32), prev)
    if prev is None:
        seq = symbols
        d = seq[1:] * np.conj(seq[:-1])
    else:
        seq = np.concatenate([[prev], symbols])
        d = seq[1:] * np.conj(seq[:-1])
    new_prev = complex(symbols[-1])

    if quantizer == "legacy":
        phase = np.arctan2(d.imag, d.real)
        hard = np.full(len(d), 3, dtype=np.uint8)       # wrap region default
        hard[phase < 5 * np.pi / 8] = 1
        hard[phase < 3 * np.pi / 8] = 0
        hard[phase < -3 * np.pi / 8] = 2
        hard[phase < -5 * np.pi / 8] = 3
    else:
        msb = (d.imag < 0).astype(np.uint8)
        lsb = (d.real < 0).astype(np.uint8)
        hard = ((msb << 1) | lsb).astype(np.uint8)

    mag = np.abs(d) + 1e-12
    soft = np.stack([-d.imag / mag, -d.real / mag], axis=1).astype(np.float32)
    return hard, soft, new_prev


def symbols_to_bits(symbols: np.ndarray) -> np.ndarray:
    """0-3 symbols -> bit pairs, MSB first (decoder.py:140-169 semantics)."""
    s = np.asarray(symbols, dtype=np.uint8)
    bits = np.empty(2 * len(s), dtype=np.uint8)
    bits[0::2] = (s >> 1) & 1
    bits[1::2] = s & 1
    return bits


# ---------------------------------------------------------------------------
# Full streaming oracle pipeline
# ---------------------------------------------------------------------------

@dataclass
class OracleState:
    nco_phase: float
    plan_state: polyphase.PlanState
    rrc_hist: np.ndarray
    timing: TimingState
    prev_symbol: complex | None = None


class OracleDemod:
    """Streaming single-carrier demodulator (NumPy), block-size independent."""

    def __init__(self, fs: float = 2.4e6, freq_offset_hz: float = 0.0,
                 sps: int = design.SPS):
        self.fs = fs
        self.freq_offset_hz = freq_offset_hz
        self.sps = sps
        self.plan = design.build_resample_plan(fs, design.SYMBOL_RATE * sps)
        self.rrc = design.rrc_taps(sps=sps).astype(np.float32)
        self.granularity = _plan_granularity(self.plan, sps)

    def init_state(self) -> OracleState:
        return OracleState(
            nco_phase=0.0,
            plan_state=polyphase.PlanState.init(self.plan),
            rrc_hist=np.zeros(len(self.rrc) - 1, np.complex64),
            timing=TimingState.init(),
        )

    def process(self, block: np.ndarray, state: OracleState
                ) -> tuple[dict, OracleState]:
        """Demodulate one IQ block; returns dict of per-block outputs."""
        x = np.asarray(block, dtype=np.complex64)
        y, nco_phase = mix(x, self.freq_offset_hz, self.fs, state.nco_phase)
        y, plan_state = polyphase.plan_apply(self.plan, y, state.plan_state)
        y, rrc_hist = polyphase.fir_stream(self.rrc, y, state.rrc_hist)
        sym_c, timing = timing_recover(y, state.timing, sps=self.sps)
        hard, soft, prev = dqpsk_demod(sym_c, state.prev_symbol)
        bits = symbols_to_bits(hard)
        out = {
            "baseband": y,
            "symbols_complex": sym_c,
            "symbols": hard,
            "soft_bits": soft,
            "bits": bits,
        }
        return out, OracleState(nco_phase=nco_phase, plan_state=plan_state,
                                rrc_hist=rrc_hist, timing=timing,
                                prev_symbol=prev)

    def run(self, iq: np.ndarray, block_size: int | None = None) -> dict:
        """Process a full capture (optionally in blocks) and concatenate."""
        state = self.init_state()
        if block_size is None:
            block_size = len(iq)
        # Block must satisfy every stage's divisibility; round down.
        gran = _plan_granularity(self.plan, self.sps)
        block_size -= block_size % gran
        outs = {"symbols": [], "soft_bits": [], "bits": [],
                "symbols_complex": []}
        pos = 0
        while pos + gran <= len(iq):
            n = min(block_size, (len(iq) - pos) // gran * gran)
            out, state = self.process(iq[pos:pos + n], state)
            for k in outs:
                outs[k].append(out[k])
            pos += n
        return {k: np.concatenate(v) if v else np.zeros(0)
                for k, v in outs.items()}


def _plan_granularity(plan: design.ResamplePlan, sps: int) -> int:
    """Input block granularity: every stage divides AND output % sps == 0."""
    import math
    n = 1
    for st in plan.stages:
        n = n * st.down // math.gcd(n, st.down)
    # ensure output divisible by sps
    out_per_n = 1
    for st in plan.stages:
        out_per_n = out_per_n * st.up
    down = 1
    for st in plan.stages:
        down *= st.down
    # outputs for input n: n * prod(up) / prod(down); need divisible by sps
    k = 1
    while (k * n * out_per_n) % (down * sps) != 0:
        k += 1
    return k * n
