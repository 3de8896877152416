"""Batched symbol-timing recovery and differential demod in plain torch
(tetraear_tpu/dsp/timing.py).

Vectorized over carriers, fixed-shape outputs with validity masks, as in
the JAX module, so states and outputs compare like with like.

Algorithm identical to the NumPy oracle (ref/demod in the JAX package):
Oerder-Meyr square-law timing phasor with an IIR-smoothed accumulator,
nearest-wrap snap of the symbol clock, Catmull-Rom interpolation at
symbol instants, then pi/4-DQPSK differential demod with quadrant
decisions and soft bits.  One departure: a clock snapped into [0, 1)
keeps its symbol, where the reference wraps it a symbol on and drops
one (``timing_recover``).

At sps=4 the O&M twiddles exp(-j 2 pi n / 4) are exactly {1,-j,-1,j}, so
the timing metric reduces to four strided power sums.

Float32 pitfalls mirrored from the reference: ``jnp.angle`` is
``torch.atan2`` and ``jnp.mod`` is ``torch.remainder`` (both fmod-based
with the sign fix-up); a flipped ``floor(next_t)`` changes the tap base
and every later symbol, so every expression keeps the reference's order
of operations.
"""

from __future__ import annotations

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve

SPS = 4
TAIL = 4                       # carried samples for cubic interpolation
TWO_PI = 2.0 * np.pi


def init_timing_state(n_carriers: int, device=None) -> dict:
    dev = resolve(device)
    return {
        "tail": torch.zeros((n_carriers, TAIL), dtype=torch.complex64,
                            device=dev),
        "next_t": torch.full((n_carriers,), float(TAIL),
                             dtype=torch.float32, device=dev),
        "acc": torch.zeros((n_carriers,), dtype=torch.complex64,
                           device=dev),
    }


def _om_phasor(y: torch.Tensor) -> torch.Tensor:
    """Oerder-Meyr timing phasor per carrier; y is (C, N), N % 4 == 0."""
    p = y.real * y.real + y.imag * y.imag            # |y|^2, (C, N)
    c, n = p.shape
    s = p.reshape(c, n // SPS, SPS).sum(dim=1)       # (C, 4) per-phase power
    # sum_n |y|^2 e^{-j 2 pi n / 4}: twiddles 1, -j, -1, j
    return torch.complex(s[:, 0] - s[:, 2], s[:, 3] - s[:, 1])


def _catmull_rom_rows(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-row cubic interpolation: z (C, L) complex, t (C, K) positions."""
    i = torch.floor(t).to(torch.int64)
    f = (t - i).to(torch.float32)
    idx = torch.clamp(i, 1, z.shape[1] - 3)
    p0 = torch.gather(z, 1, idx - 1)
    p1 = torch.gather(z, 1, idx)
    p2 = torch.gather(z, 1, idx + 1)
    p3 = torch.gather(z, 1, idx + 2)
    f2 = f * f
    f3 = f2 * f
    return 0.5 * (2.0 * p1
                  + (p2 - p0) * f
                  + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * f2
                  + (3.0 * (p1 - p2) + p3 - p0) * f3)


def timing_recover(y: torch.Tensor, state: dict,
                   acc_decay: float = 0.5) -> tuple:
    """(C, N) matched-filtered samples -> masked symbol-spaced samples.

    Returns (symbols (C, K), valid (C, K) bool, new_state) with
    K = N//SPS + 1 (fixed shape; the true count varies by +-1 per block).

    Symbol instants are t_k = next_t + 4k, so the fractional part is
    constant per carrier and the four cubic taps are stride-4 slices of
    z at one of four integer base offsets: tap j of carrier c is
    z[c, b_c + j + 4k], read here with one gather per tap.
    """
    c, n = y.shape
    if n % SPS != 0:
        raise ValueError(f"block length {n} not divisible by sps={SPS}")
    k_max = n // SPS + 1
    dev = y.device

    acc = acc_decay * state["acc"] + _om_phasor(y)
    mu = torch.remainder(
        -torch.atan2(acc.imag, acc.real) / TWO_PI * SPS, SPS)     # (C,)

    next_t = state["next_t"]
    cur_frac = torch.remainder(next_t - TAIL, SPS)
    delta = torch.remainder(mu - cur_frac + SPS / 2.0, SPS) - SPS / 2.0
    next_t = next_t + delta
    # the reference wraps below 1.0, which drops a symbol whenever a
    # carrier whose instants sit just above 1.0 jitters below it: a
    # one-way slip that repeats for as long as the timing sits there.
    # The taps below take next_t in [0, 1) as they take it above SPS + 1
    # (i0 clamped, a fraction outside [0, 1)), so only a snap below 0,
    # more than a sample back, wraps.
    next_t = torch.where(next_t < 0.0, next_t + SPS, next_t)

    t_max = float(TAIL + n - 3)
    k_r = torch.arange(k_max, dtype=torch.float32, device=dev)
    t_k = next_t[:, None] + SPS * k_r[None]
    valid = t_k <= t_max                                   # (C, K)

    # per-row integer base b = floor(next_t) - 1 in {0..3}, fraction f
    i0 = torch.clamp(torch.floor(next_t).to(torch.int64), 1, SPS)
    b = i0 - 1                                             # (C,)
    f = (next_t - i0.to(torch.float32))[:, None]           # (C, 1)

    z_p = torch.cat(
        [state["tail"], y,
         torch.zeros((c, SPS + 4), dtype=y.dtype, device=dev)], dim=1)
    base = b[:, None] + SPS * torch.arange(k_max, device=dev)[None, :]
    p0, p1, p2, p3 = (torch.gather(z_p, 1, base + j) for j in range(4))

    f2 = f * f
    f3 = f2 * f
    syms = 0.5 * (2.0 * p1
                  + (p2 - p0) * f
                  + (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3) * f2
                  + (3.0 * (p1 - p2) + p3 - p0) * f3)
    n_valid = valid.sum(dim=1)                             # (C,)

    new_next = next_t + SPS * n_valid.to(torch.float32) - float(n)
    new_state = {
        "tail": y[:, n - TAIL:],
        "next_t": new_next,
        "acc": acc,
    }
    return syms, valid, new_state


def afc_error(symbols: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-carrier frequency error in rad/symbol from the d^4 detector.

    Every legal pi/4-DQPSK transition satisfies 4*dphi = pi (mod 2pi), so
    with a residual rotation eps per symbol, E[d^4] = |d|^4 e^{j(pi+4eps)}
    — data-independent.  Returns (C,) estimated eps.
    """
    d = symbols[:, 1:] * torch.conj(symbols[:, :-1])
    m = torch.abs(d) + 1e-12
    u = d / m
    u2 = u * u
    d4 = u2 * u2
    w = (valid[:, 1:] & valid[:, :-1]).to(torch.float32)
    acc = (d4 * w).sum(dim=1)
    # angle(-acc) measures (angle(acc) - pi) without the +-pi wrap
    # discontinuity that sits exactly at the zero-error operating point
    return torch.atan2(-acc.imag, -acc.real) / 4.0


def apply_freq_correction(symbols: torch.Tensor, omega: torch.Tensor,
                          phase0: torch.Tensor,
                          n_valid: torch.Tensor | None = None) -> tuple:
    """Derotate symbol-spaced samples by a per-carrier frequency omega
    (rad/symbol) with carried phase.  Returns (corrected, new_phase0).

    ``n_valid`` is the per-carrier count of real symbols in this block
    (timing_recover's mask sum).  The carried phase advances by
    omega * n_valid — advancing by the padded slot count K instead would
    over-rotate the next block's first symbol by omega*(K - n_valid)
    whenever a block yields fewer than K symbols.
    """
    k = torch.arange(symbols.shape[1], dtype=torch.float32,
                     device=symbols.device)[None, :]
    ang = phase0[:, None] + omega[:, None] * k
    rot = torch.complex(torch.cos(ang), -torch.sin(ang))
    if n_valid is None:
        n_valid = torch.full(symbols.shape[:1], float(symbols.shape[1]),
                             dtype=torch.float32, device=symbols.device)
    new_phase0 = torch.remainder(
        phase0 + omega * n_valid.to(torch.float32),
        float(np.float32(TWO_PI)))
    return symbols * rot, new_phase0


def dqpsk_demod(symbols: torch.Tensor, valid: torch.Tensor,
                prev: torch.Tensor) -> tuple:
    """Differential demod on masked symbol rows.

    symbols: (C, K) complex, valid: (C, K) bool — valid entries are
    contiguous from index 0 (timing_recover guarantees this).
    prev: (C,) last valid symbol from the previous block.

    Returns (hard (C, K) uint8, soft (C, K, 2) float32, new_prev (C,)).
    """
    seq = torch.cat([prev[:, None], symbols], dim=1)          # (C, K+1)
    d = seq[:, 1:] * torch.conj(seq[:, :-1])
    msb = (d.imag < 0).to(torch.uint8)
    lsb = (d.real < 0).to(torch.uint8)
    hard = (msb << 1) | lsb
    mag = torch.abs(d) + 1e-12
    soft = torch.stack([-d.imag / mag, -d.real / mag], dim=-1)

    # last valid symbol per carrier: valid entries are contiguous from
    # 0, so the last one is where valid & ~valid_next
    n_valid = valid.sum(dim=1)
    valid_next = torch.cat(
        [valid[:, 1:], torch.zeros_like(valid[:, :1])], dim=1)
    edge = valid & ~valid_next                             # one-hot row
    last = torch.where(edge, symbols, torch.zeros_like(symbols)).sum(dim=1)
    new_prev = torch.where(n_valid > 0, last, prev)
    return hard, soft.to(torch.float32), new_prev
