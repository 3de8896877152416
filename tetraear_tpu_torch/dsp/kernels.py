"""Carrier-bank demod kernels in plain torch (tetraear_tpu/dsp/kernels.py).

The conv frontend and the resample stages of the classic chain, batched
over carriers:

  * NCO mixing with exact integer cycle arithmetic in float32: all
    cycle counters are integers < fs < 2^24, which float32 holds
    exactly, so the phase never loses precision over long streams.
    Tables are (coarse + fine) outer sums, no gathers.
  * Polyphase resampling stages as strided 1-D convolutions over a
    real/imag-stacked batch (``torch.nn.functional.conv1d``; the JAX
    package computes these with XLA convolutions outside any Pallas
    kernel, so a library convolution is their counterpart here).
  * Same taps and block/halo semantics as the NumPy oracle
    (ref/polyphase.py), so symbol decisions agree exactly.

Complex quantities cross the public boundaries as float32 with a
trailing [re, im] axis, or as PLANAR (..., 2, N) float32 for the
wideband block, as in the JAX package, so states and outputs compare
like with like.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp.design import ResamplePlan, ResampleStage

FINE = 256            # fine-table size for the NCO outer sum


# ---------------------------------------------------------------------------
# Real <-> complex boundary helpers
# ---------------------------------------------------------------------------

def c2r(z: torch.Tensor) -> torch.Tensor:
    """complex (..., N) -> float32 (..., N, 2)."""
    return torch.stack([z.real, z.imag], dim=-1)


def r2c(a: torch.Tensor) -> torch.Tensor:
    """float32 (..., N, 2) -> complex64 (..., N)."""
    return torch.complex(a[..., 0], a[..., 1])


def c2r_np(z: np.ndarray) -> np.ndarray:
    """complex (..., N) -> float32 (..., N, 2)."""
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


def r2c_np(a: np.ndarray) -> np.ndarray:
    return (a[..., 0] + 1j * a[..., 1]).astype(np.complex64)


def c2p_np(z: np.ndarray) -> np.ndarray:
    """complex (..., N) -> float32 PLANAR (..., 2, N): the wideband block
    layout the fft2p front end reads as-is."""
    return np.stack([z.real, z.imag], axis=-2).astype(np.float32)


# ---------------------------------------------------------------------------
# NCO tables (host-side, exact integer arithmetic)
# ---------------------------------------------------------------------------

def nco_tables(freqs_hz: np.ndarray, fs: float, block_len: int) -> dict:
    """Per-carrier NCO cycle tables for blocks of ``block_len`` samples.

    Returns float32 arrays whose entries are exact integers (< fs):
      coarse: (C, ceil(block_len/FINE)) — cycles at sample index i*FINE
      fine:   (C, FINE)                 — cycles at sample index j
      block_step: (C,)                  — cycle advance per block
    Sample n's phase (in cycles) = (state + coarse[n//FINE] + fine[n%FINE])
    mod fs, scaled by 1/fs.
    """
    fs_i = int(round(fs))
    freqs = np.asarray(freqs_hz)
    if not np.allclose(freqs, np.round(freqs)):
        raise ValueError("NCO frequencies must be integer Hz")
    freqs_i = np.round(freqs).astype(np.int64)
    n_coarse = math.ceil(block_len / FINE)
    i = np.arange(n_coarse, dtype=np.int64)
    j = np.arange(FINE, dtype=np.int64)
    coarse = ((i[None, :] * FINE) * freqs_i[:, None]) % fs_i
    fine = (j[None, :] * freqs_i[:, None]) % fs_i
    step = (np.int64(block_len) * freqs_i) % fs_i
    return {
        "coarse": coarse.astype(np.float32),
        "fine": fine.astype(np.float32),
        "block_step": step.astype(np.float32),
        "fs": float(fs_i),
        "block_len": block_len,
    }


def nco_mix(x: torch.Tensor, cycles: torch.Tensor, coarse: torch.Tensor,
            fine: torch.Tensor, block_step: torch.Tensor,
            fs: float) -> tuple:
    """Mix (C, N) complex blocks down by each carrier's frequency.

    cycles: (C,) float32 exact-integer cycle state. Returns (y, new_cycles).
    """
    c, n = x.shape
    n_coarse = coarse.shape[1]
    # (C, n_coarse, FINE) exact-integer cycle counts, then mod fs.
    ph = (cycles[:, None, None] + coarse[:, :, None] + fine[:, None, :])
    ph = torch.remainder(ph, fs)
    ph = ph.reshape(c, n_coarse * FINE)[:, :n]
    ang = ph * float(np.float32(2.0 * np.pi / fs))
    osc = torch.complex(torch.cos(ang), -torch.sin(ang))
    new_cycles = torch.remainder(cycles + block_step, fs)
    return x * osc, new_cycles


# ---------------------------------------------------------------------------
# Polyphase stage as strided convolutions
# ---------------------------------------------------------------------------

def _phase_bank(stage: ResampleStage) -> np.ndarray:
    h = stage.taps_array
    L = stage.up
    P = math.ceil(len(h) / L)
    bank = np.zeros((L, P), dtype=np.float32)
    for p in range(L):
        sub = h[p::L]
        bank[p, :len(sub)] = sub
    return bank


def stage_history_len(stage: ResampleStage) -> int:
    return math.ceil((len(stage.taps) - 1) / stage.up)


def _conv1d_strided(x: torch.Tensor, taps_rev: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """(B, len) real x, correlation with reversed taps, VALID, stride."""
    out = torch.nn.functional.conv1d(x[:, None, :], taps_rev[None, None, :],
                                     stride=stride)
    return out[:, 0, :]


_RHS_CACHE: dict = {}


def _stage_rhs(stage: ResampleStage, device) -> tuple:
    """(conv weights on ``device``, P, P2): for L == 1 the reversed taps
    (1, 1, P); otherwise all L output phases as ONE multi-channel
    strided conv — output channel m0 carries branch p = (m0*M) % L's
    reversed taps placed at intra-stride offset floor(m0*M/L) inside a
    widened kernel, so every phase shares the same stride-M window walk
    and the input is read once instead of L times."""
    key = (stage, str(device))
    if key not in _RHS_CACHE:
        L, M = stage.up, stage.down
        bank = _phase_bank(stage)
        P = bank.shape[1]
        if L == 1:
            rhs_np = bank[0][::-1].copy()[None, None, :]
            P2 = P
        else:
            deltas = [(m0 * M) // L for m0 in range(L)]
            P2 = P + max(deltas)
            rhs_np = np.zeros((L, 1, P2), np.float32)
            for m0 in range(L):
                d = deltas[m0]
                rhs_np[m0, 0, d:d + P] = bank[(m0 * M) % L][::-1]
        _RHS_CACHE[key] = (torch.from_numpy(rhs_np).to(device), P, P2)
    return _RHS_CACHE[key]


def stage_apply(stage: ResampleStage, x: torch.Tensor,
                history: torch.Tensor) -> tuple:
    """One polyphase stage on a (C, N) complex block with (C, H) history.

    Same output values as ref.polyphase.stage_apply (float32 rounding
    aside).  Returns (y (C, N*L//M), new_history).
    """
    L, M = stage.up, stage.down
    H = stage_history_len(stage)
    c, n = x.shape
    if (n * L) % M != 0:
        raise ValueError(f"block length {n} incompatible with L={L} M={M}")
    n_out = n * L // M
    if n_out % L != 0:
        raise ValueError(f"output length {n_out} not divisible by L={L}")

    xx = torch.cat([history, x], dim=1)                 # (C, H+N)
    xr = torch.cat([xx.real, xx.imag], dim=0)           # (2C, H+N) float32
    rhs, P, P2 = _stage_rhs(stage, x.device)
    start = H - (P - 1)
    if L == 1:
        need = start + (n_out - 1) * M + P
        yr = torch.nn.functional.conv1d(xr[:, None, start:need], rhs,
                                        stride=M)[:, 0, :]
    else:
        T = n_out // L
        need = start + (T - 1) * M + P2
        out = torch.nn.functional.conv1d(xr[:, None, start:need], rhs,
                                         stride=M)      # (2C, L, T)
        yr = out.transpose(1, 2).reshape(2 * c, n_out)
    y = torch.complex(yr[:c], yr[c:])
    new_hist = xx[:, xx.shape[1] - H:] if H > 0 else xx[:, :0]
    return y, new_hist


def plan_apply(plan: ResamplePlan, x: torch.Tensor,
               histories: list) -> tuple:
    y = x
    new_hists = []
    for st, hist in zip(plan.stages, histories):
        y, h2 = stage_apply(st, y, hist)
        new_hists.append(h2)
    return y, new_hists


def fir_apply(taps: np.ndarray, x: torch.Tensor,
              history: torch.Tensor) -> tuple:
    """Streaming causal FIR (L=M=1) on (C, N) blocks."""
    st = ResampleStage(up=1, down=1,
                       taps=tuple(np.asarray(taps, np.float32).tolist()))
    return stage_apply(st, x, history)


def init_plan_histories(plan: ResamplePlan, n_carriers: int,
                        device=None) -> list:
    return [torch.zeros((n_carriers, stage_history_len(st)),
                        dtype=torch.complex64, device=resolve(device))
            for st in plan.stages]
