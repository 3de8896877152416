"""A wideband capture made in the frequency domain, on the device.

Every carrier sends a periodic symbol stream: its points are the
pi/4-DQPSK phases of its bits, its spectrum is the DFT of one period of
points (one value per 1/period Hz), shaped by the root-raised-cosine
filter of the standard (roll-off 0.35) and delayed by a fraction of a
symbol, and put at the carrier's frequency in the spectrum of the whole
capture, which one inverse FFT turns into samples.  The capture is
periodic, so it can be replayed block after block with no seam: the
stream's phase returns to its start after one period.  White Gaussian
noise over the whole band is added in the time domain.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SYMBOL_RATE = 18_000.0
ROLLOFF = 0.35
# pi/4 units of the phase step of dibits 00, 01, 10, 11
_STEP = np.array([1, 3, -1, -3], np.int64)


def points(bits: np.ndarray) -> np.ndarray:
    """(C, 2 Ns) bits -> (C, Ns) phase indices in pi/4 units (mod 8); the
    differential step into symbol 0 is from the stream's last symbol."""
    b = np.asarray(bits, np.int64)
    sym = (b[:, 0::2] << 1) | b[:, 1::2]
    return np.cumsum(_STEP[sym], axis=1) % 8


def close_phase(bits: np.ndarray) -> None:
    """Rewrite each stream's last two symbols, in place, so that its phase
    steps over one period sum to a multiple of 2 pi (the stream is then
    periodic)."""
    b = np.asarray(bits)
    sym = (b[:, 0::2].astype(np.int64) << 1) | b[:, 1::2]
    head = _STEP[sym[:, :-2]].sum(axis=1) % 8
    for c in range(len(b)):
        for s1 in range(4):
            for s2 in range(4):
                if (head[c] + _STEP[s1] + _STEP[s2]) % 8 == 0:
                    b[c, -4:] = ((s1 >> 1) & 1, s1 & 1, (s2 >> 1) & 1, s2 & 1)
                    break
            else:
                continue
            break


def rrc(f: torch.Tensor) -> torch.Tensor:
    """Root-raised-cosine amplitude response at frequencies ``f`` (Hz),
    1 in the pass band."""
    t = 1.0 / SYMBOL_RATE
    lo = (1 - ROLLOFF) / (2 * t)
    hi = (1 + ROLLOFF) / (2 * t)
    a = f.abs()
    rc = torch.where(
        a <= lo, torch.ones_like(a),
        0.5 * (1 + torch.cos(math.pi * t / ROLLOFF * (a - lo))))
    rc = torch.where(a > hi, torch.zeros_like(a), rc)
    return rc.sqrt()


def ifft_big(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse DFT of a 1-D complex tensor of length N = p * q by four
    steps (length-p transforms, twiddles, length-q transforms), so that
    no single transform is longer than max(p, q)."""
    n = x.numel()
    q = n // p
    assert p * q == n, (n, p)
    b = torch.fft.ifft(x.view(p, q), dim=0)
    del x
    k2 = torch.arange(q, device=b.device, dtype=torch.int64)
    rows = max(1, (1 << 24) // q)
    for r0 in range(0, p, rows):
        n1 = torch.arange(r0, min(p, r0 + rows), device=b.device,
                          dtype=torch.int64)
        ang = ((n1[:, None] * k2[None, :]) % n).to(torch.float64) \
            * (2 * math.pi / n)
        b[r0:r0 + len(n1)] *= torch.polar(torch.ones_like(ang), ang).to(
            b.dtype)
    c = torch.fft.ifft(b, dim=1)
    del b
    return c.t().contiguous().view(n)


def _four_step_p(n: int) -> int:
    """The power of two nearest sqrt(n) that divides n."""
    p = 1
    while n % (p * 2) == 0 and (p * 2) ** 2 <= n:
        p *= 2
    return p


def capture(phase_idx: np.ndarray, bins: np.ndarray, delays: np.ndarray,
            n: int, fs: float, snr_db: float, seed: int,
            device: torch.device) -> torch.Tensor:
    """(n,) complex64 samples on ``device``: carrier i sends the periodic
    points exp(j pi/4 phase_idx[i]) at the symbol rate, centred on DFT
    bin ``bins[i]`` (the period is n samples, so bin spacing fs / n),
    delayed by ``delays[i]`` samples, at unit power; noise at ``snr_db``
    below one carrier over the whole band."""
    ns = phase_idx.shape[1]
    sps = fs / SYMBOL_RATE
    assert abs(ns * sps - n) < 1e-6 * n, (ns, sps, n)
    df = fs / n
    kmax = int((1 + ROLLOFF) * SYMBOL_RATE / 2 / df)
    k = torch.arange(-kmax, kmax + 1, device=device, dtype=torch.int64)
    shape = rrc(k.to(torch.float64) * df) * (n / ns)
    spec = torch.zeros((n, 2), dtype=torch.float32, device=device)
    lut = torch.polar(torch.ones(8, dtype=torch.float64),
                      torch.arange(8, dtype=torch.float64) * math.pi / 4)
    lut = lut.to(torch.complex64).to(device)
    kmod = k % ns
    chunk = max(1, (1 << 26) // (2 * kmax + 1))
    for c0 in range(0, len(phase_idx), chunk):
        pi = torch.from_numpy(phase_idx[c0:c0 + chunk]).to(device)
        d = torch.fft.fft(lut[pi], dim=1)                    # (c, ns)
        tau = torch.from_numpy(np.asarray(delays[c0:c0 + chunk],
                                          np.float64)).to(device)
        ramp = torch.polar(torch.ones((len(tau), len(k)), dtype=torch.float64,
                                      device=device),
                           -2 * math.pi / n * tau[:, None]
                           * k[None, :].to(torch.float64))
        vals = d[:, kmod] * (ramp * shape[None, :]).to(torch.complex64)
        b = torch.from_numpy(np.asarray(bins[c0:c0 + chunk],
                                        np.int64)).to(device)
        idx = (b[:, None] + k[None, :]) % n
        spec.index_add_(0, idx.reshape(-1),
                        torch.view_as_real(vals.reshape(-1)))
        del d, ramp, vals, idx
    x = torch.view_as_complex(spec)
    if n > (1 << 27):
        x = ifft_big(x, _four_step_p(n))
    else:
        x = torch.fft.ifft(x)
    del spec
    sigma = math.sqrt(1.0 / 10.0 ** (snr_db / 10.0) / 2.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    xr = torch.view_as_real(x)
    step = 1 << 26
    for i in range(0, n, step):
        m = min(step, n - i)
        xr[i:i + m] += sigma * torch.randn((m, 2), generator=gen,
                                           device=device)
    return x
