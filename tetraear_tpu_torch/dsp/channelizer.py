"""Overlap-save FFT channelizer geometry and tables
(tetraear_tpu/dsp/channelizer.py).

One forward FFT of the wideband block serves every carrier: each
carrier's band of n_band bins is gathered, multiplied by the channel
filter and inverse-transformed at the channel rate fs/decim.  This
module builds the geometry and the host tables of that scheme in
numpy, exactly as the JAX class does (the tests require bit-equal
tables); the device work lives in dsp/cuda_kernels.py and
dsp/backhalf.py.

Only what the fused receive path reads is built: the quantized
row-gather extraction (rolled H1 per bin shift d), the band synthesis
tables and the per-block phase-cycle step.  The XLA-only formulations
of the JAX class (four-step FFT tables, einsum synthesis, the Pallas
DMA extraction) have no counterpart here.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from tetraear_tpu.dsp import design


def choose_decim(fs: float) -> int:
    """Power-of-two decimation keeping the channel rate in [72k, 160k],
    preferring the rate whose 72 kHz resample ratio has the smallest
    polyphase interpolation factor; fs = 72 kHz * 2^m gives L = 1."""
    best, best_l = None, 1 << 30
    d = 1
    while fs / d > 160_000.0:
        d *= 2
    while fs / d >= 72_000.0:
        rate = fs / d
        if abs(rate - round(rate)) < 1e-6:
            frac = Fraction(72_000, int(round(rate)))
            if frac.numerator <= best_l:
                best, best_l = d, frac.numerator
        d *= 2
    if best is None or best_l > 64:
        raise ValueError(
            f"no power-of-two channel rate from fs={fs:g} gives a "
            f"tractable 72 kHz resample ratio (best L={best_l}); use an "
            f"fs of the form 72000*2^m (e.g. 2.304/4.608/9.216/36.864 "
            f"MHz) or a standard SDR rate like 2.4 Msps")
    return best


def choose_nfft(fs: float) -> int:
    """Smallest power of two covering ~0.1 s of input."""
    return 2 ** int(math.ceil(math.log2(max(fs * 0.1, 1024.0))))


class FFTChannelizer:
    """Streaming overlap-save channelizer fs -> fs/decim per carrier."""

    def __init__(self, fs: float, freqs_hz, block_len: int | None = None,
                 back_granularity: int | None = None, fold_fir=None,
                 nfft: int | None = None):
        self.fs = float(fs)
        self.freqs_hz = np.asarray(freqs_hz, np.float64)
        self.decim = choose_decim(self.fs)
        self.nfft = choose_nfft(self.fs) if nfft is None else int(nfft)
        self.n_band = self.nfft // self.decim
        self.out_rate = self.fs / self.decim

        h1 = design.kaiser_lowpass(
            13_000.0, self.out_rate / 2.0 - 14_000.0, self.fs,
            atten_db=60.0)
        self.h1_len = len(h1)
        # output-rate FIR (the RRC matched filter) folded into the band
        # spectrum; the overlap also covers its memory
        self.fold_fir = None if fold_fir is None else np.asarray(
            fold_fir, np.float64)
        fir_mem = (0 if self.fold_fir is None
                   else (len(self.fold_fir) - 1) * self.decim)

        # two-pass FFT geometry nfft = n1 * n2 (dsp/cuda_kernels.fft2p)
        lg2 = int(math.log2(self.nfft))
        self.fft2p_n1 = 1 << ((lg2 + 1) // 2)
        self.fft2p_n2 = self.nfft // self.fft2p_n1
        self.fft2p_ok = (self.fft2p_n1 % 128 == 0
                         and self.fft2p_n2 % 128 == 0
                         and self.n_band % 128 == 0)
        if self.fft2p_ok:
            self.fft2p_wrap = -(-self.n_band // self.fft2p_n2)

        # overlap >= filter memory; block = nfft - overlap divides by
        # decim * back_granularity
        g = int(back_granularity) if back_granularity else 1
        quantum = self.decim * g
        overlap = self.nfft % quantum
        while overlap < max(self.h1_len + fir_mem, self.decim):
            overlap += quantum
        # spliced fft2p input: round the overlap up until overlap/n1 is
        # a multiple of 8, so the carried tail is whole rows of the
        # (n2, n1) window (the JAX kernel's sublane alignment; the CUDA
        # pass 1 takes tail rows and block rows as two inputs)
        self.fft2p_splice = False
        if self.fft2p_ok:
            align = 8 * self.fft2p_n1
            cand, steps = overlap, 0
            while (cand % align and cand * 2 < self.nfft
                   and steps <= align // math.gcd(quantum, align) + 1):
                cand += quantum
                steps += 1
            if cand % align == 0 and cand * 2 < self.nfft:
                overlap = cand
                self.fft2p_splice = True
        self.overlap = overlap
        if overlap * 2 >= self.nfft:
            raise ValueError(
                f"overlap {overlap} >= nfft/2 ({self.nfft}): filter "
                f"memory too large for the transform at fs={fs:g}")
        self.block_len = self.nfft - overlap
        if block_len is not None and block_len != self.block_len:
            raise ValueError(
                f"fft frontend requires block_len={self.block_len} at "
                f"fs={fs:g} (got {block_len})")
        self.drop = self.overlap // self.decim
        self.n_out = self.block_len // self.decim

        bin_hz = self.fs / self.nfft
        self.k_c = np.round(self.freqs_hz / bin_hz).astype(np.int64)
        self.residual_hz = self.freqs_hz - self.k_c * bin_hz

        H1 = np.fft.fft(h1, self.nfft)
        firF = (np.ones(self.n_band) if self.fold_fir is None
                else np.fft.fft(self.fold_fir, self.n_band))
        j = np.arange(self.n_band)
        j_signed = np.where(j < self.n_band // 2, j, j - self.n_band)
        self.h1_band = (H1[j_signed % self.nfft]
                        * firF[j % self.n_band]).astype(np.complex64)
        # per-carrier band start in the wrap-extended spectrum
        self.band_start = ((self.k_c - self.n_band // 2)
                           % self.nfft).astype(np.int32)
        self.aligned = bool(np.all(self.band_start % 128 == 0)
                            and self.n_band % 128 == 0)
        # QUANTIZED row gather: extract from the 128-aligned start below
        # the band and repair the d = start - aligned bin shift with the
        # channel filter rolled by d (128 rolls) and a per-d ramp
        self.quantized = bool(not self.aligned and self.n_band % 128 == 0)
        if self.aligned or self.quantized:
            start_al = (self.band_start // 128) * 128
        if self.quantized:
            self.d_shift = (self.band_start - start_al).astype(np.int32)
            nb = self.n_band
            j = np.arange(nb)
            j_signed = np.where(j < nb // 2, j, j - nb)
            d_col = np.arange(128)[:, None]
            rel = j_signed[None, :] - d_col                  # (128, nb)
            h1_roll = H1[rel % self.nfft] * firF[rel % nb]
            h1_roll[rel < -(nb // 2)] = 0.0                  # missing bins
            self.h1_roll = h1_roll.astype(np.complex64)
            ang = (2.0 * np.pi * d_col * self.decim
                   * (self.drop + np.arange(self.n_out))[None, :]
                   / self.nfft)
            self.ramp = np.exp(-1j * ang).astype(np.complex64)

        # NATURAL-ORDER synthesis: the filter tables are rolled once by
        # n_band/2 so the band product feeds the inverse transform in
        # natural order; the (-1)^k sign this leaves on the output is
        # folded into the back half's lane ramp (dsp/backhalf.py)
        half = self.n_band // 2
        self.h1_band = np.roll(self.h1_band, -half)
        if self.quantized:
            self.h1_roll = np.roll(self.h1_roll, -half, axis=1)
        self.sign = np.where(
            (self.drop + np.arange(self.n_out)) % 2 == 0,
            np.float32(1.0), np.float32(-1.0))
        if self.quantized:
            self.ramp = (self.ramp
                         * self.sign[None, :]).astype(np.complex64)

        # band synthesis tables (dsp/cuda_kernels.band_synth): rolled H1
        # planes, and the layout-native Cooley-Tukey split n_band = P*128
        # (i = l + 128 r, k = s + P t) that the plain version evaluates
        self.synth_ok = ((self.aligned or self.quantized)
                                 and self.n_band % 128 == 0
                                 and self.n_band >= 256)
        if self.synth_ok:
            pp = self.n_band // 128
            self.synth_rows = pp
            self.row_start = (self.band_start // 128).astype(np.int32)
            if self.quantized:
                h1t = self.h1_roll                     # (128, n_band)
            else:
                h1t = self.h1_band[None, :]            # (1, n_band)
                self.d_shift = np.zeros(len(self.k_c), np.int32)
            h1g = h1t.reshape(h1t.shape[0], pp, 128)
            self.h1_planes = np.stack(
                [h1g.real, h1g.imag]).astype(np.float32)  # (2, D, P, 128)
            rv = np.arange(pp)
            m1 = np.exp(2j * np.pi * np.outer(rv, rv) / pp)
            self.m1c = np.block(
                [[m1.real, m1.imag],
                 [-m1.imag, m1.real]]).astype(np.float32)  # (2P, 2P)
            lv = np.arange(128)
            m2 = np.exp(2j * np.pi * np.outer(lv, lv) / 128)
            self.m2re = m2.real.astype(np.float32)
            self.m2im = m2.imag.astype(np.float32)
            tw = (np.exp(2j * np.pi * np.outer(lv, rv) / self.n_band)
                  / self.n_band)                          # (128 l, P s)
            self.twre = tw.real.astype(np.float32)
            self.twim = tw.imag.astype(np.float32)

        # per-block phase-correction step (k_c * block_len) mod nfft as
        # FLOAT32, mirroring the reference.  Float32 holds every integer
        # only up to 2^24: at nfft = 2^25 (the C=10240 bench geometry)
        # odd steps round to even and the carried cycle counter drifts
        # from the exact integer phase.  Kept as is so the port matches
        # the reference; an exact int64 counter is a deliberate later
        # change for both.
        self.cycle_step = ((self.k_c % self.nfft)
                           * (self.block_len % self.nfft)
                           % self.nfft).astype(np.float32)

    def init_state(self, device="cpu") -> dict:
        """Carried state: the overlap-save tail as (overlap, 2) [re, im]
        pairs and the per-carrier float32 cycle counters."""
        return {
            "tail": torch.zeros((self.overlap, 2), dtype=torch.float32,
                                device=device),
            "cycles": torch.zeros((len(self.k_c),), dtype=torch.float32,
                                  device=device),
        }
