"""Overlap-save FFT channelizer geometry and tables
(tetraear_tpu/dsp/channelizer.py).

One forward FFT of the wideband block serves every carrier: each
carrier's band of n_band bins is gathered, multiplied by the channel
filter and inverse-transformed at the channel rate fs/decim.  This
module builds the geometry and the host tables of that scheme in
numpy, exactly as the JAX class does (the tests require bit-equal
tables).

Two block steps read them.  The fused receive path (dsp/backhalf.py
``FusedRx``) runs the spliced two-pass FFT kernel and the band synthesis
with the timing phasor.  The classic step (``FFTChannelizer.step``)
serves every other fft-frontend configuration: a ``torch.fft.fft`` of
the overlap-save window (the JAX step's wideband transform is XLA's,
not a Pallas kernel), then one of

  * ``cuda_kernels.band_synth_y``: extraction, filter and inverse
    transform fused, whenever the bands are row-gatherable (aligned or
    quantized starts) and ``kernel_synth`` is on (the default);
  * ``cuda_kernels.band_extract_rows`` (aligned starts, with
    ``kernel_extract``) or the row gather, then filter and ``_synth``;
  * ``cuda_kernels.band_extract`` when n_band is no multiple of 128 and
    every band is an arbitrary slice of the spectrum.

The two extraction kernels take an ``ExtractPlan`` made here from the
host starts: checked once, its schedule uploaded once a device.

``kernel_synth`` and ``kernel_extract`` are the JAX package's
TETRAEAR_NO_PALLAS_SYNTH / TETRAEAR_PALLAS_EXTRACT switches as keyword
arguments.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp import cuda_kernels as ck
from tetraear_tpu_torch.dsp import design


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


def synth_tables(n_band: int) -> tuple:
    """(m1c (2P, 2P), m2re, m2im (128, 128), twre, twim (128, P)) float32:
    the Cooley-Tukey split n_band = P * 128 (i = l + 128 r, k = s + P t)
    of the inverse n_band-point DFT scaled by 1 / n_band, which the plain
    version of ``cuda_kernels.band_synth`` evaluates as three matmuls."""
    pp = n_band // 128
    rv = np.arange(pp)
    m1 = np.exp(2j * np.pi * np.outer(rv, rv) / pp)
    m1c = np.block([[m1.real, m1.imag],
                    [-m1.imag, m1.real]]).astype(np.float32)   # (2P, 2P)
    lv = np.arange(128)
    m2 = np.exp(2j * np.pi * np.outer(lv, lv) / 128)
    tw = np.exp(2j * np.pi * np.outer(lv, rv) / n_band) / n_band  # (l, s)
    return (m1c, m2.real.astype(np.float32), m2.imag.astype(np.float32),
            tw.real.astype(np.float32), tw.imag.astype(np.float32))


def choose_nfft(fs: float) -> int:
    """Smallest power of two covering ~0.1 s of input."""
    return 2 ** int(math.ceil(math.log2(max(fs * 0.1, 1024.0))))


class FFTChannelizer:
    """Streaming overlap-save channelizer fs -> fs/decim per carrier."""

    def __init__(self, fs: float, freqs_hz, block_len: int | None = None,
                 back_granularity: int | None = None, fold_fir=None,
                 nfft: int | None = None, kernel_synth: bool = True,
                 kernel_extract: bool = False):
        self.fs = float(fs)
        self._dev_cache: dict = {}
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
            rows = self.n_band // 128
            start_al = (self.band_start // 128) * 128
            self.row_idx = (start_al[:, None] // 128
                            + np.arange(rows)[None, :]).astype(np.int32)
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

        # matmul synthesis tables of the unfused step (_synth): the
        # layout-native Cooley-Tukey split i = l + 128 r, k = s + P t
        self.mxu_synth = self.n_band % 128 == 0 and self.n_band >= 256
        if self.mxu_synth:
            pp = self.n_band // 128
            self.synth_p = pp
            rv = np.arange(pp)
            self._m1 = np.exp(2j * np.pi * np.outer(rv, rv)
                              / pp).astype(np.complex64)       # [r, s]
            lv = np.arange(128)
            self._tw = (np.exp(2j * np.pi * np.outer(lv, rv)
                               / self.n_band)
                        / self.n_band).astype(np.complex64)    # [l, s]
            self._m2 = np.exp(2j * np.pi * np.outer(lv, lv)
                              / 128).astype(np.complex64)      # [t, l]
        # row-copy extraction kernel (cuda_kernels.band_extract_rows):
        # opt-in, aligned starts only
        self.use_extract_rows = bool(self.aligned and kernel_extract
                                     and self.n_band % 1024 == 0)
        if self.use_extract_rows:
            self.row_start = (self.band_start // 128).astype(np.int32)
            self.extract_plan = ck.ExtractPlan(
                "rows", self.row_start, self.n_band // 128,
                (self.nfft + self.n_band) // 128)
        elif not (self.aligned or self.quantized):
            # element extraction (cuda_kernels.band_extract)
            self.extract_plan = ck.ExtractPlan(
                "pairs", self.band_start, self.n_band,
                self.nfft + self.n_band)

        # band synthesis tables (dsp/cuda_kernels.band_synth): rolled H1
        # planes, and the layout-native Cooley-Tukey split n_band = P*128
        # (i = l + 128 r, k = s + P t) that the plain version evaluates
        self.synth_ok = bool((self.aligned or self.quantized)
                             and self.n_band % 128 == 0
                             and self.n_band >= 256 and kernel_synth)
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
            (self.m1c, self.m2re, self.m2im, self.twre,
             self.twim) = synth_tables(self.n_band)

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

    def init_state(self, device=None) -> dict:
        """Carried state: the overlap-save tail as (overlap, 2) [re, im]
        pairs and the per-carrier float32 cycle counters."""
        device = resolve(device)
        return {
            "tail": torch.zeros((self.overlap, 2), dtype=torch.float32,
                                device=device),
            "cycles": torch.zeros((len(self.k_c),), dtype=torch.float32,
                                  device=device),
        }

    # -- the classic block step ----------------------------------------

    def _dev(self, name: str, device) -> torch.Tensor:
        """Host table ``name`` as a tensor on ``device`` (cached)."""
        key = (name, str(device))
        if key not in self._dev_cache:
            self._dev_cache[key] = torch.from_numpy(
                np.ascontiguousarray(getattr(self, name))).to(device)
        return self._dev_cache[key]

    def _wideband_fft(self, xx: torch.Tensor) -> torch.Tensor:
        """FFT of the (nfft,) overlap-save window.  The JAX step runs
        XLA's FFT here (four-step above 2^20), not a Pallas kernel, so
        the library transform is its counterpart."""
        return torch.fft.fft(xx)

    def _synth(self, band: torch.Tensor) -> torch.Tensor:
        """(C, n_band) spectra -> (C, n_band) time samples; equals
        ifft(band, dim=1) to float32 rounding.

        Cooley-Tukey n_band = P * 128 with the split i = l + 128 r,
        k = s + P t, as the reference's two complex matmuls:
          T[l, s] = sum_r B[l + 128 r] e^{2 pi j r s / P}
          y[s + P t] = sum_l (T[l, s] tw[l, s]) e^{2 pi j l t / 128}"""
        if not self.mxu_synth:
            return torch.fft.ifft(band, dim=1)
        c = band.shape[0]
        dev = band.device
        br = band.reshape(c, self.synth_p, 128)       # [r, l] = B[l+128r]
        t = torch.einsum("crl,rs->cls", br, self._dev("_m1", dev))
        u = t * self._dev("_tw", dev)[None, :, :]
        y = torch.einsum("tl,cls->cts", self._dev("_m2", dev), u)
        return y.reshape(c, self.n_band)

    def step(self, x: torch.Tensor, state: dict) -> tuple:
        """x: (block_len,) complex64 new wideband samples.

        Returns ((C, n_out) complex64 channel blocks @ out_rate,
        new_state)."""
        from tetraear_tpu_torch.dsp import kernels

        dev = x.device
        c = len(self.k_c)
        tail = kernels.r2c(state["tail"])
        xx = torch.cat([tail, x])                     # (nfft,)
        big = self._wideband_fft(xx)
        # wrap-extend so every band is one contiguous slice
        x_ext = torch.cat([big, big[:self.n_band]])
        if self.synth_ok:
            planes = torch.stack([x_ext.real, x_ext.imag]).reshape(
                2, -1, 128)
            got = ck.band_synth_y(
                planes, self._dev("h1_planes", dev),
                self._dev("row_start", dev), self._dev("d_shift", dev),
                self._dev("m1c", dev), self._dev("m2re", dev),
                self._dev("m2im", dev), self._dev("twre", dev),
                self._dev("twim", dev), self.synth_rows)
            y = torch.complex(got[:, 0], got[:, 1]).reshape(c, self.n_band)
            return self._finish(y, state, xx)
        if self.use_extract_rows:
            planes = torch.stack([x_ext.real, x_ext.imag]).reshape(
                2, -1, 128)
            got = ck.band_extract_rows(planes, self.extract_plan,
                                       self.n_band // 128)
            nat = torch.complex(got[:, 0], got[:, 1]).reshape(
                c, self.n_band)
        elif self.aligned or self.quantized:
            rows = x_ext.reshape(-1, 128)             # (.., 128) lanes
            nat = rows[self._dev("row_idx", dev).long()]
            nat = nat.reshape(c, self.n_band)
        else:
            got = ck.band_extract(torch.view_as_real(x_ext).contiguous(),
                                  self.extract_plan, self.n_band)
            nat = torch.view_as_complex(got)          # (C, n_band) centred
        # natural-order band product (the fftshift lives in the rolled
        # filter tables + the (-1)^k sign on the synthesis output)
        if self.quantized:
            band = nat * self._dev("h1_roll", dev)[
                self._dev("d_shift", dev).long()]
        else:
            band = nat * self._dev("h1_band", dev)[None, :]
        return self._finish(self._synth(band), state, xx)

    def _finish(self, y: torch.Tensor, state: dict, xx: torch.Tensor):
        """Shared step tail: scale, slice, ramp/sign, phase, new state."""
        from tetraear_tpu_torch.dsp import kernels

        dev = y.device
        y = y * float(np.float32(1.0 / self.decim))
        y = y[:, self.drop:self.drop + self.n_out]
        if self.quantized:
            # remove the +d-bin modulation left by the aligned
            # extraction (ramp table carries the (-1)^k sign)
            y = y * self._dev("ramp", dev)[self._dev("d_shift", dev).long()]
        else:
            y = y * self._dev("sign", dev)[None, :]

        # restore global phase continuity; float32 cycle counters, exact
        # below 2^24 only (cycle_step above)
        nfft_f = float(self.nfft)
        ang = state["cycles"] * float(np.float32(2.0 * np.pi)) / nfft_f
        rot = torch.complex(torch.cos(ang), -torch.sin(ang))
        y = y * rot[:, None]
        new_cycles = torch.remainder(
            state["cycles"] + self._dev("cycle_step", dev), nfft_f)
        new_state = {
            "tail": kernels.c2r(xx[xx.shape[0] - self.overlap:]),
            "cycles": new_cycles,
        }
        return y, new_state
