"""Fused receive back half (tetraear_tpu/dsp/backhalf.py).

One block step, wideband IQ -> per-carrier scan verdicts, in three
kernel launches and a little glue:

  * cuda_kernels.fft2p_planes_spliced: the overlap-save wideband FFT
    with the carried tail spliced in;
  * cuda_kernels.band_synth: per-carrier band synthesis and the
    Oerder-Meyr timing phasor;
  * timing glue on (C,) vectors in plain torch: the phasor angle,
    symbol-clock snap, Catmull-Rom weights and valid counts;
  * cuda_kernels.fused_backhalf: phase ramp and rotation, tail splice,
    interpolation, pi/4-DQPSK and the even-position sync + CRC scan.

Banks the fused step cannot serve run the classic chain, one block of
which is ``block_step_scan`` at the end of this module; ``try_fused``
decides between the two.

The carried state keeps the JAX layout ({"bank": {"channelizer",
"timing", "prev_sym"}, "bit_tail"}, complex values as [re, im] pairs),
so dsp/convert.py moves it between the two packages unchanged.

Float32 pitfalls mirrored from the reference (do not "fix" one side):
  * the channelizer ``cycles`` counters are float32 mod nfft, exact only
    below 2^24 (dsp/channelizer.py, cycle_step);
  * the glue uses torch.atan2 / torch.remainder for jnp.angle /
    jnp.mod (both are fmod-based with the sign fix-up) and computes
    every float32 constant (1/decim^2, 1/decim) as the JAX code does: a
    flipped floor(next_t) changes bsel and every later symbol.
"""

from __future__ import annotations

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp import cuda_kernels as ck
from tetraear_tpu_torch.dsp import framescan

TWO_PI = 2.0 * np.pi
TAILBITS = ck.TAILBITS


def try_fused(bank, device=None, fused: bool = True) -> tuple:
    """THE fused-vs-classic decision point.

    Every consumer (api.Pipeline, runtime.stream.DecodeRunner,
    chip_smoke.py) selects its back half HERE; eligibility itself lives
    in FusedRx.__init__.  Eligible banks take ``FusedRx``; all others —
    the conv frontend, rates outside 72 kHz * 2^m, per-carrier AFC —
    take the classic chain (pipeline.CarrierBankDemod._step_impl +
    framescan, ``block_step_scan`` below).  The two are not
    unreconciled twins: the tests pin both to identical symbol
    decisions and verdict planes.  ``fused=False`` forces the classic
    chain (the JAX package's TETRAEAR_NO_FUSED switch); the JAX
    condition on the backend has no counterpart.

    Returns (FusedRx | None, reason string).
    """
    if not fused:
        return None, "fused=False"
    try:
        return FusedRx(bank, device), "fused"
    except ValueError as e:
        return None, str(e)


class FusedRx:
    """Fused block step for a dsp.pipeline.CarrierBankDemod bank.

    ``FusedRx(bank, device)`` holds the bank's tables on ``device``
    (None: the card); the wrappers in cuda_kernels launch the CUDA
    kernels for a CUDA device and run their plain versions on the
    CPU."""

    def __init__(self, bank, device=None):
        ch = getattr(bank, "channelizer", None)
        if ch is None or bank.plan.stages:
            raise ValueError(
                "fused back half needs the fft frontend on a 72 kHz-"
                "family rate (no resample stages)")
        if not ch.synth_ok:
            raise ValueError("fused back half needs the band synthesis "
                             "kernel (kernel_synth=True, row-gatherable "
                             "bands)")
        if getattr(bank, "afc", False):
            raise ValueError("fused back half does not implement the "
                             "closed-loop AFC path")
        if ch.drop % 4 or ch.drop < 8:
            raise ValueError(f"drop={ch.drop} not supported (need "
                             "a multiple of 4, >= 8)")
        if not ch.fft2p_ok:
            raise ValueError("fused back half needs the two-pass FFT "
                             "geometry (128 | n1, n2, n_band)")
        self.device = resolve(device)
        self.bank = bank
        self.ch = ch
        self.k_max = bank.k_max
        self.n_out = ch.n_out
        c = bank.n_carriers
        self.p = ch.n_band // 128
        self.drop = ch.drop
        self.sy = self.p // 4

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.h1_planes = dev(ch.h1_planes)
        self.row_start = dev(ch.row_start)
        self.d_shift = dev(ch.d_shift)
        self.m1c = dev(ch.m1c)
        self.m2re, self.m2im = dev(ch.m2re), dev(ch.m2im)
        self.twre, self.twim = dev(ch.twre), dev(ch.twim)
        self.cycle_step = dev(ch.cycle_step)

        # factored phase-ramp tables from exact integer modular phases:
        # sample k carries exp(-2i pi (d*decim*k mod nfft) / nfft) and
        # the (-1)^k natural-order sign; k = P*t + s factors the table
        # into a row part (t) and a lane part (s, sign folded - P even)
        d = (np.asarray(ch.d_shift, np.int64)
             if ch.quantized else np.zeros(c, np.int64))
        m_int = (d * ch.decim) % ch.nfft
        t_idx = np.arange(128, dtype=np.int64)
        k_row = (m_int[:, None] * (self.p * t_idx)[None, :]) % ch.nfft
        rt0 = np.exp(-2j * np.pi * k_row / ch.nfft).astype(np.complex64)
        self._rt0_re = dev(rt0.real)                          # (C, 128)
        self._rt0_im = dev(rt0.imag)
        s_idx = np.arange(self.p, dtype=np.int64)
        k_lane = (m_int[:, None] * s_idx[None, :]) % ch.nfft
        lane_sign = (-1.0) ** s_idx
        rc = np.exp(-2j * np.pi * k_lane / ch.nfft) * lane_sign[None, :]
        self.rc_planes = dev(np.stack([rc.real, rc.imag], axis=1).astype(
            np.float32).reshape(c, 2, 1, self.p))             # (C,2,1,P)
        self._n_z = TAILBITS + 2 * self.k_max
        self.n_corr = (self._n_z - framescan.SYNC_LEN) // 2 + 1
        self.n_err = (self._n_z - framescan.CRC_SPAN) // 2 + 1

    # -- state ---------------------------------------------------------

    def init_state(self) -> dict:
        return {
            "bank": self.bank.init_state(self.device),
            "bit_tail": torch.zeros((self.bank.n_carriers, 10, 128),
                                    dtype=torch.float32,
                                    device=self.device),
        }

    # -- the fused block step ------------------------------------------

    def fft2p_args(self, x_p: torch.Tensor, cstate: dict) -> tuple:
        """fft2p_planes_spliced's arguments for the block x_p after the
        carried tail: (tail rows, block rows, n1, n2, wrap)."""
        ch = self.ch
        n1, n2 = ch.fft2p_n1, ch.fft2p_n2
        tail_p = cstate["tail"].t().contiguous()             # (2, overlap)
        if ch.fft2p_splice:
            o2 = ch.overlap // n1
            return (tail_p.view(2, o2, n1), x_p.reshape(2, n2 - o2, n1),
                    n1, n2, ch.fft2p_wrap)
        win = torch.cat([tail_p, x_p], dim=1)
        return (win[:, :0].reshape(2, 0, n1), win.reshape(2, n2, n1), n1,
                n2, ch.fft2p_wrap)

    def chan_raw(self, x_p: torch.Tensor, cstate: dict) -> tuple:
        """Channelizer front + band synthesis with the fused phasor.

        x_p: the wideband block as PLANAR (2, block_len) float32.
        Returns (y raw planes (C, 2, 128, P), phasor (C, 1, 128),
        (rot_re, rot_im) (C,) each, new channelizer state)."""
        ch = self.ch
        if tuple(x_p.shape) != (2, ch.block_len):
            raise ValueError(f"chan_raw: block shape {tuple(x_p.shape)}, "
                             f"expected planar (2, {ch.block_len})")
        planes = ck.fft2p_planes_spliced(*self.fft2p_args(x_p, cstate))
        new_tail = x_p[:, x_p.shape[1] - ch.overlap:].t().contiguous()
        y, ph = ck.band_synth(
            planes, self.h1_planes, self.row_start, self.d_shift,
            self.m1c, self.m2re, self.m2im, self.twre, self.twim,
            ch.synth_rows, ch.drop)
        # float32 cycle counters: exact below 2^24 only (see module doc)
        nfft_f = float(ch.nfft)
        ang = cstate["cycles"] * TWO_PI / nfft_f
        rot = (torch.cos(ang), -torch.sin(ang))
        new_cstate = {
            "tail": new_tail,
            "cycles": torch.remainder(cstate["cycles"] + self.cycle_step,
                                      nfft_f),
        }
        return y, ph, rot, new_cstate

    def glue(self, ph: torch.Tensor, rot: tuple, state: dict) -> dict:
        """Timing glue on (C,) vectors (timing.timing_recover): from the
        band phasor and the carried timing state to the back-half
        kernel's per-carrier inputs.  Returns {"rr", "sc", "bsel",
        "dsel", "n_valid", "acc", "next_t"}."""
        ch = self.ch
        bstate = state["bank"]
        tst = bstate["timing"]
        rot_re, rot_im = rot
        scale2 = 1.0 / (ch.decim * ch.decim)                  # a power of 2
        acc_re = 0.5 * tst["acc"][:, 0] + ph[:, 0, 0] * scale2
        acc_im = 0.5 * tst["acc"][:, 1] + ph[:, 0, 1] * scale2
        # jnp.angle -> atan2, jnp.mod -> remainder (module doc)
        mu = torch.remainder(-torch.atan2(acc_im, acc_re) / TWO_PI * 4.0,
                             4.0)
        next_t = tst["next_t"]
        cur_frac = torch.remainder(next_t - 4.0, 4.0)
        delta = torch.remainder(mu - cur_frac + 2.0, 4.0) - 2.0
        next_t = next_t + delta
        next_t = torch.where(next_t < 1.0, next_t + 4.0, next_t)
        i0 = torch.clamp(torch.floor(next_t).to(torch.int32), 1, 4)
        bsel = (i0 - 1).to(torch.int32)
        f = next_t - i0.to(torch.float32)
        f2 = f * f
        f3 = f2 * f
        c0 = 0.5 * (-f3 + 2.0 * f2 - f)
        c1 = 0.5 * (3.0 * f3 - 5.0 * f2 + 2.0)
        c2 = 0.5 * (-3.0 * f3 + 4.0 * f2 + f)
        c3 = 0.5 * (f3 - f2)
        t_max = float(4 + self.n_out - 3)
        t_k = (next_t[:, None]
               + 4.0 * torch.arange(self.k_max, dtype=torch.float32,
                                    device=self.device)[None])
        n_valid = (t_k <= t_max).sum(dim=1, dtype=torch.int32)
        new_next = (next_t + 4.0 * n_valid.to(torch.float32)
                    - float(self.n_out))
        dsel = torch.clamp(n_valid - (self.k_max - 2), 0, 2).to(torch.int32)

        tail = tst["tail"]                                    # (C, 4, 2)
        prev = bstate["prev_sym"]                             # (C, 2)
        sc = torch.stack(
            [c0, c1, c2, c3, n_valid.to(torch.float32),
             prev[:, 0], prev[:, 1],
             tail[:, 0, 0], tail[:, 1, 0], tail[:, 2, 0], tail[:, 3, 0],
             tail[:, 0, 1], tail[:, 1, 1], tail[:, 2, 1], tail[:, 3, 1],
             torch.zeros_like(c0)], dim=1)                    # (C, 16)
        inv_decim = 1.0 / ch.decim                            # a power of 2
        rr_re = (self._rt0_re * rot_re[:, None]
                 - self._rt0_im * rot_im[:, None]) * inv_decim
        rr_im = (self._rt0_re * rot_im[:, None]
                 + self._rt0_im * rot_re[:, None]) * inv_decim
        rr = torch.stack([rr_re, rr_im], dim=1)[:, :, :, None].contiguous()
        return {"rr": rr, "sc": sc, "bsel": bsel, "dsel": dsel,
                "n_valid": n_valid, "acc": torch.stack([acc_re, acc_im], 1),
                "next_t": new_next}

    def backhalf_args(self, y: torch.Tensor, g: dict, state: dict) -> tuple:
        """Positional arguments of cuda_kernels.fused_backhalf."""
        return (y, state["bit_tail"], g["rr"], self.rc_planes, g["sc"],
                g["bsel"], g["dsel"], self.drop, self.k_max)

    def step(self, x_p: torch.Tensor, state: dict) -> tuple:
        """x_p: planar (2, block_len) float32 wideband block.

        Returns (out, new_state); out = {"corr": (C, n_corr) f32,
        "crc_err": (C, n_err) i32, "soft_planes": (C, 2, SY, 128) f32,
        "n_valid": (C,) i32} on the carried-tail z layout."""
        y, ph, rot, new_cstate = self.chan_raw(
            x_p, state["bank"]["channelizer"])
        g = self.glue(ph, rot, state)
        corr, err, soft, bt2, last, misc = ck.fused_backhalf(
            *self.backhalf_args(y, g, state))

        c_n = self.bank.n_carriers
        n_valid = g["n_valid"]
        out = {
            "corr": corr.reshape(c_n, -1)[:, :self.n_corr],
            "crc_err": err.reshape(c_n, -1)[:, :self.n_err],
            "soft_planes": soft,
            "n_valid": n_valid,
        }
        prev_new = torch.where((n_valid > 0)[:, None], misc[:, 0, 0:2],
                               state["bank"]["prev_sym"])
        new_state = {
            "bank": {
                **state["bank"],
                "channelizer": new_cstate,
                "timing": {
                    "tail": last[:, :, 0, self.p - 4:].transpose(1, 2)
                    .contiguous(),
                    "next_t": g["next_t"],
                    "acc": g["acc"],
                },
                "prev_sym": prev_new,
            },
            "bit_tail": bt2,
        }
        return out, new_state

    # -- helpers -------------------------------------------------------

    def soft_symbols(self, soft_planes: torch.Tensor) -> torch.Tensor:
        """(C, 2, SY, 128) kernel planes -> (C, k_max, 2) soft bits in
        symbol order (flat symbol i = SY*t' + u)."""
        c_n = soft_planes.shape[0]
        flat = soft_planes.transpose(2, 3).reshape(c_n, 2, 128 * self.sy)
        return flat[:, :, :self.k_max].transpose(1, 2)


def interleave_bits(hard: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(C, K) uint8 symbols + validity -> (C, 2K) uint8 bits, msb first,
    invalid slots zero."""
    h = torch.where(valid, hard, torch.zeros_like(hard)).to(torch.uint8)
    return torch.stack([h >> 1, h & 1], dim=2).reshape(h.shape[0], -1)


def slide_tail(z: torch.Tensor, n_c: torch.Tensor, k: int,
               t2: int = TAILBITS) -> torch.Tensor:
    """Next carried bit tail: the last ``t2`` VALID bits of the assembled
    row z = [tail ++ block bits].  The per-row start is 2 n_c, which
    timing_recover bounds to {2K-4, 2K-2, 2K}: three static slices and
    a select chain, as in the reference."""
    k2 = 2 * k
    tail2 = z[:, k2 - 4:k2 - 4 + t2]
    for d in (1, 2):
        cand = z[:, k2 - 4 + 2 * d:k2 - 4 + 2 * d + t2]
        tail2 = torch.where((n_c == k - 2 + d)[:, None], cand, tail2)
    return tail2


def classic_step_scan(bank, x_r, state, bit_tail_bits,
                      kernel_scan: bool = True):
    """Reference formulation of the fused block step:
    bank._step_impl + interleave + carried-tail concat +
    frame_scan_packed_even + the tail slide.  Used by the exactness
    tests.

    bit_tail_bits: (C, 1200) uint8.  Returns (scan dict, new bank
    state, new tail bits, n_valid).
    """
    scan, st2, tl2, n_c, _out = block_step_scan(bank, x_r, state,
                                                bit_tail_bits, kernel_scan)
    return scan, st2, tl2, n_c


def block_step_scan(bank, x_r, state, bit_tail_bits,
                    kernel_scan: bool = True):
    """classic_step_scan that ALSO returns the demod block outputs: one
    block of the classic chain, demod + device sync/CRC scan with the
    carried bit tail."""
    k = bank.k_max
    out, st2 = bank._step_impl(x_r, state)
    valid = out["valid"]
    n_c = valid.sum(dim=1)
    z = torch.cat([bit_tail_bits, interleave_bits(out["hard"], valid)],
                  dim=1)
    scan = framescan.frame_scan_packed_even(z, kernel_scan)
    tl2 = slide_tail(z, n_c, k)
    return scan, st2, tl2, n_c, out
