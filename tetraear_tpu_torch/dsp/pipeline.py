"""Carrier-bank demodulator: the block step + host assembly
(tetraear_tpu/dsp/pipeline.py).

One step takes a wideband IQ block (shared by all carriers or
per-carrier) and the carried state tree, and produces masked symbol/soft
outputs for every carrier at once:

  (C, N) IQ -> NCO mix -> polyphase resample -> RRC -> timing -> DQPSK
  -> hard symbols (C, K), soft bits (C, K, 2), valid mask (C, K)

with the FFT channelizer (dsp/channelizer.py) in place of the NCO and
the first stages for ``frontend="fft"``.  All shapes are static;
per-carrier state (NCO cycles, filter halos, timing phase, previous
symbol, AFC registers) is a tree threaded through the step in the JAX
layout (complex values as float32 [re, im] pairs), so dsp/convert.py
carries it between the two packages unchanged.

This is the classic chain: every configuration the fused back half
(dsp/backhalf.FusedRx) rejects runs it — the conv frontend, rates
outside 72 kHz * 2^m, per-carrier AFC.  Its kernels are the band
synthesis or extraction inside ``FFTChannelizer.step``; the rest is
plain torch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp import channelizer as chan_mod
from tetraear_tpu_torch.dsp import design, kernels, timing


def plan_granularity(plan: design.ResamplePlan, sps: int) -> int:
    """Input samples a block must divide by: every stage's M, and an
    output count dividing by sps AND by every stage's L (the
    phase-interleave reshape in kernels.stage_apply needs it)."""
    n = 1
    for st in plan.stages:
        n = n * st.down // math.gcd(n, st.down)
    up = down = 1
    for st in plan.stages:
        up *= st.up
        down *= st.down
    lcm_l = 1
    for st in plan.stages:
        lcm_l = lcm_l * st.up // math.gcd(lcm_l, st.up)
    need = sps * lcm_l // math.gcd(sps, lcm_l)
    k = 1
    while (k * n * up) % (down * need) != 0:
        k += 1
    return k * n


class CarrierBankDemod:
    """Demodulate C TETRA carriers from a shared wideband capture.

    Args:
        fs: input sample rate (integer Hz).
        freqs_hz: (C,) carrier offsets from the capture centre (integer Hz).
        block_len: input samples per step; must be a multiple of the plan
            granularity (``self.granularity``).  The fft frontend fixes
            it (nfft - overlap) and only checks a given value.
        frontend: "conv" (NCO + polyphase stages) or "fft" (wideband FFT
            channelizer).
        afc: closed-loop per-carrier frequency tracking (d^4 detector).
        nfft: optional transform size override (fft frontend).
        kernel_synth, kernel_extract: the channelizer's formulation
            switches (FFTChannelizer).
    """

    def __init__(self, fs: float, freqs_hz, block_len: int | None = None,
                 sps: int = design.SPS, frontend: str = "conv",
                 afc: bool = False, afc_gain: float = 0.3,
                 nfft: int | None = None, kernel_synth: bool = True,
                 kernel_extract: bool = False):
        self.fs = float(fs)
        self.freqs_hz = np.atleast_1d(np.asarray(freqs_hz, dtype=np.float64))
        self.n_carriers = len(self.freqs_hz)
        self.sps = sps
        self.frontend = frontend
        self.afc = afc
        self.afc_gain = float(afc_gain)
        self.rrc = design.rrc_taps(sps=sps).astype(np.float32)
        self._nco_dev: dict = {}
        if frontend == "fft":
            # wideband FFT channelizer to fs/2^m, then a rational clean-up
            # stage to 72 kHz per carrier (dsp/channelizer.py); the
            # channelizer owns the block size (pow2 nfft minus overlap)
            decim = chan_mod.choose_decim(self.fs)
            self.plan = design.build_resample_plan(
                self.fs / decim, design.SYMBOL_RATE * sps)
            # fold the RRC matched filter into the final resample stage
            # (noble identity): one fewer pass over every carrier stream.
            # With NO resample stage (72 kHz-family fs: channel rate ==
            # symbol-grid rate) fold it into the channelizer's band
            # spectrum instead.
            self._rrc_folded = True
            chan_fir = None
            if self.plan.stages:
                stages = list(self.plan.stages)
                stages[-1] = design.fold_fir_into_stage(stages[-1],
                                                        self.rrc)
                self.plan = design.ResamplePlan(
                    in_rate=self.plan.in_rate, out_rate=self.plan.out_rate,
                    stages=tuple(stages))
            else:
                chan_fir = self.rrc
            g_back = self._granularity()
            self.channelizer = chan_mod.FFTChannelizer(
                self.fs, self.freqs_hz, block_len,
                back_granularity=g_back, fold_fir=chan_fir, nfft=nfft,
                kernel_synth=kernel_synth, kernel_extract=kernel_extract)
            self.granularity = g_back * self.channelizer.decim
            self.block_len = self.channelizer.block_len
            self.nco = None
        elif frontend == "conv":
            self._rrc_folded = False
            self.channelizer = None
            self.plan = design.build_resample_plan(self.fs,
                                                   design.SYMBOL_RATE * sps)
            self.granularity = self._granularity()
            if block_len is None:
                block_len = 60 * self.granularity
            if block_len % self.granularity:
                raise ValueError(
                    f"block_len {block_len} not a multiple of granularity "
                    f"{self.granularity}")
            self.block_len = block_len
            self.nco = kernels.nco_tables(self.freqs_hz, self.fs, block_len)
        else:
            raise ValueError(f"frontend {frontend!r}: 'conv' or 'fft'")
        self.n_out72 = self._out_len(
            self.block_len if frontend != "fft"
            else self.block_len // self.channelizer.decim)
        self.k_max = self.n_out72 // sps + 1

    # -- shape bookkeeping -------------------------------------------------

    def _granularity(self) -> int:
        return plan_granularity(self.plan, self.sps)

    def _out_len(self, n_in: int) -> int:
        n = n_in
        for st in self.plan.stages:
            n = n * st.up // st.down
        return n

    # -- state -------------------------------------------------------------

    def init_state(self, device=None) -> dict:
        """Initial carried state, complex quantities as float32 [re, im]
        pairs (the JAX layout)."""
        dev = resolve(device)
        c = self.n_carriers

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        extra = ({"channelizer": self.channelizer.init_state(dev)}
                 if self.channelizer is not None else {})
        return {
            **extra,
            "nco_cycles": zeros(c),
            "stage_hist": [zeros(c, kernels.stage_history_len(st), 2)
                           for st in self.plan.stages],
            "rrc_hist": zeros(c, len(self.rrc) - 1, 2),
            "timing": {
                "tail": zeros(c, timing.TAIL, 2),
                "next_t": torch.full((c,), float(timing.TAIL),
                                     dtype=torch.float32, device=dev),
                "acc": zeros(c, 2),
            },
            "prev_sym": zeros(c, 2),
            "afc_omega": zeros(c),
            "afc_phase": zeros(c),
        }

    # -- the block step ------------------------------------------------------

    def _nco(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._nco_dev:
            self._nco_dev[key] = torch.from_numpy(self.nco[name]).to(device)
        return self._nco_dev[key]

    def _step_impl(self, x_r: torch.Tensor, state: dict) -> tuple:
        """x_r: (N, 2) shared wideband block or (C, N, 2) per-carrier, real
        [re, im] form; state as produced by init_state (real form)."""
        x = kernels.r2c(x_r)
        dev = x.device
        chan_state = {}
        if self.channelizer is not None:
            if x.dim() != 1:
                raise ValueError("fft frontend takes a shared wideband "
                                 "block")
            y, cstate = self.channelizer.step(x, state["channelizer"])
            chan_state = {"channelizer": cstate}
            nco_cycles = state["nco_cycles"]
        else:
            if x.dim() == 1:
                x = x[None, :].expand(self.n_carriers, x.shape[0])
            y, nco_cycles = kernels.nco_mix(
                x, state["nco_cycles"], self._nco("coarse", dev),
                self._nco("fine", dev), self._nco("block_step", dev),
                self.nco["fs"])
        y, stage_hist = kernels.plan_apply(
            self.plan, y, [kernels.r2c(h) for h in state["stage_hist"]])
        if self._rrc_folded:
            rrc_hist = kernels.r2c(state["rrc_hist"])     # unused, carried
        else:
            y, rrc_hist = kernels.fir_apply(self.rrc, y,
                                            kernels.r2c(state["rrc_hist"]))
        tstate_c = {
            "tail": kernels.r2c(state["timing"]["tail"]),
            "next_t": state["timing"]["next_t"],
            "acc": kernels.r2c(state["timing"]["acc"]),
        }
        syms, valid, tstate = timing.timing_recover(y, tstate_c)
        if self.afc:
            # closed-loop per-carrier frequency tracking (d^4 detector)
            syms, afc_phase = timing.apply_freq_correction(
                syms, state["afc_omega"], state["afc_phase"],
                n_valid=valid.sum(dim=1))
            err = timing.afc_error(syms, valid)
            afc_omega = state["afc_omega"] + self.afc_gain * err
        else:
            afc_omega = state["afc_omega"]
            afc_phase = state["afc_phase"]
        hard, soft, prev = timing.dqpsk_demod(
            syms, valid, kernels.r2c(state["prev_sym"]))
        new_state = {
            **chan_state,
            "nco_cycles": nco_cycles,
            "stage_hist": [kernels.c2r(h) for h in stage_hist],
            "rrc_hist": kernels.c2r(rrc_hist),
            "timing": {
                "tail": kernels.c2r(tstate["tail"]),
                "next_t": tstate["next_t"],
                "acc": kernels.c2r(tstate["acc"]),
            },
            "prev_sym": kernels.c2r(prev),
            "afc_omega": afc_omega,
            "afc_phase": afc_phase,
        }
        out = {"hard": hard, "soft": soft, "valid": valid,
               "baseband": kernels.c2r(y)}
        return out, new_state

    def step(self, x, state) -> tuple:
        """One block step; x (N,) or (C, N) complex64 (host side) or its
        float32 [re, im] form.  Runs on the device the state lies on."""
        x = np.asarray(x)
        if np.iscomplexobj(x):
            x_r = kernels.c2r_np(x)
        else:
            x_r = np.asarray(x, np.float32)
        dev = state["prev_sym"].device
        return self._step_impl(torch.from_numpy(x_r).to(dev), state)

    # -- host-side convenience: full-capture demod ---------------------------

    def run(self, iq: np.ndarray, device=None) -> dict:
        """Demod a full capture; returns per-carrier symbol/soft streams.

        Drops the first differential output (it references the zero-filled
        initial prev symbol), matching the oracle's first-block semantics.
        """
        iq = np.asarray(iq, dtype=np.complex64)
        n_blocks = len(iq) // self.block_len
        state = self.init_state(device)
        hards = [[] for _ in range(self.n_carriers)]
        softs = [[] for _ in range(self.n_carriers)]
        power_acc = np.zeros(self.n_carriers, np.float64)
        first = True
        for b in range(n_blocks):
            x = iq[b * self.block_len:(b + 1) * self.block_len]
            out, state = self.step(x, state)
            hard = out["hard"].cpu().numpy()
            soft = out["soft"].cpu().numpy()
            valid = out["valid"].cpu().numpy()
            bb = out["baseband"].cpu().numpy()      # (C, n72, 2)
            power_acc += np.mean(bb[..., 0] ** 2 + bb[..., 1] ** 2, axis=1)
            for ci in range(self.n_carriers):
                v = valid[ci]
                h = hard[ci][v]
                s = soft[ci][v]
                if first:
                    h, s = h[1:], s[1:]
                hards[ci].append(h)
                softs[ci].append(s)
            first = False
        return {
            "symbols": [np.concatenate(h) if h else np.zeros(0, np.uint8)
                        for h in hards],
            "soft_bits": [np.concatenate(s) if s else np.zeros((0, 2),
                                                              np.float32)
                          for s in softs],
            # mean per-carrier channelized band power (linear); real signal
            # power, unlike anything derivable from unit-normalized softs
            "power": power_acc / max(n_blocks, 1),
        }


def symbols_to_bits(symbols: np.ndarray) -> np.ndarray:
    s = np.asarray(symbols, dtype=np.uint8)
    bits = np.empty(2 * len(s), dtype=np.uint8)
    bits[0::2] = (s >> 1) & 1
    bits[1::2] = s & 1
    return bits
