"""Carrier bank on the FFT frontend (tetraear_tpu/dsp/pipeline.py).

The port's bank is the fused-eligible slice of the JAX
``CarrierBankDemod``: the wideband FFT channelizer on a 72 kHz * 2^m
rate, where the channel rate IS the 4-samples-per-symbol grid, so there
are no resample stages and the RRC matched filter folds into the
channelizer's band spectrum.  Every other configuration raises
``ValueError`` (the classic chain is not ported yet).
"""

from __future__ import annotations

import numpy as np
import torch

from tetraear_tpu.dsp import design
from tetraear_tpu_torch.dsp import channelizer as chan_mod
from tetraear_tpu_torch.dsp import timing

NO_STAGES_MSG = ("fused back half needs the fft frontend on a 72 kHz-"
                 "family rate (no resample stages)")


class CarrierBankDemod:
    """C TETRA carriers from one shared wideband capture (fft frontend).

    Args:
        fs: input sample rate (Hz), of the form 72 kHz * 2^m.
        freqs_hz: (C,) carrier offsets from the capture centre (Hz).
        block_len: optional check; the channelizer fixes it.
        frontend: must be "fft".
        afc: must be False (the fused path has no AFC loop).
        nfft: optional transform size override.
    """

    def __init__(self, fs: float, freqs_hz, block_len: int | None = None,
                 sps: int = design.SPS, frontend: str = "fft",
                 afc: bool = False, nfft: int | None = None):
        self.fs = float(fs)
        self.freqs_hz = np.atleast_1d(np.asarray(freqs_hz, dtype=np.float64))
        self.n_carriers = len(self.freqs_hz)
        self.sps = sps
        self.frontend = frontend
        self.afc = afc
        if frontend != "fft":
            raise ValueError(NO_STAGES_MSG)
        self.rrc = design.rrc_taps(sps=sps).astype(np.float32)
        decim = chan_mod.choose_decim(self.fs)
        self.plan = design.build_resample_plan(
            self.fs / decim, design.SYMBOL_RATE * sps)
        if self.plan.stages:
            raise ValueError(NO_STAGES_MSG)
        # no resample stage: the RRC folds into the channelizer's band
        # spectrum, and the back half's block quantum is one symbol
        # (CarrierBankDemod._granularity with no stages == sps)
        g_back = sps
        self.channelizer = chan_mod.FFTChannelizer(
            self.fs, self.freqs_hz, block_len, back_granularity=g_back,
            fold_fir=self.rrc, nfft=nfft)
        self.granularity = g_back * self.channelizer.decim
        self.block_len = self.channelizer.block_len
        self.n_out72 = self.block_len // self.channelizer.decim
        self.k_max = self.n_out72 // sps + 1

    def init_state(self, device="cpu") -> dict:
        """Initial carried state, complex quantities as [re, im] pairs
        (the JAX layout; the classic chain's filter histories and AFC
        registers, unused by the fused path, are not carried)."""
        c = self.n_carriers

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return {
            "channelizer": self.channelizer.init_state(device),
            "timing": {
                "tail": zeros(c, timing.TAIL, 2),
                "next_t": torch.full((c,), float(timing.TAIL),
                                     dtype=torch.float32, device=device),
                "acc": zeros(c, 2),
            },
            "prev_sym": zeros(c, 2),
        }
