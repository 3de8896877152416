"""Slot-managed speech-decoder bank on the device
(tetraear_tpu/voice/jspeech_pool.py).

The host C++ decoder keeps one stateful handle a carrier
(api.Pipeline.voice_for) and synthesizes one carrier at a time.
DeviceSpeechPool keeps a fixed bank of decoder states (voice/speech.py
``SpeechState``) on the pipeline's device and synthesizes every active
voice carrier's frames of a block in one ``decode_block`` call (one
``acelp_decode`` launch on the card):

  * a carrier maps to a persistent slot, LRU-evicted when more carriers
    than slots have spoken; an evicted carrier restarts from the
    fresh-decoder state, the same resync a decoder restart gives;
  * a call decodes only the active carriers' slots (the kernel takes the
    list of rows), with the frame count padded to a power of two as the
    reference buckets it;
  * only the active rows' PCM leaves the device.

Audio is sample for sample the host path's (voice/codec.py
decode_params), because the decoder is bit-exact against the C++ one.
The reference's ``mesh`` argument (the slot axis sharded over devices)
is not ported here.
"""

from __future__ import annotations

import logging
from collections import OrderedDict

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.voice import speech

logger = logging.getLogger(__name__)


def _pow2_at_least(n: int, lo: int = 1) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


class DeviceSpeechPool:
    """``synthesize`` maps [(carrier, (n, 138) int16 params)] ->
    [float32 PCM (n*240,)], carrying per-carrier decoder state on the
    device between calls."""

    def __init__(self, slots: int = 256, device=None):
        """device: where the decoder states live (None: the card).  On
        the card the kernel library is built here, so a failed build
        raises before the first block."""
        from tetraear_tpu_torch.dsp import cuda_kernels as ck
        self.slots = int(slots)
        self.device = resolve(device)
        if self.device.type == "cuda":
            ck.build()
        self.state = speech.init_state(self.slots, self.device)
        self._map: OrderedDict[int, int] = OrderedDict()   # carrier->slot
        self._free = list(range(self.slots - 1, -1, -1))

    # -- checkpoint/resume ---------------------------------------------

    def checkpoint_state(self) -> tuple:
        """-> (np leaf list in SpeechState order, json-able meta) holding
        every decoder state plus the carrier->slot map and LRU order."""
        leaves = [leaf.cpu().numpy() for leaf in self.state]
        meta = {"map": [[int(c), int(s)] for c, s in self._map.items()],
                "free": [int(s) for s in self._free],
                "slots": self.slots}
        return leaves, meta

    def restore_state(self, leaves, meta: dict) -> None:
        if int(meta.get("slots", self.slots)) != self.slots:
            raise ValueError(
                f"checkpoint has {meta.get('slots')} voice slots, pool "
                f"configured with {self.slots}")
        if len(self.state) != len(leaves):
            raise ValueError("voice pool state leaf count mismatch")
        self.state = speech.SpeechState(*(
            torch.from_numpy(np.array(leaf, np.int32)).to(self.device)
            for leaf in leaves))
        self._map = OrderedDict((int(c), int(s)) for c, s in meta["map"])
        self._free = [int(s) for s in meta["free"]]

    # -- slot management ---------------------------------------------------

    def _slot_for(self, carrier: int, reset: list) -> int:
        slot = self._map.get(carrier)
        if slot is not None:
            self._map.move_to_end(carrier)
            return slot
        if self._free:
            slot = self._free.pop()
        else:
            old_c, slot = self._map.popitem(last=False)    # LRU evict
            logger.debug("voice slot evict: carrier %s -> %s", old_c,
                         carrier)
            reset.append(slot)
        self._map[carrier] = slot
        self._map.move_to_end(carrier)
        return slot

    # -- synthesis -----------------------------------------------------------

    def synthesize(self, items: list) -> list:
        """items: [(carrier, (n_frames, 138) int16 [BFI + 137 bits])],
        one entry per carrier, frames in stream order.  Returns one
        float32 PCM array per item (Post_Process'd, /32768 scale, same
        as codec.VoiceProcessor.decode_params — near-silence rejection
        is the CALLER's per-slot policy, not applied here)."""
        out: list = [None] * len(items)
        for lo in range(0, len(items), self.slots):
            chunk = items[lo:lo + self.slots]
            for i, pcm in enumerate(self._run(chunk)):
                out[lo + i] = pcm
        return out

    def _run(self, items: list) -> list:
        if not items:
            return []
        reset: list = []
        rows = [self._slot_for(c, reset) for c, _ in items]
        f_max = _pow2_at_least(max(p.shape[0] for _, p in items))

        frames = np.zeros((len(items), f_max, speech.N_BITS), np.int32)
        valid = np.zeros((len(items), f_max), bool)
        for i, (_, p) in enumerate(items):
            frames[i, :p.shape[0]] = p
            valid[i, :p.shape[0]] = True
        if reset:
            mask = torch.zeros(self.slots, dtype=torch.bool)
            mask[reset] = True
            self.state = speech.reset_rows(self.state, mask.to(self.device))
        dev = self.device
        self.state, pcm = speech.decode_block(
            self.state, torch.from_numpy(frames).to(dev),
            torch.from_numpy(valid).to(dev),
            torch.tensor(rows, dtype=torch.int32))     # host slot list
        pcm = pcm.cpu().numpy()                        # (A, f_max, 240)
        return [
            pcm[i, :p.shape[0]].reshape(-1).astype(np.float32) / 32768.0
            for i, (_, p) in enumerate(items)]
