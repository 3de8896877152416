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

Fleet scaling: the slot axis is embarrassingly parallel (every
``SpeechState`` leaf is slot-major, and a slot's decode has no term from
another slot), so a ``mesh`` argument (runtime/sharding.Mesh) shards the
slots over the devices along one of its axes: each device holds its
contiguous block of slots' state, each shard with active rows makes its
own ``decode_block`` call (one ``acelp_decode`` launch) on its device,
and the active rows' PCM is copied to the host in item order.  There is
no collective.  PCM is bit-identical to the unsharded pool for any mesh
size (integer arithmetic).  A checkpoint holds the shards concatenated
in slot order, the unsharded format; a restore puts each shard's rows
back on its own device.  In a multi-process mesh each process runs every
shard on the device its entry names.
"""

from __future__ import annotations

import logging
from collections import OrderedDict

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.runtime import profiling as prof
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

    def __init__(self, slots: int = 256, device=None, mesh=None,
                 axis: str | None = None):
        """device: where the decoder states live (None: the card).
        mesh: optional runtime.sharding.Mesh; the slots are sharded over
        its ``axis`` (default: its first axis), whose size must divide
        ``slots``, and ``device`` is not used.  On the card the kernel
        library is built here, so a failed build raises before the first
        block."""
        from tetraear_tpu_torch.dsp import cuda_kernels as ck
        self.slots = int(slots)
        if mesh is not None:
            axis = axis or mesh.axis_names[0]
            n_dev = mesh.shape[axis]
            if self.slots % n_dev:
                raise ValueError(
                    f"slots={self.slots} not divisible by mesh axis "
                    f"'{axis}' size {n_dev}")
            self.devices = [resolve(d) for d in mesh.axis_devices(axis)]
        else:
            self.devices = [resolve(device)]
        self.device = self.devices[0]
        per = self.slots // len(self.devices)
        self._bounds = [(i * per, (i + 1) * per)
                        for i in range(len(self.devices))]
        if any(d.type == "cuda" for d in self.devices):
            ck.build()
        # one SpeechState a shard, its block of slots on its device
        self.states = [speech.init_state(per, d) for d in self.devices]
        self._map: OrderedDict[int, int] = OrderedDict()   # carrier->slot
        self._free = list(range(self.slots - 1, -1, -1))

    # -- checkpoint/resume ---------------------------------------------

    def checkpoint_state(self) -> tuple:
        """-> (np leaf list in SpeechState order, every shard's rows in
        slot order; json-able meta) holding every decoder state plus the
        carrier->slot map and LRU order."""
        leaves = [np.concatenate([st[i].cpu().numpy() for st in self.states])
                  for i in range(len(speech.SpeechState._fields))]
        meta = {"map": [[int(c), int(s)] for c, s in self._map.items()],
                "free": [int(s) for s in self._free],
                "slots": self.slots}
        return leaves, meta

    def restore_state(self, leaves, meta: dict) -> None:
        """Restore a checkpoint_state; each shard's block of rows goes back
        onto its own device."""
        if int(meta.get("slots", self.slots)) != self.slots:
            raise ValueError(
                f"checkpoint has {meta.get('slots')} voice slots, pool "
                f"configured with {self.slots}")
        if len(speech.SpeechState._fields) != len(leaves):
            raise ValueError("voice pool state leaf count mismatch")
        self.states = [speech.SpeechState(*(
            torch.from_numpy(np.array(leaf[lo:hi], np.int32)).to(dev)
            for leaf in leaves))
            for (lo, hi), dev in zip(self._bounds, self.devices)]
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
        rows = np.asarray(rows, np.int32)
        prof.count("v2_slots", len(rows))
        prof.count("v2_evictions", len(reset))
        reset = np.asarray(reset, np.int64)
        pcms = []
        with prof.span("v2"):
            for s, ((lo, hi), dev) in enumerate(zip(self._bounds,
                                                    self.devices)):
                mine = (reset >= lo) & (reset < hi)
                if mine.any():
                    mask = torch.zeros(hi - lo, dtype=torch.bool)
                    mask[reset[mine] - lo] = True
                    self.states[s] = speech.reset_rows(self.states[s],
                                                       mask.to(dev))
                idx = np.flatnonzero((rows >= lo) & (rows < hi))
                if not len(idx):
                    continue
                # the shard's rows as a host list (decode_block's ``rows``)
                self.states[s], pcm = speech.decode_block(
                    self.states[s], torch.from_numpy(frames[idx]).to(dev),
                    torch.from_numpy(valid[idx]).to(dev),
                    torch.from_numpy((rows[idx] - lo).astype(np.int32)))
                pcms.append((idx, pcm))
            prof.count("v2_launches", len(pcms))
            pcm = np.zeros((len(items), f_max, speech.L_FRAME), np.int32)
            for idx, got in pcms:
                pcm[idx] = got.cpu().numpy()           # (A, f_max, 240)
        return [
            pcm[i, :p.shape[0]].reshape(-1).astype(np.float32) / 32768.0
            for i, (_, p) in enumerate(items)]
