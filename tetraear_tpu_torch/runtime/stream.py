"""Offline decode runner on the fused receive path
(tetraear_tpu/runtime/stream.py).

``DecodeRunner`` turns an IQ capture into CRC-checked frames: S blocks
per batch go through ``FusedRx.step`` on the device, each block's scan
planes compact to sparse hit keys (framescan.sparse_hits) and its
symbols to 2-bit packed bytes, and only those cross to the host, where
the shared frame layer selects and decodes in O(hits).

The JAX runner chains S blocks in one ``lax.scan`` program; here the
chain is a Python loop of asynchronous launches.  The device-to-host
copies of a batch are queued right behind its launches (into pinned
buffers, with an event), then the next batch is issued, and only then
does the host wait for and parse the previous batch: the card computes
batch k+1 while the host parses batch k.
"""

from __future__ import annotations

import numpy as np
import torch

from tetraear_tpu_torch.dsp import framescan, kernels
from tetraear_tpu_torch.dsp.backhalf import TAILBITS, FusedRx

# hard-symbol transfer packing: 2-bit symbols ride 4 to a byte; the host
# expands via one table lookup.  Validity is contiguous from index 0
# (the timing glue), so the per-carrier valid count replaces the plane.
_SYM_LUT = np.stack([(np.arange(256, dtype=np.uint16) >> (2 * j)) & 3
                     for j in range(4)], axis=1).astype(np.uint8)


def pack_syms(h: torch.Tensor) -> torch.Tensor:
    """(C, K) uint8 symbols in [0, 4) -> (C, ceil(K/4)) uint8,
    little-endian 2-bit lanes within each byte."""
    c, k = h.shape
    hp = torch.nn.functional.pad(h.to(torch.int32), (0, -k % 4))
    hp = hp.reshape(c, -1, 4)
    packed = (hp[..., 0] | (hp[..., 1] << 2) | (hp[..., 2] << 4)
              | (hp[..., 3] << 6))
    return packed.to(torch.uint8)


def unpack_syms(packed: np.ndarray, k: int) -> np.ndarray:
    """Host inverse of pack_syms: (C, ceil(K/4)) -> (C, k) uint8."""
    p = np.asarray(packed)
    return _SYM_LUT[p].reshape(len(p), -1)[:, :k]


def masked_pack(hard: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """pack_syms of the validity-masked symbol block."""
    return pack_syms(torch.where(valid, hard, torch.zeros_like(hard))
                     .to(torch.uint8))


def unpack_block(packed: np.ndarray, n_valid: np.ndarray,
                 k: int) -> tuple:
    """Packed symbols + per-carrier valid counts -> ((C, k) uint8 masked
    symbols, (C, k) bool validity plane, contiguous from index 0)."""
    hard = unpack_syms(packed, k)
    valid = np.arange(k)[None, :] < np.asarray(n_valid)[:, None]
    return hard, valid


def _to_host(tensors: list) -> tuple:
    """Queue device->host copies of ``tensors``; returns (host tensors,
    event to wait on or None).  CPU tensors pass through."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    host = []
    for t in tensors:
        dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        dst.copy_(t, non_blocking=True)
        host.append(dst)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


class DecodeRunner:
    """IQ -> CRC-checked frames on the fused path, S blocks per batch.

    ``bank`` is a dsp.pipeline.CarrierBankDemod, ``batch`` the port's
    frame.batch.BatchedFrameDecoder.  Raises ValueError when the bank
    is not fused-eligible (FusedRx)."""

    def __init__(self, bank, batch, blocks_per_dispatch: int = 16,
                 device="cpu"):
        self.bank = bank
        self.batch = batch
        self.s = int(blocks_per_dispatch)
        self.k = bank.k_max
        self.t2 = 2 * batch.T
        if self.t2 != TAILBITS:
            raise ValueError(f"frame tail of {self.t2} bits; the fused "
                             f"back half carries {TAILBITS}")
        if batch.scan_stride != 2:
            raise ValueError("the fused scan is even-position only")
        self.fused = FusedRx(bank, device)
        self.device = self.fused.device
        self._pe_n, self._pc_n = framescan.plane_dims(self.t2 + 2 * self.k)
        self.dispatches = 0
        # the device tail replaces the host's first-symbol drop
        batch._first = False

    def _block(self, x_p: torch.Tensor, state: dict) -> tuple:
        """One block: fused step, hard symbols from the soft signs
        (hard msb = d_im < 0 = soft0 > 0), sparse keys."""
        out, state = self.fused.step(x_p, state)
        soft = self.fused.soft_symbols(out["soft_planes"])
        hard = (((soft[:, :, 0] > 0).to(torch.uint8) << 1)
                | (soft[:, :, 1] > 0).to(torch.uint8))
        n_valid = out["n_valid"]
        k_r = torch.arange(self.k, device=self.device)[None, :]
        # the host decodes key positions with these widths
        assert out["corr"].shape[1] == self._pe_n, (out["corr"].shape,
                                                    self._pe_n)
        keys, counts = framescan.sparse_hits(out["corr"], out["crc_err"])
        return (masked_pack(hard, k_r < n_valid[:, None]), n_valid, keys,
                counts), state

    def run(self, iq: np.ndarray, state=None, on_frames=None) -> dict:
        """Decode a capture; returns {"frames": [...], "state": ...}.
        ``on_frames(list)`` fires per block."""
        iq = np.asarray(iq, np.complex64)
        bl = self.bank.block_len
        if state is None:
            state = self.fused.init_state()
        frames_all = []

        def parse(take, host, event):
            if event is not None:
                event.synchronize()
            packed, n_valid, keys, counts = (t.numpy() for t in host)
            for b in range(take):
                hard_b, valid_b = unpack_block(packed[b], n_valid[b],
                                               self.k)
                frames = self.batch.process_scanned_sparse(
                    hard_b, None, valid_b, keys[b], counts[b],
                    self._pe_n, self._pc_n)
                if frames and on_frames:
                    on_frames(frames)
                frames_all.extend(frames)

        pending = None
        pos = 0
        while pos + bl <= len(iq):
            take = min(self.s, (len(iq) - pos) // bl)
            xs = iq[pos:pos + take * bl].reshape(take, bl)
            xs_p = torch.from_numpy(kernels.c2p_np(xs)).to(self.device)
            ys = []
            for b in range(take):
                y, state = self._block(xs_p[b], state)
                ys.append(y)
            host, event = _to_host([torch.stack(col) for col in zip(*ys)])
            self.dispatches += 1
            if pending is not None:
                parse(*pending)
            pending = (take, host, event)
            pos += take * bl
        if pending is not None:
            parse(*pending)
        return {"frames": frames_all, "state": state}
