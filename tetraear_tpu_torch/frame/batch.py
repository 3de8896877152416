"""Batched frame layer for the port (tetraear_tpu/frame/batch.py).

The host frame layer is shared with the JAX package.  Two methods of
``BatchedFrameDecoder`` reach JAX there: ``__init__`` builds a JAX
frame-scan kernel, and ``process_scanned_sparse`` imports the JAX
framescan module for ``hits_from_keys``.  This subclass replaces just
those two.  The port's scan runs inside the fused back-half kernel, so
no scan kernel is built here (the standalone ``process`` path is not
ported).

Decryption is NOT deferred: an encrypted frame is decrypted on the host
by ``TetraDecoder`` itself (crypto/tea.py).  The deferred batch
decryption of the JAX package is a device key search.
"""

from __future__ import annotations

import numpy as np

from tetraear_tpu.frame import batch as jax_batch
from tetraear_tpu.frame.decoder import TetraDecoder
from tetraear_tpu_torch.dsp import framescan


class BatchedFrameDecoder(jax_batch.BatchedFrameDecoder):
    """Carrier-batched O(hits) selection + per-hit frame decode."""

    def __init__(self, n_carriers: int, decoders: list | None = None,
                 key_manager=None, auto_decrypt: bool = True,
                 tail_syms: int = jax_batch.TAIL_SYMS):
        self.n_carriers = n_carriers
        self.decoders = decoders if decoders is not None else [
            TetraDecoder(key_manager=key_manager, auto_decrypt=auto_decrypt)
            for _ in range(n_carriers)]
        self.T = int(tail_syms)
        # even-position scan: frame starts are symbol-aligned, device
        # array index pe is bit position 2 pe
        self.scan_stride = 2
        c = n_carriers
        self._tail_hard = np.zeros((c, self.T), np.uint8)
        self._tail_soft = np.zeros((c, self.T, 2), np.float32)
        self._tail_valid = np.zeros(c, np.int64)
        self._sym_base = np.full(c, -self.T, np.int64)
        self._emitted_until = np.zeros(c, np.int64)
        self._first = True

    def process_scanned_sparse(self, hard, soft, valid, keys, counts,
                               pe_n: int, pc_n: int) -> list:
        """Assemble, decode the device's sparse hit keys to flat per-hit
        arrays (exact host rescan of overflowed rows), select in
        O(hits)."""
        syms, softs, n_total, vstart = self.assemble(hard, soft, valid)

        def bits_rows(rows):
            s = syms[rows]
            b = np.empty((len(rows), 2 * s.shape[1]), np.uint8)
            b[:, 0::2] = (s >> 1) & 1
            b[:, 1::2] = s & 1
            return b

        rows_h, pe_h, corr_h, crc_h = framescan.hits_from_keys(
            keys, counts, pe_n, pc_n, bits_rows)
        frames = self.select_and_decode_hits(
            syms, softs, n_total, vstart, rows_h, pe_h, corr_h, crc_h)
        self._sym_base = self._sym_base + (n_total - self.T)
        return frames
