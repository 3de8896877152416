"""Batched frame layer: one pass over all carriers' bit planes per block.

Replaces the per-carrier Python decode loop (round-1 api.py looped
``TetraDecoder.decode`` over every carrier every block — the dominant
host cost at fleet scale; cf. reference decode loop
tetraear/core/decoder.py:835-888, one carrier per process).

Division of labour per SURVEY.md §7 "irregular/host work":

  * dense work on device (dsp.framescan): sync correlation + burst CRC
    at every position for every carrier, one dispatch;
  * host work O(hits): threshold cascade on the returned correlation
    rows (only rows whose max >= 0.75 — idle carriers cost one
    vectorized rowmax), greedy dedup, and per-hit MAC/SDS/crypto
    parsing through TetraDecoder.decode_frame with the device CRC
    verdict as a hint.

Stream continuity: a fixed 600-symbol tail per carrier is re-scanned
each block so frames straddling block edges decode (the reference loses
them, modern.py:1908-1910); duplicates are suppressed by absolute
stream position.  All bookkeeping (tail compaction, stream bases,
valid counts) is vectorized over carriers — no O(C) Python loops.
"""

from __future__ import annotations

import numpy as np

from tetraear_tpu_torch.frame.decoder import (TetraDecoder, sync_cascade,
                                              TS_OFFSET_BITS, FRAME_LENGTH,
                                              SYNC_SKIP)

TAIL_SYMS = 600        # > slot (255) + sync offset (108) + dedup margin


class SoftView:
    """Lazy [tail ++ block] soft-symbol view.

    Materializing the concatenated (C, T+K, 2) float planes is the
    dense-fleet assemble bottleneck on the host, while only O(frames)
    255-sample slices are
    ever read.  ``slice`` returns exactly what
    ``concat([tail, block])[ci, a:a+n]`` would."""

    __slots__ = ("tail", "block", "T")

    def __init__(self, tail: np.ndarray, block: np.ndarray):
        self.tail = tail                     # (C, T, 2) pre-update
        self.block = block                   # (C, K, 2) raw block soft
        self.T = tail.shape[1]

    def slice(self, ci: int, a: int, n: int = 255) -> np.ndarray:
        t = self.T
        if a >= t:
            return self.block[ci, a - t:a - t + n]
        if a + n <= t:
            return self.tail[ci, a:a + n]
        return np.concatenate([self.tail[ci, a:],
                               self.block[ci, :a + n - t]])


def soft_slice(softs, ci: int, a: int, n: int = 255):
    """Per-frame soft-symbol slice from a SoftView, a device-backed
    lazy view (runtime.stream.LazySoftRows — anything with .slice), or
    a plain concatenated (C, W, 2) array; None passes through (soft
    planes not fetched — offline decode with voice disabled)."""
    if softs is None:
        return None
    if hasattr(softs, "slice"):
        return softs.slice(ci, a, n)
    return softs[ci, a:a + n]


def _dedup_positions(pos_seq, ok_seq) -> tuple:
    """Greedy skip-ahead dedup with the CRC rescue (collect_rows
    docstring: a CRC-passing candidate inside the dedup window replaces
    an accepted CRC-failing one).  Returns (positions, oks) — the
    surviving bit positions and their CRC-pass flags (the flags double
    as the decode_frame crc hints).  Single implementation shared by
    the dense-plane and sparse-hit collectors."""
    positions: list = []
    oks: list = []
    last_ok = False
    for pos, ok in zip(pos_seq, ok_seq):
        if positions and pos < positions[-1] + SYNC_SKIP:
            if ok and not last_ok:
                positions[-1] = pos        # rescue the true sync
                oks[-1] = True
                last_ok = True
            continue
        positions.append(int(pos))
        oks.append(bool(ok))
        last_ok = ok
    return positions, oks


def collect_rows(carriers, syms_rows, n_valid_rows, vstart_rows,
                 sym_base_rows, emitted_lookup, scan_stride,
                 corr_rows, crc_rows=None) -> list:
    """Candidate collection on a set of assembled rows labelled with
    GLOBAL carrier ids (the worker side of the row-sharded layer
    receives only its shard's active rows; BatchedFrameDecoder passes
    all of its rows).  Returns [(carrier, start_bit, abs_sym,
    510-bit window)] in (row, position) order.

    VECTORIZED sync cascade: the per-row multi-threshold retry
    (sync_cascade) reduces to a closed-form per-row threshold —
      rowmax >= 0.90        -> 0.90
      0.75 <= rowmax < 0.90 -> max(0.75, rowmax - 0.02)
    (the 0.85/0.80 tiers can never fire: the 0.90 tier's adaptive
    fallback already returns hits whenever rowmax > 0.75).  One
    (active, M) comparison + one nonzero replaces ~8 numpy passes per
    active carrier; equality is pinned by
    test_decoder.py::test_vectorized_cascade_matches.  Thresholds stay
    float64 so the >= comparisons round exactly like the python-float
    path in greedy_positions."""
    cands: list = []
    if not corr_rows.shape[1]:
        return cands
    row_max = corr_rows.max(axis=1)
    active = np.flatnonzero(row_max >= 0.75)
    if not len(active):
        return cands
    all_active = len(active) == len(corr_rows)
    corr_act = corr_rows if all_active else corr_rows[active]
    rm = row_max[active].astype(np.float64)
    thr = np.where(rm >= 0.90, 0.90, np.maximum(0.75, rm - 0.02))
    # f32 compare against a rounded-DOWN threshold (fast path), then
    # re-check the few hits exactly in float64 — identical to the
    # python-float comparison in greedy_positions
    thr32 = np.nextafter(thr.astype(np.float32), np.float32(-np.inf))
    hit_r, hit_c = np.nonzero(corr_act >= thr32[:, None])
    exact = corr_act[hit_r, hit_c].astype(np.float64) >= thr[hit_r]
    hit_r, hit_c = hit_r[exact], hit_c[exact]
    row_bounds = np.searchsorted(hit_r, np.arange(len(active) + 1))
    # one vectorized bit expansion for every active row (the per-row
    # builds were the measured collection hot spot)
    s_act = syms_rows if all_active else syms_rows[active]
    bits_all = np.empty((len(active), 2 * s_act.shape[1]), np.uint8)
    bits_all[:, 0::2] = (s_act >> 1) & 1
    bits_all[:, 1::2] = s_act & 1
    valid_bits = 2 * n_valid_rows
    for ai in range(len(active)):
        lo, hi = row_bounds[ai], row_bounds[ai + 1]
        if lo == hi:
            continue
        ri = active[ai]
        ci = int(carriers[ri])
        emitted = emitted_lookup[ci]
        # greedy skip-ahead dedup in bit units (greedy_positions).
        # DELIBERATE DEVIATION from the reference's first-wins dedup
        # (tetraear/core/decoder.py:231-259): payload bits agreeing
        # with a sync word at >= 20/22 positions fire a spurious hit
        # up to 250 bits BEFORE the true training sequence, and
        # first-wins then drops the whole slot (~1-3% of random-payload
        # slots; the reference silently eats this loss).  The device
        # scan has a burst-CRC verdict at EVERY position, so inside a
        # dedup window a CRC-passing candidate replaces an accepted
        # CRC-failing one (_dedup_positions).  Host paths without
        # dense verdicts (crc_rows=None, e.g. TetraDecoder.decode)
        # keep the exact reference behavior.
        pos_arr = hit_c[lo:hi] * scan_stride
        if crc_rows is None:
            ok_arr = np.zeros(len(pos_arr), bool)
        else:
            # dense CRC verdicts are indexed by frame START bit
            scol = (pos_arr - TS_OFFSET_BITS) // scan_stride
            inb = (scol >= 0) & (scol < crc_rows.shape[1])
            ok_arr = np.zeros(len(pos_arr), bool)
            ok_arr[inb] = crc_rows[ri, scol[inb]] <= 2
        positions, _oks = _dedup_positions(pos_arr, ok_arr)
        for pos in positions:
            start = pos - TS_OFFSET_BITS
            if start < vstart_rows[ri]:
                continue
            if start + FRAME_LENGTH > valid_bits[ri]:
                continue              # straddles the pad; tail rescans it
            abs_sym = sym_base_rows[ri] + start // 2
            if abs_sym < emitted:
                continue              # already emitted from the tail
            cands.append((ci, int(start), int(abs_sym),
                          bits_all[ai, start:start + FRAME_LENGTH]))
    return cands


def collect_hits(carriers, syms_rows, n_valid_rows, vstart_rows,
                 sym_base_rows, emitted_lookup, scan_stride,
                 rows_h, pe_h, corr_h, crc_h) -> tuple:
    """Sparse-hit counterpart of collect_rows: candidates from the flat
    per-hit arrays of framescan.hits_from_keys (sorted by (row, pe))
    instead of dense verdict planes, touching O(hits) data — the dense
    prologue's full-plane rowmax/compare/nonzero passes cost more than
    a block's realtime budget at fleet size.  Returns (cands, hints):
    hints are the per-candidate device CRC verdicts (error count <= 2),
    the same values select_and_decode reads from the dense crc plane.

    Selection equality with collect_rows is by construction: the
    fetched set is a superset of every host-selectable position with
    decision-equivalent corr values (framescan.sparse_hits), the
    cascade arithmetic below is collect_rows' (same float64 closed
    form; its f32-fast-path + f64-recheck equals one f64 compare), and
    the dedup is the shared _dedup_positions.  Pinned end-to-end by
    tests/unit/test_sparse_hits.py."""
    if not len(rows_h):
        return [], []
    _, starts = np.unique(rows_h, return_index=True)
    bounds = np.r_[starts, len(rows_h)]
    corr64 = corr_h.astype(np.float64)
    rmax = np.maximum.reduceat(corr64, starts)
    # fetched values are all >= 0.75 (the device floor sits below the
    # 17/22 grid point), so every row present is active; a defensive
    # sub-0.75 row yields keep=all-False and drops out below
    thr = np.where(rmax >= 0.90, 0.90, np.maximum(0.75, rmax - 0.02))
    keep = corr64 >= np.repeat(thr, np.diff(bounds))
    kidx = np.flatnonzero(keep)
    if not len(kidx):
        return [], []
    # flat kept-hit arrays converted to Python lists ONCE — the per-row
    # numpy slicing/nonzero calls were the hot spot at fleet size; the
    # dedup loop itself is O(kept hits)
    krows = rows_h[kidx]
    kpos = (pe_h[kidx] * scan_stride).tolist()
    kok = (crc_h[kidx] <= 2).tolist()
    gurows, gstarts = np.unique(krows, return_index=True)
    gb = np.r_[gstarts, len(krows)].tolist()
    valid_bits = (2 * n_valid_rows[gurows]).tolist()
    vstart_l = np.asarray(vstart_rows)[gurows].tolist()
    base_l = np.asarray(sym_base_rows)[gurows].tolist()
    carr_l = np.asarray(carriers)[gurows].tolist()
    meta: list = []                       # (ci, start, abs_sym, ok, ri)
    for ui, ri in enumerate(gurows.tolist()):
        lo, hi = gb[ui], gb[ui + 1]
        ci = carr_l[ui]
        emitted = emitted_lookup[ci]
        positions, oks = _dedup_positions(kpos[lo:hi], kok[lo:hi])
        vs, vb, ab = vstart_l[ui], valid_bits[ui], base_l[ui]
        for pos, ok in zip(positions, oks):
            start = pos - TS_OFFSET_BITS
            if start < vs:
                continue
            if start + FRAME_LENGTH > vb:
                continue              # straddles the pad; tail rescans it
            abs_sym = ab + start // 2
            if abs_sym < emitted:
                continue              # already emitted from the tail
            meta.append((int(ci), int(start), int(abs_sym), bool(ok),
                         int(ri)))
    if not meta:
        return [], []
    # one vectorized window build for all candidates: gather the 255
    # symbol slices, then expand to 510-bit windows (frame starts are
    # even, so start//2 is exact and the window is whole symbols)
    rows_c = np.fromiter((m[4] for m in meta), np.int64, len(meta))
    s0 = np.fromiter((m[1] // 2 for m in meta), np.int64, len(meta))
    idx = s0[:, None] + np.arange(FRAME_LENGTH // 2)[None, :]
    wins_s = syms_rows[rows_c[:, None], idx]
    wins = np.empty((len(meta), FRAME_LENGTH), np.uint8)
    wins[:, 0::2] = (wins_s >> 1) & 1
    wins[:, 1::2] = wins_s & 1
    cands = [(m[0], m[1], m[2], wins[i]) for i, m in enumerate(meta)]
    hints = [m[3] for m in meta]
    return cands, hints


def decode_candidates(decoders, emitted_until, cands, hb, hints,
                      syms=None) -> list:
    """Pass 2 of the per-hit frame layer: stateful decode of collected
    candidates in stream order with the dynamic dedup gate.

    ``decoders``: per-carrier TetraDecoder lookup (list or dict);
    ``emitted_until``: per-carrier absolute-symbol dedup watermarks,
    ADVANCED IN PLACE; ``cands``: [(carrier, start_bit, abs_sym,
    window_bits)]; ``hb``: hitparse.HitBatch aligned with cands (or
    None for the pure-Python path); ``hints``: per-candidate device CRC
    hints.  Shared by the in-process layer (BatchedFrameDecoder) and
    the worker side of the carrier-sharded layer (frame.parallel), so
    both decode identically.  Frames are returned WITHOUT soft_symbols
    (the caller holding the soft planes attaches them)."""
    frames_out = []
    for i, (ci, start, abs_sym, win) in enumerate(cands):
        if abs_sym < emitted_until[ci]:
            continue                  # superseded by an earlier emit
        dec = decoders[ci]
        if hb is not None:
            frame = dec.decode_frame(
                win, 0,
                frame_number=int(abs_sym * 2) // FRAME_LENGTH,
                pre=hb.pre(i, crc_hint=hints[i]))
        else:
            frame = dec.decode_frame(
                win, 0,
                (syms[ci, start // 2:start // 2 + 255]
                 if syms is not None else None),
                frame_number=int(abs_sym * 2) // FRAME_LENGTH,
                crc_hint=hints[i])
        if frame is None:
            continue
        emitted_until[ci] = abs_sym + 255
        frame["position"] = start
        frame["carrier"] = int(ci)
        frame["stream_symbol"] = int(abs_sym)
        frames_out.append(frame)
    return frames_out


class BatchedFrameDecoder:
    """Carrier-batched sync/CRC selection + per-hit frame decode."""

    def __init__(self, n_carriers: int, decoders: list | None = None,
                 key_manager=None, auto_decrypt: bool = True,
                 tail_syms: int = TAIL_SYMS, device=None):
        self.n_carriers = n_carriers
        self.decoders = decoders if decoders is not None else [
            TetraDecoder(key_manager=key_manager, auto_decrypt=auto_decrypt)
            for _ in range(n_carriers)]
        if isinstance(self.decoders, list):
            for d in self.decoders:
                # decryption is deferred per block and finished with one
                # device keys x frames search (crypto.batch); lazy maps
                # (frame.parallel._LazyDecoders) set the flag themselves
                d.defer_decrypt = True
        self.T = int(tail_syms)
        # even-position scan: frame starts are symbol-aligned in the
        # assembled rows (all carries/drops move whole symbols), so odd
        # bit positions cannot hold a real frame (framescan
        # .frame_scan_packed_even).  scan_stride maps device array
        # indices to bit positions.  The standalone scan kernel of
        # ``process`` is built at first use, on ``device`` (None: the
        # card); the scanned entry points never need it.  The deferred
        # key search runs on ``device`` too.
        self.scan_stride = 2
        self._device = device
        self._kernel = None
        # the native per-hit parser (frame/csrc) is built with g++ here,
        # before the first parse imports frame.hitparse
        from tetraear_tpu_torch import native
        native.hitparse()
        c = n_carriers
        self._tail_hard = np.zeros((c, self.T), np.uint8)
        self._tail_soft = np.zeros((c, self.T, 2), np.float32)
        self._tail_valid = np.zeros(c, np.int64)     # real symbols in tail
        self._sym_base = np.full(c, -self.T, np.int64)  # abs pos of col 0
        self._emitted_until = np.zeros(c, np.int64)
        self._first = True

    @property
    def kernel(self):
        """The standalone even-position scan (dsp.framescan)."""
        if self._kernel is None:
            from tetraear_tpu_torch.dsp.framescan import FrameScanKernel
            self._kernel = FrameScanKernel(even_only=True,
                                           device=self._device)
            assert self._kernel.stride == self.scan_stride
        return self._kernel

    # -- scan core (device outputs -> selected frames), also used by the
    #    offline runner, which computes corr/crc in its own block step --

    def collect_candidates(self, syms, n_valid, valid_start_bits,
                           corr, crc_err=None) -> list:
        """Pass 1: candidate windows passing the static gates (the
        dynamic dedup gate is re-applied in pass 2 — positions within a
        block can overlap, so emitted_until advances there).  Returns
        [(carrier, start_bit, abs_sym, 510-bit window)].  Shared with
        the carrier-sharded layer (frame.parallel).  ``crc_err``
        enables the CRC-aware dedup rescue (see collect_rows)."""
        return collect_rows(np.arange(len(corr)), syms, n_valid,
                            valid_start_bits, self._sym_base,
                            self._emitted_until, self.scan_stride, corr,
                            crc_rows=crc_err)

    def select_and_decode(self, syms: np.ndarray, softs: np.ndarray,
                          n_valid: np.ndarray, valid_start_bits: np.ndarray,
                          corr: np.ndarray, crc_err: np.ndarray) -> list:
        """syms: (C, W) assembled symbol rows (tail + block, zero-padded);
        softs: (C, W, 2); n_valid: (C,) valid symbols per row counted from
        the row start; valid_start_bits: (C,) first real bit per row (the
        zero pad before the stream head on early blocks); corr/crc_err:
        device scan of the rows' bit planes, with self.scan_stride bits
        between adjacent elements.  Returns decoded frame dicts (with
        carrier/stream metadata)."""
        from tetraear_tpu_torch.frame import hitparse

        frames_out = []
        cands = self.collect_candidates(syms, n_valid, valid_start_bits,
                                        corr, crc_err=crc_err)

        # the native engine parses every candidate's stateless verdicts
        # (burst type, soft CRC, MAC fields) in ONE C call; without the
        # built library hb is None and decode_frame runs its Python path
        hb = (hitparse.parse_windows(
            np.stack([c[3] for c in cands])) if cands else None)
        hints = [bool(crc_err[ci, start // self.scan_stride] <= 2)
                 for ci, start, _a, _w in cands]

        # pass 2: stateful decode in stream order with the dynamic gate
        frames_out.extend(decode_candidates(
            self.decoders, self._emitted_until, cands, hb, hints,
            syms=syms))
        return self._attach_and_decrypt(frames_out, softs)

    def select_and_decode_hits(self, syms, softs, n_valid,
                               valid_start_bits, rows_h, pe_h, corr_h,
                               crc_h) -> list:
        """select_and_decode fed by flat sparse-hit arrays
        (framescan.hits_from_keys) instead of dense planes: the
        collection touches O(hits) data and the crc hints ride in the
        hit records, so no virtual-plane reconstruction happens."""
        from tetraear_tpu_torch.frame import hitparse
        from tetraear_tpu_torch.runtime import profiling as prof

        with prof.span("select"):
            cands, hints = collect_hits(
                np.arange(len(syms)), syms, n_valid, valid_start_bits,
                self._sym_base, self._emitted_until, self.scan_stride,
                rows_h, pe_h, corr_h, crc_h)
        prof.count("candidates", len(cands))
        with prof.span("parse"):
            hb = (hitparse.parse_windows(
                np.stack([c[3] for c in cands])) if cands else None)
        with prof.span("decode"):
            frames_out = decode_candidates(
                self.decoders, self._emitted_until, cands, hb, hints,
                syms=syms)
        return self._attach_and_decrypt(frames_out, softs)

    def _attach_and_decrypt(self, frames_out: list, softs) -> list:
        """Shared epilogue of both selection paths: attach per-frame
        soft-symbol slices, finish deferred decryption with one device
        keys x payloads search for the whole block (crypto.batch)."""
        from tetraear_tpu_torch.runtime import profiling as prof

        with prof.span("soft_rows"):
            if frames_out and hasattr(softs, "prefetch"):
                # device-backed lazy view: batch the row gathers
                softs.prefetch([(f["carrier"], f["position"] // 2)
                                for f in frames_out])
            for frame in frames_out:
                ci, start = frame["carrier"], frame["position"]
                frame["soft_symbols"] = soft_slice(softs, ci, start // 2)
        if any(f.get("decryption_pending") for f in frames_out):
            from tetraear_tpu_torch.crypto.batch import batch_decrypt_frames
            batch_decrypt_frames(self.decoders, frames_out,
                                 device=self._device)
        return frames_out

    # -- per-block entry (standalone device dispatch) ----------------------

    def assemble(self, hard: np.ndarray, soft: np.ndarray,
                 valid: np.ndarray) -> tuple:
        """Concatenate tails with the new block, compact and re-tail.

        hard (C, K) uint8, soft (C, K, 2), valid (C, K) bool with valid
        entries contiguous from index 0.  Returns (syms (C, T+K),
        softs (C, T+K, 2), n_valid (C,), valid_start_bits (C,)) and
        updates the carried tails.
        """
        hard = np.asarray(hard)
        # a device-backed lazy view (anything with .slice, e.g.
        # runtime.stream.LazySoftRows) serves its own tails from the
        # previous block's device plane: pass it through untouched and
        # skip the host soft-tail maintenance entirely
        lazy_soft = soft is not None and hasattr(soft, "slice")
        fetch_soft = soft is not None and not lazy_soft
        if fetch_soft:
            soft = np.asarray(soft)
        valid = np.asarray(valid).astype(bool)
        if self._first:
            # drop the zero-prev differential output (oracle semantics)
            hard, valid = hard[:, 1:], valid[:, 1:]
            if fetch_soft:
                soft = soft[:, 1:]
            self._first = False
        n_c = valid.sum(axis=1)
        t = self.T
        syms = np.concatenate(
            [self._tail_hard, np.where(valid, hard, 0)], axis=1)
        # softs stay a LAZY view: the concatenated float planes were
        # the dense-fleet assemble bottleneck on the host while only
        # O(frames) slices are read.  No masking
        # multiply either — every downstream read (per-frame slices,
        # the tail gather below) is gated to the valid region.
        softs = (soft if lazy_soft
                 else SoftView(self._tail_soft, soft) if fetch_soft
                 else None)
        n_total = t + n_c
        valid_start = 2 * (t - self._tail_valid)        # pre-update state

        # next tail = last T valid symbols, per-row offset = n_c.  The
        # slices are contiguous per row AND the symbol clock yields only
        # a handful of distinct valid counts per block, so group rows by
        # count and do one vectorized slice copy per group (far cheaper
        # than the generic take_along_axis gather at fleet size).
        c = len(n_c)
        new_th = np.empty((c, t), np.uint8)
        new_ts = (np.empty((c, t, 2), np.float32) if fetch_soft
                  else self._tail_soft)
        old_ts = self._tail_soft
        for o in np.unique(n_c):
            o = int(o)
            rows = np.flatnonzero(n_c == o)
            new_th[rows] = syms[rows, o:o + t]
            if not fetch_soft:
                continue
            if o >= t:                       # steady state: block only
                new_ts[rows] = soft[rows, o - t:o]
            else:                            # early blocks: mix old tail
                new_ts[rows, :t - o] = old_ts[rows, o:]
                new_ts[rows, t - o:] = soft[rows, :o]
        self._tail_hard = new_th
        self._tail_soft = new_ts
        self._tail_valid = np.minimum(t, self._tail_valid + n_c)
        return syms, softs, n_total, valid_start

    def process_scanned(self, hard, soft, valid, corr, crc_err) -> list:
        """Full per-block host path when the sync/CRC scan already ran
        on device with the carried bit tail (api.Pipeline's fused
        block step, runtime.stream.DecodeRunner): assemble rows,
        select and decode, advance the stream bases.  Keeps the
        ordering invariant (_sym_base advances AFTER selection, which
        reads it as the current assembly base) in ONE place for every
        consumer."""
        syms, softs, n_total, vstart = self.assemble(hard, soft, valid)
        frames = self.select_and_decode(syms, softs, n_total, vstart,
                                        corr, crc_err)
        self._sym_base = self._sym_base + (n_total - self.T)
        return frames

    def process_scanned_sparse(self, hard, soft, valid, keys, counts,
                               pe_n: int, pc_n: int) -> list:
        """Per-block host path when the device shipped SPARSE hit keys
        (dsp.framescan.sparse_hits) instead of the dense verdict planes
        (runtime.stream.DecodeRunner sparse mode): assemble, decode the
        keys to flat per-hit arrays (exact host recompute for
        budget-overflow rows), then run the O(hits) selection — the
        virtual-plane reconstruction alternative costs full-plane host
        passes per block, more than the block's realtime budget at
        fleet size."""
        from tetraear_tpu_torch.dsp import framescan
        from tetraear_tpu_torch.runtime import profiling as prof

        with prof.span("assemble"):
            syms, softs, n_total, vstart = self.assemble(hard, soft, valid)

        def bits_rows(rows):
            s = syms[rows]
            b = np.empty((len(rows), 2 * s.shape[1]), np.uint8)
            b[:, 0::2] = (s >> 1) & 1
            b[:, 1::2] = s & 1
            return b

        with prof.span("hits"):
            rows_h, pe_h, corr_h, crc_h = framescan.hits_from_keys(
                keys, counts, pe_n, pc_n, bits_rows)
        prof.count("hits", len(rows_h))
        frames = self.select_and_decode_hits(
            syms, softs, n_total, vstart, rows_h, pe_h, corr_h, crc_h)
        self._sym_base = self._sym_base + (n_total - self.T)
        return frames

    def process(self, hard, soft, valid) -> list:
        """One block for all carriers: assemble, device scan, select."""
        syms, softs, n_total, vstart = self.assemble(hard, soft, valid)
        bits = np.empty((syms.shape[0], 2 * syms.shape[1]), np.uint8)
        bits[:, 0::2] = (syms >> 1) & 1
        bits[:, 1::2] = syms & 1
        out = self.kernel.scan(bits)
        frames = self.select_and_decode(syms, softs, n_total, vstart,
                                        out["corr"], out["crc_err"])
        # advance stream bases by the consumed (non-tail) symbols;
        # select_and_decode reads _sym_base as the CURRENT assembly base,
        # so this must happen after selection
        self._sym_base = self._sym_base + (n_total - self.T)
        return frames
