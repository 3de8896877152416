"""Frame-scan tables, sparse hit keys and the host scan
(tetraear_tpu/dsp/framescan.py).

The even-position sync + burst-CRC scan itself runs inside the fused
back-half kernel (dsp/cuda_kernels.fused_backhalf).  This module holds
what surrounds it:

  * the scan tables: the two training-sequence patterns, the 33-row CRC
    tap kernel over a 230-bit frame window and the CRC of the all-zero
    message (``_PATTERNS``, ``_CRC_KERNEL``, ``_CRC_C0``);
  * ``sparse_hits``: per-carrier top-K compaction of the dense scan
    planes into packed int32 keys, on the device;
  * ``hits_from_keys`` and ``host_scan_rows_even``: the host side in
    numpy, and the exact arithmetic reference of the kernel's scan.

Alignment contract (the JAX module's): for a bit row z, element pe of
``corr`` is the best TS1/TS2 agreement of z[2pe : 2pe+22] divided by
22, and element pe of ``crc_err`` is the forward CRC-16 syndrome weight
of the normal-burst data view of the frame starting at bit 2pe, 99 when
that view is all zeros or all ones.
"""

from __future__ import annotations

import numpy as np
import torch

from tetraear_tpu.frame import burst as burst_mod
from tetraear_tpu.frame import crc as crc_mod

SYNC_LEN = 22
TS_OFFSET_BITS = 216          # sync position - frame start (decoder.py)
FRAME_BITS = 510
DATA_BITS = 216               # burst data view length
CRC_SPAN = 230                # last frame bit the CRC view touches

_PATTERNS = np.stack([burst_mod.SYNC_CONTINUOUS_DOWNLINK,
                      burst_mod.SYNC_DISCONTINUOUS_DOWNLINK]).astype(
                          np.float32)

# burst data view: frame-relative bit offsets (burst.extract_data_bits)
_DATA_OFFSETS = np.concatenate([np.arange(0, 108), np.arange(122, 230)])


def _crc_conv_kernel() -> tuple:
    """(kernel (33, 1, 230) float32, c0 (16,) uint8).

    Rows 0..15: forward-CRC parity taps plus a tap on the received CRC
    bit itself, so (taps . window) mod 2 xor c0 is the syndrome bit.
    Rows 16..31: the same for the reversed payload.  Row 32: ones count
    over the 216-bit data view (degenerate-row rejection)."""
    m, c0 = crc_mod.crc16_matrix(DATA_BITS - 16)       # (16, 200)
    payload_off = _DATA_OFFSETS[:DATA_BITS - 16]       # frame offsets
    recv_off = _DATA_OFFSETS[DATA_BITS - 16:]          # frame 214..229
    k = np.zeros((33, 1, CRC_SPAN), np.float32)
    for i, off in enumerate(payload_off):
        k[0:16, 0, off] = m[:, i]
        k[16:32, 0, payload_off[len(payload_off) - 1 - i]] = m[:, i]
    for j, off in enumerate(recv_off):
        k[j, 0, off] += 1.0
        k[16 + j, 0, off] += 1.0
    for off in _DATA_OFFSETS:
        k[32, 0, off] += 1.0
    return k, c0


_CRC_KERNEL, _CRC_C0 = _crc_conv_kernel()

# agreement(b, pat) = sum b * (2 pat - 1) + (# zeros in pat)
_SYNC_ZEROS = (SYNC_LEN - _PATTERNS.sum(axis=1)).astype(np.float32)


def scan_taps() -> tuple:
    """(taps (19, 1, 230) f32, c0 (16,) f32, sync zeros (2,) f32): the
    forward-only even scan as one conv — rows 0..15 the forward CRC
    syndrome taps, 16 the data-view ones count, 17/18 the two sync
    patterns recast for a {0,1} input.  The reversed-payload check is
    completed on the host per sync hit (frame.burst.parse_burst), as in
    the reference's fleet paths."""
    taps = np.zeros((19, 1, CRC_SPAN), np.float32)
    taps[0:16] = _CRC_KERNEL[0:16]
    taps[16] = _CRC_KERNEL[32]
    taps[17:19, 0, :SYNC_LEN] = 2.0 * _PATTERNS - 1.0
    return taps, _CRC_C0.astype(np.float32), _SYNC_ZEROS


def scan_words() -> np.ndarray:
    """The same scan as bit masks for the CUDA kernel, (139,) uint32:
    [16 rows x 8 words of CRC taps | 8 words of the data-view mask |
    TS1 word | TS2 word | c0 bits word].  Bit b of word k of a row is
    tap 32k + b of the 230-bit window."""
    def words(row):
        bits = np.zeros(256, np.uint64)
        bits[:len(row)] = (np.asarray(row) != 0)
        w = bits.reshape(8, 32) << np.arange(32, dtype=np.uint64)
        return w.sum(axis=1).astype(np.uint32)

    out = [words(_CRC_KERNEL[r, 0]) for r in range(16)]
    out.append(words(_CRC_KERNEL[32, 0]))
    out.append(words(_PATTERNS[0])[:1])
    out.append(words(_PATTERNS[1])[:1])
    out.append(words(_CRC_C0)[:1])
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# Sparse hit extraction: each possible hit packs into ONE int32
#
#     key = (Pe - pe) << 11  |  min(crc_at_sync, 63) << 5  |  n_agree
#
# (ascending position = descending key, so top-K returns the first K
# hits in position order; crc_at_sync is the frame-start CRC verdict
# aligned to the sync position, dense column pe - TS_OFFSET_BITS//2).
# The device threshold backs off the host cascade by ~2e-3, far below
# the 1/22 correlation grid, so every host-selectable position is
# fetched.  Rows with more than K hits are recomputed on the host.
# ---------------------------------------------------------------------------

SPARSE_K = 32                 # default per-carrier hit budget per block
_RANK_SHIFT = 11
_CRC_SHIFT = 5
_CRC_CLAMP = 63


def plane_dims(n_bits: int) -> tuple:
    """(pe_n, pc_n) even-position scan plane widths for an assembled
    bit row of ``n_bits``."""
    return ((n_bits - SYNC_LEN) // 2 + 1, (n_bits - CRC_SPAN) // 2 + 1)


def sparse_hits(corr: torch.Tensor, crc_err: torch.Tensor,
                kh: int = SPARSE_K) -> tuple:
    """Compact a dense even-position scan into per-carrier hit keys.

    corr (C, Pe) float32 and crc_err (C, Pc) int32.  Returns (keys
    (C, kh) int32, descending, 0 = no hit; counts (C,) int32, the total
    above-threshold positions for overflow detection).  Nonzero keys
    are unique within a row (the rank field), so ``torch.topk`` returns
    the same values as ``lax.top_k``."""
    c, pe_n = corr.shape
    if pe_n >= (1 << (31 - _RANK_SHIFT)):
        raise ValueError(f"scan width {pe_n} overflows the rank field")
    dev = corr.device
    n_agree = torch.round(corr * SYNC_LEN).to(torch.int32)
    crcc = torch.clamp(crc_err.to(torch.int32), 0, _CRC_CLAMP)
    off = TS_OFFSET_BITS // 2
    pad_r = max(0, pe_n - off - crcc.shape[1])
    crc_at = torch.nn.functional.pad(
        crcc, (off, pad_r), value=_CRC_CLAMP)[:, :pe_n]
    rowmax = torch.amax(corr, dim=1)
    thr = torch.where(
        rowmax >= 0.8999,
        torch.tensor(0.8999, dtype=torch.float32, device=dev),
        torch.clamp(rowmax - 0.0221, min=0.7499))
    mask = corr >= thr[:, None]
    pe = torch.arange(pe_n, dtype=torch.int32, device=dev)[None, :]
    key = ((pe_n - pe) << _RANK_SHIFT) | (crc_at << _CRC_SHIFT) | n_agree
    key = torch.where(mask, key, torch.zeros_like(key))
    keys = torch.topk(key, kh, dim=1, sorted=True).values
    counts = mask.sum(dim=1, dtype=torch.int32)
    return keys, counts


def hits_from_keys(keys: np.ndarray, counts: np.ndarray, pe_n: int,
                   pc_n: int, bits_rows_fn) -> tuple:
    """Host side of the sparse scan, O(hits) flat form.

    Decodes the packed keys into flat per-hit arrays sorted by (row,
    position): (rows int64, pe int64, corr float32, crc int32).  Rows
    whose hit count overflowed the device budget are recomputed exactly
    from their bits (``bits_rows_fn(row_indices) -> (R, N) uint8``) and
    replaced by that row's full host-cascade selection set."""
    keys = np.asarray(keys)
    counts = np.asarray(counts)
    kh = keys.shape[1]
    r, i = np.nonzero(keys > 0)
    kv = keys[r, i]
    pe = (pe_n - (kv >> _RANK_SHIFT)).astype(np.int64)
    corr = ((kv & ((1 << _CRC_SHIFT) - 1))
            .astype(np.float32) / np.float32(SYNC_LEN))
    crc = ((kv >> _CRC_SHIFT) & _CRC_CLAMP).astype(np.int32)
    r = r.astype(np.int64)
    over = np.flatnonzero(counts > kh)
    if len(over):
        keep = ~np.isin(r, over)
        r, pe, corr, crc = r[keep], pe[keep], corr[keep], crc[keep]
        co, ce = host_scan_rows_even(bits_rows_fn(over))
        off = TS_OFFSET_BITS // 2
        add = [[], [], [], []]
        for k2, ri in enumerate(over):
            row = co[k2][:pe_n].astype(np.float64)
            rm = row.max() if row.size else 0.0
            if rm < 0.75:
                continue
            thr = 0.90 if rm >= 0.90 else max(0.75, rm - 0.02)
            sel = np.flatnonzero(row >= thr)
            qc = sel - off
            inb = (qc >= 0) & (qc < pc_n)
            cv = np.full(len(sel), _CRC_CLAMP, np.int32)
            cv[inb] = np.minimum(ce[k2][qc[inb]], _CRC_CLAMP)
            add[0].append(np.full(len(sel), ri, np.int64))
            add[1].append(sel.astype(np.int64))
            add[2].append(co[k2][:pe_n][sel])
            add[3].append(cv)
        if add[0]:
            r = np.concatenate([r, *add[0]])
            pe = np.concatenate([pe, *add[1]])
            corr = np.concatenate([corr, *add[2]]).astype(np.float32)
            crc = np.concatenate([crc, *add[3]])
            order = np.lexsort((pe, r))
            r, pe, corr, crc = r[order], pe[order], corr[order], crc[order]
    return r, pe, corr, crc


def host_scan_rows_even(bits: np.ndarray) -> tuple:
    """Exact numpy even-position scan of a few rows.

    corr = n_agree/22 at float32, crc_err = forward-orientation syndrome
    weight with degenerate rows pinned to 99.  All sums are exact small
    integers (f64 dot of {0,1} vectors).  The fused back-half kernel's
    scan computes the same verdicts with popcounts."""
    bits = np.asarray(bits, np.uint8)
    rr, n = bits.shape
    pe_n = (n - SYNC_LEN) // 2 + 1
    pc_n = (n - CRC_SPAN) // 2 + 1
    swv = np.lib.stride_tricks.sliding_window_view
    x = bits.astype(np.float64) * 2.0 - 1.0
    win = swv(x, SYNC_LEN, axis=1)[:, ::2][:, :pe_n]       # (R, Pe, 22)
    pat = _PATTERNS.astype(np.float64) * 2.0 - 1.0
    n_agree = ((win @ pat.T).max(axis=2) + SYNC_LEN) / 2.0
    corr = n_agree.astype(np.float32) / np.float32(SYNC_LEN)
    k = _CRC_KERNEL[:, 0, :].astype(np.float64)            # (33, 230)
    winb = swv(bits.astype(np.float64), CRC_SPAN, axis=1)[:, ::2][:, :pc_n]
    out_i = np.rint(winb @ k.T).astype(np.int64)           # (R, Pc, 33)
    syn = (out_i[..., 0:16] & 1) ^ _CRC_C0.astype(np.int64)[None, None, :]
    e_fwd = syn.sum(axis=2)
    ones = out_i[..., 32]
    err = np.where((ones == 0) | (ones == DATA_BITS), 99, e_fwd)
    return corr, err.astype(np.int32)
