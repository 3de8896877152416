"""Device frame scan: sync correlation + dense burst CRC, sparse hit
keys and the host scan (tetraear_tpu/dsp/framescan.py).

The even-position sync + burst-CRC scan runs in two kernels: inside the
fused back half (dsp/cuda_kernels.fused_backhalf) and standalone
(dsp/cuda_kernels.frame_scan_even, reached through
``frame_scan_packed_even``) for the classic chain and the frame layer's
own dispatch (``FrameScanKernel``).  This module holds what surrounds
them:

  * the scan tables: the two training-sequence patterns, the 33-row CRC
    tap kernel over a 230-bit frame window and the CRC of the all-zero
    message (``_PATTERNS``, ``_CRC_KERNEL``, ``_CRC_C0``);
  * the dense formulations in plain torch: ``frame_scan`` (every bit
    position, forward and reversed CRC), ``frame_scan_packed`` and
    ``frame_scan_packed_mm`` (the same values through the stride-8
    packed conv and its im2col GEMM) and ``frame_scan_packed_even_conv``
    (even positions, forward only) — the oracles of the kernel;
  * ``sparse_hits``: per-carrier top-K compaction of the dense scan
    planes into packed int32 keys, on the device;
  * ``hits_from_keys``, ``unpack_hits_to_planes`` and
    ``host_scan_rows_even``: the host side in numpy, and the exact
    arithmetic reference of the kernel's scan.

The reference casts its conv operands to bfloat16 for its matrix unit;
every value is an integer of at most 237, so the float32 used here
gives the same integers.

Alignment contract (the JAX module's): for a bit row z, element pe of
``corr`` is the best TS1/TS2 agreement of z[2pe : 2pe+22] divided by
22, and element pe of ``crc_err`` is the forward CRC-16 syndrome weight
of the normal-burst data view of the frame starting at bit 2pe, 99 when
that view is all zeros or all ones.
"""

from __future__ import annotations

import numpy as np
import torch

from tetraear_tpu_torch.frame import burst as burst_mod
from tetraear_tpu_torch.frame import crc as crc_mod

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


def sync_corr(bits: torch.Tensor) -> torch.Tensor:
    """(C, N) bits {0,1} -> (C, N-21) best TS1/TS2 agreement ratio."""
    x = bits.to(torch.float32) * 2.0 - 1.0
    pat = torch.from_numpy(_PATTERNS).to(bits.device) * 2.0 - 1.0
    out = torch.nn.functional.conv1d(x[:, None, :], pat[:, None, :])
    best = torch.amax(out, dim=1)
    return (best + SYNC_LEN) / (2.0 * SYNC_LEN)


def _syndromes(out_i: torch.Tensor, rev: bool) -> torch.Tensor:
    """(C, 33, P) exact integer conv outputs -> (C, P) int32 CRC error
    counts (min of forward and reversed with ``rev``), degenerate views
    pinned to 99."""
    dev = out_i.device
    c0_2 = torch.from_numpy(
        np.concatenate([_CRC_C0, _CRC_C0]).astype(np.int32)).to(dev)
    syn = (out_i[:, 0:32] & 1) ^ c0_2[None, :, None]
    err = syn[:, 0:16].sum(dim=1)
    if rev:
        err = torch.minimum(err, syn[:, 16:32].sum(dim=1))
    ones = out_i[:, 32]
    degenerate = (ones == 0) | (ones == DATA_BITS)
    return torch.where(degenerate, 99, err).to(torch.int32)


def crc_err_all(bits: torch.Tensor, rev: bool = True) -> torch.Tensor:
    """(C, N) bits -> (C, N-229) min CRC error count per frame start;
    ``rev=False`` checks the forward orientation only."""
    x = bits.to(torch.float32)
    kern = torch.from_numpy(_CRC_KERNEL).to(bits.device)
    out = torch.nn.functional.conv1d(x[:, None, :], kern)
    return _syndromes(torch.round(out).to(torch.int32), rev)


def frame_scan(bits: torch.Tensor, rev: bool = True) -> dict:
    """Full dense frame scan of a (C, N) bit matrix.

    Returns {"corr": (C, N-21) float32, "crc_err": (C, N-229) int32}.
    """
    return {"corr": sync_corr(bits),
            "crc_err": crc_err_all(bits, rev=rev)}


# ---------------------------------------------------------------------------
# Packed dense scan: the conv strided by 8, each stride phase with its
# own copy of all 35 base rows (2 sync rows recast to the {0,1} plane +
# 33 CRC rows) — 280 output channels, kernel length 237, identical
# arithmetic.  A formulation shaped for a matrix unit; kept in plain
# torch as the oracle of the even-position kernel.
# ---------------------------------------------------------------------------

PACK_STRIDE = 8
_KPACK = CRC_SPAN + PACK_STRIDE - 1                  # 237


def _packed_kernel(step: int = 1, rev: bool = True) -> np.ndarray:
    """(rpp * 8/step, 1, 237) float32 packed taps.

    Channel layout: ch = i * rpp + r for stride phase d = step * i in
    [0,8) and base row r.  With ``rev`` rpp = 35: rows 0..32 the CRC
    rows of _CRC_KERNEL, rows 33..34 the two sync patterns recast for a
    {0,1} input.  With ``rev=False`` rpp = 19: the 16 reversed-payload
    rows are dropped (the host completes that check per sync hit).
    ``step=2`` keeps only the even stride phases."""
    rows = ([*range(0, 33)] if rev
            else [*range(0, 16), 32])            # fwd + ones
    rpp = len(rows) + 2
    base = np.zeros((rpp, _KPACK), np.float32)
    base[0:len(rows), 0:CRC_SPAN] = _CRC_KERNEL[rows, 0, :]
    base[len(rows):rpp, 0:SYNC_LEN] = 2.0 * _PATTERNS - 1.0
    phases = range(0, PACK_STRIDE, step)
    k = np.zeros((rpp * len(phases), 1, _KPACK), np.float32)
    for i, d in enumerate(phases):
        k[i * rpp:(i + 1) * rpp, 0, d:] = base[:, :_KPACK - d]
    return k


_PACKED_KERNEL = _packed_kernel()
_PACKED_KERNEL_EVEN_FWD = _packed_kernel(step=2, rev=False)


def _conv_and_reduce(bits: torch.Tensor, kernel: np.ndarray,
                     nph: int, rpp: int = 35) -> tuple:
    """Shared packed-conv + native-layout reduction.

    kernel: (nph * rpp, 1, 237) stride-phase-packed taps.  Returns
    (corr, err) as (C, J * nph) arrays linear in phase-index space:
    element jj * nph + i is bit position 8 * jj + i * (8 // nph)."""
    c, n = bits.shape
    dev = bits.device
    # 256 zero-pad bits: strided-valid coverage past every real position
    x = torch.nn.functional.pad(bits.to(torch.float32), (0, 256))
    out = torch.nn.functional.conv1d(
        x[:, None, :], torch.from_numpy(kernel).to(dev),
        stride=PACK_STRIDE)                          # (C, nph*rpp, J)
    j = out.shape[2]
    g = out.reshape(c, nph, rpp, j)
    n_crc = rpp - 3                                       # 32 or 16
    zs = torch.from_numpy(_SYNC_ZEROS).to(dev)
    corr_p = torch.amax(g[:, :, rpp - 2:rpp, :]
                        + zs[None, None, :, None], dim=2)  # (C, nph, J)
    crc = g[:, :, 0:n_crc, :]
    par = crc - 2.0 * torch.floor(crc * 0.5)              # v mod 2
    c0f = torch.from_numpy(np.concatenate(
        [_CRC_C0] * (n_crc // 16)).astype(np.float32)).to(dev)
    syn = torch.abs(par - c0f[None, None, :, None])       # xor on {0,1}
    err = syn[:, :, 0:16].sum(dim=2)                      # (C, nph, J)
    ones = g[:, :, rpp - 3, :]
    if n_crc == 32:
        err = torch.minimum(err, syn[:, :, 16:32].sum(dim=2))
    degenerate = (ones == 0.0) | (ones == float(DATA_BITS))
    err = torch.where(degenerate, 99.0, err)
    corr = corr_p.transpose(1, 2).reshape(c, j * nph)
    errl = err.transpose(1, 2).reshape(c, j * nph)
    corr = corr / float(SYNC_LEN)
    return corr, errl


def frame_scan_packed(bits: torch.Tensor) -> dict:
    """Dense frame scan via the packed 280-channel conv.  Same contract
    and values as ``frame_scan``."""
    corr, errl = _conv_and_reduce(bits, _PACKED_KERNEL, PACK_STRIDE)
    n = bits.shape[1]
    return {"corr": corr[:, :n - SYNC_LEN + 1],
            "crc_err": errl[:, :n - CRC_SPAN + 1].to(torch.int32)}


def frame_scan_packed_even(bits: torch.Tensor,
                           kernel_scan: bool = True) -> dict:
    """Even-position dense frame scan of (C, N) uint8 {0,1} bit rows.

    Returns {"corr": (C, (N-22)//2 + 1) float32,
             "crc_err": (C, (N-230)//2 + 1) int32} where element pe
    describes bit position p = 2 * pe; crc_err is the forward-only
    verdict (the host completes the reversed check per sync hit).

    Routes to the hand-written kernel (cuda_kernels.frame_scan_even;
    its plain version for CPU tensors) unless ``kernel_scan`` is False
    (the JAX package's TETRAEAR_NO_PALLAS_SCAN switch), which takes the
    conv formulation ``frame_scan_packed_even_conv``.  The two differ
    only in corr's last bit (n_agree * float32(1/22) against n_agree /
    float32(22)), as in the reference."""
    if not kernel_scan:
        return frame_scan_packed_even_conv(bits)
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    corr, err = ck.frame_scan_even(
        bits.to(torch.uint8).contiguous())
    return {"corr": corr, "crc_err": err}


def frame_scan_packed_even_conv(bits: torch.Tensor) -> dict:
    """Even-position dense scan as the packed conv (the reference's
    ``frame_scan_packed_even_xla``): values equal
    ``frame_scan(bits, rev=False)[...][:, ::2]`` exactly.

    The demod emits two bits per pi/4-DQPSK symbol and every assembly
    step moves in whole symbols, so a real frame start can only sit at
    an even bit index; scanning only those positions halves the work."""
    corr, errl = _conv_and_reduce(bits, _PACKED_KERNEL_EVEN_FWD,
                                  PACK_STRIDE // 2, rpp=19)
    n = bits.shape[1]
    return {"corr": corr[:, :(n - SYNC_LEN) // 2 + 1],
            "crc_err": errl[:, :(n - CRC_SPAN) // 2 + 1]
            .to(torch.int32)}


def frame_scan_packed_mm(bits: torch.Tensor) -> dict:
    """frame_scan_packed with the conv hand-rolled as an explicit
    im2col GEMM: 30 shifted (C, J, 8) slices stacked to (C, J, 240),
    then one (C*J, 240) x (240, 280) matmul.  Same values."""
    c, n = bits.shape
    dev = bits.device
    x = torch.nn.functional.pad(bits.to(torch.float32), (0, 256))
    npad = x.shape[1] - (x.shape[1] % PACK_STRIDE)
    x8 = x[:, :npad].reshape(c, -1, PACK_STRIDE)        # (C, JJ, 8)
    j = (npad - _KPACK) // PACK_STRIDE + 1
    groups = _KPACK // PACK_STRIDE + 1                  # 30
    cols = torch.cat(
        [x8[:, g:g + j, :] for g in range(groups)], dim=2)  # (C, J, 240)
    kmat = np.zeros((35 * PACK_STRIDE, groups * PACK_STRIDE), np.float32)
    kmat[:, :_KPACK] = _PACKED_KERNEL[:, 0, :]
    out = torch.einsum("cjk,ok->coj", cols, torch.from_numpy(kmat).to(dev))
    out = out.reshape(c, PACK_STRIDE, 35, j)
    out = out.permute(0, 2, 3, 1).reshape(c, 35, j * PACK_STRIDE)
    zs = torch.from_numpy(_SYNC_ZEROS).to(dev)
    sync = out[:, 33:35, :n - SYNC_LEN + 1]
    corr = torch.amax(sync + zs[None, :, None], dim=1) / float(SYNC_LEN)
    crc = torch.round(out[:, 0:33, :n - CRC_SPAN + 1]).to(torch.int32)
    return {"corr": corr, "crc_err": _syndromes(crc, True)}


def scan_words() -> np.ndarray:
    """The same scan as bit masks for the CUDA kernel, (149,) uint32:
    [16 rows x 8 words of CRC taps | 8 words of the data-view mask |
    TS1 word | TS2 word | c0 bits word | the 10 words of
    ``scan_slide_words``].  Bit b of word k of a row is tap 32k + b of
    the 230-bit window."""
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
    out.append(scan_slide_words())
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# The sliding form of the scan.  The 16 forward-CRC tap rows are a
# polynomial remainder: over the data view's 216 bits (two runs of the
# window, offsets 0-107 and 122-229) the tap column of data bit i is one
# fixed 16 x 16 matrix A over GF(2) times the column of bit i + 2.  So the
# parity word of the window at bit o + 2 follows from that at o: take out
# the four bits that leave the runs, multiply by A, put in the four that
# enter.  A is a shift of the word by two places plus one constant for
# each of the two bits shifted out.  Everything is derived here from
# _CRC_KERNEL and checked; nothing is typed in.
# ---------------------------------------------------------------------------

SLIDE_LEAVE = (0, 1, 122, 123)       # window offsets leaving the data view
SLIDE_ENTER = (108, 109, 230, 231)   # offsets (of the old window) entering
SLIDE_RUN = 16                       # positions a thread slides through


def _gf2_solve(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The 16 x 16 matrix a over GF(2) with a @ x = y (x, y 16 x m,
    x of full rank); raises if there is none."""
    n = x.shape[0]
    rows = np.concatenate([x.T, y.T], axis=1).astype(np.uint8)
    r = 0
    for c in range(n):
        piv = next((i for i in range(r, len(rows)) if rows[i, c]), None)
        if piv is None:
            raise RuntimeError("CRC tap columns do not span GF(2)^16")
        rows[[r, piv]] = rows[[piv, r]]
        hit = np.flatnonzero(rows[:, c])
        hit = hit[hit != r]
        rows[hit] ^= rows[r]
        r += 1
    if rows[n:].any():
        raise RuntimeError("CRC tap columns follow no fixed recurrence")
    return rows[:n, n:].T.copy()


def _bits_word(col: np.ndarray) -> int:
    """Bit r of the word is element r of the 0/1 column."""
    return int((col.astype(np.uint64) << np.arange(len(col),
                                                    dtype=np.uint64)).sum())


def scan_slide() -> dict:
    """Constants of the sliding scan, derived from the tap table:
    ``a`` the 16 x 16 step matrix, ``leave`` the four columns (as 16-bit
    words, bit r = syndrome row r) of the bits at SLIDE_LEAVE already
    multiplied by A, ``enter`` those of the bits at SLIDE_ENTER in the new
    window, ``g`` the two words that A adds for bits 0 and 1 of the old
    parity word: A x = (x >> 2) ^ (x & 1 ? g[0] : 0) ^ (x & 2 ? g[1] : 0)."""
    t = (_CRC_KERNEL[:16, 0, :][:, _DATA_OFFSETS] != 0).astype(np.uint8)
    a = _gf2_solve(t[:, 2:], t[:, :-2])
    shift = np.zeros((16, 16), np.uint8)
    shift[np.arange(14), np.arange(2, 16)] = 1
    rest = a ^ shift
    if rest[:, 2:].any():
        raise RuntimeError("the step matrix is not a shift by two plus "
                           "two columns")
    where = {int(off): i for i, off in enumerate(_DATA_OFFSETS)}
    leave = [_bits_word((a @ t[:, where[off]]) & 1) for off in SLIDE_LEAVE]
    enter = [_bits_word(t[:, where[off - 2]]) for off in SLIDE_ENTER]
    return {"a": a, "leave": leave, "enter": enter,
            "g": [_bits_word(rest[:, 0]), _bits_word(rest[:, 1])]}


def scan_slide_words() -> np.ndarray:
    """(10,) uint32 appended to ``scan_words``: [4 leaving columns | 4
    entering columns | 2 step constants] of ``scan_slide``."""
    s = scan_slide()
    return np.array(s["leave"] + s["enter"] + s["g"], np.uint32)


def host_scan_rows_even_sliding(bits: np.ndarray,
                                run: int = SLIDE_RUN) -> tuple:
    """The kernels' sliding scan (csrc/scan.cuh) step by step in numpy
    integers, in the kernel's own order: the row packed into 32-bit words
    with a zero pad, runs of ``run`` neighbouring even positions, the
    first of a run evaluated in full from the tap masks, every next one
    from the last (the shift by two with its two constants, leaving
    columns, entering columns; the ones count of the data view with the
    same eight bits; the sync word read anew).  Returns (corr, crc_err)
    as ``frame_scan_even`` does, corr as n_agree * float32(1/22)."""
    bits = np.asarray(bits, np.uint8)
    c, n = bits.shape
    pe_n, pc_n = plane_dims(n)
    pc_n = max(pc_n, 0)
    tab = scan_words()
    taps = tab[:128].reshape(16, 8).astype(np.uint64)
    ones_mask = tab[128:136].astype(np.uint64)
    ts = tab[136:138].astype(np.uint64)
    c0 = int(tab[138]) & 0xFFFF
    leave, enter, g = tab[139:143], tab[143:147], tab[147:149]
    n_words = (n + 31) // 32 + 10
    padded = np.zeros((c, 32 * n_words), np.uint64)
    padded[:, :n] = bits & 1
    z = (padded.reshape(c, n_words, 32)
         << np.arange(32, dtype=np.uint64)).sum(axis=2)       # (C, W)

    def field(o, width):
        """bits [o, o + width) of every row, width <= 32."""
        q, sh = o >> 5, np.uint64(o & 31)
        both = z[:, q] | (z[:, q + 1] << np.uint64(32))
        return (both >> sh) & np.uint64((1 << width) - 1)

    def popcount(v):
        """ones of each 32-bit value"""
        v = v.astype(np.uint64)
        v = v - ((v >> np.uint64(1)) & np.uint64(0x55555555))
        v = ((v & np.uint64(0x33333333))
             + ((v >> np.uint64(2)) & np.uint64(0x33333333)))
        v = (v + (v >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
        return (((v * np.uint64(0x01010101)) & np.uint64(0xFFFFFFFF))
                >> np.uint64(24)).astype(np.int64)

    corr = np.zeros((c, pe_n), np.float32)
    err = np.zeros((c, pc_n), np.int32)
    inv22 = np.float32(1.0) / np.float32(SYNC_LEN)
    for pe0 in range(0, pe_n, run):
        par = np.zeros(c, np.int64)
        ones = np.zeros(c, np.int64)
        for step in range(min(run, pe_n - pe0)):
            pe = pe0 + step
            o = 2 * pe
            if step == 0:
                w = np.stack([field(o + 32 * k, 32) for k in range(8)], 1)
                par = sum((popcount((w & taps[r][None, :]))
                           .sum(axis=1) & 1) << r for r in range(16))
                ones = popcount(w & ones_mask[None, :]).sum(axis=1)
            else:
                old = o - 2
                par = ((par >> 2) ^ (par & 1) * int(g[0])
                       ^ ((par >> 1) & 1) * int(g[1]))
                for off, col in zip(SLIDE_LEAVE, leave):
                    bit = field(old + off, 1).astype(np.int64)
                    par ^= bit * int(col)
                    ones -= bit
                for off, col in zip(SLIDE_ENTER, enter):
                    bit = field(old + off, 1).astype(np.int64)
                    par ^= bit * int(col)
                    ones += bit
            s22 = field(o, SYNC_LEN)
            agree = SYNC_LEN - np.minimum(popcount(s22 ^ ts[0]),
                                          popcount(s22 ^ ts[1]))
            corr[:, pe] = agree.astype(np.float32) * inv22
            if pe < pc_n:
                e = popcount((par ^ c0).astype(np.uint64))
                deg = (ones == 0) | (ones == DATA_BITS)
                err[:, pe] = np.where(deg, 99, e)
    return corr, err


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


def unpack_hits_to_planes(keys: np.ndarray, counts: np.ndarray,
                          pe_n: int, pc_n: int, bits_rows_fn) -> tuple:
    """Host side of the sparse scan: keys -> virtual dense planes.

    Returns (corr (C, pe_n) float32, crc_err (C, pc_n) int32) whose
    values at every position frame.batch reads are decision-equivalent
    to the dense scan's: CRC verdicts are bitwise (clamped to 63, same
    <= 2 outcome); corr is rebuilt from the exact integer agreement
    count as f32(n)/f32(22), within 1.2e-7 of the device plane (the
    kernel multiplies by a reciprocal).  Sub-threshold filler is 0.0 /
    99.  Rows whose hit count overflowed the device budget are
    recomputed exactly from their assembled bits:
    ``bits_rows_fn(row_indices) -> (R, N) uint8``.  Kept as the
    equivalence oracle of ``hits_from_keys``."""
    keys = np.asarray(keys)
    counts = np.asarray(counts)
    c, kh = keys.shape
    corr = np.zeros((c, pe_n), np.float32)
    crc = np.full((c, pc_n), 99, np.int32)
    r, i = np.nonzero(keys > 0)
    kv = keys[r, i]
    pe = pe_n - (kv >> _RANK_SHIFT)
    corr[r, pe] = ((kv & ((1 << _CRC_SHIFT) - 1))
                   .astype(np.float32) / np.float32(SYNC_LEN))
    qc = pe - TS_OFFSET_BITS // 2
    ok = (qc >= 0) & (qc < pc_n)
    crc[r[ok], qc[ok]] = (kv[ok] >> _CRC_SHIFT) & _CRC_CLAMP
    over = np.flatnonzero(counts > kh)
    if len(over):
        co, ce = host_scan_rows_even(bits_rows_fn(over))
        corr[over] = co[:, :pe_n]
        crc[over] = ce[:, :pc_n]
    return corr, crc


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
    integers (f64 dot of {0,1} vectors).  The kernels' scan
    (csrc/scan.cuh) computes the same verdicts with popcounts; its corr
    is n_agree * float32(1/22), within 1.2e-7 of this one."""
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


class FrameScanKernel:
    """Standalone scan dispatch (the frame layer's own per-block scan).

    ``packed=True`` (default) uses the packed conv; ``packed=False`` the
    plain 2-conv reference formulation (same values; the oracle of the
    packing tests).  ``even_only=True`` scans only symbol-aligned (even)
    bit positions through the hand-written kernel
    (frame_scan_packed_even; outputs indexed by p // 2 — callers must
    scale, e.g. frame.batch with scan_stride=2).  ``kernel_scan=False``
    takes the conv formulation there instead.  Bits go to ``device``
    (None: the card) and the planes come back as numpy arrays."""

    def __init__(self, packed: bool = True, even_only: bool = False,
                 device=None, kernel_scan: bool = True):
        from tetraear_tpu_torch.device import resolve
        self.stride = 2 if even_only else 1
        self.device = resolve(device)
        if even_only:
            self._scan = lambda b: frame_scan_packed_even(b, kernel_scan)
        else:
            self._scan = frame_scan_packed if packed else frame_scan

    def scan(self, bits: np.ndarray) -> dict:
        x = torch.from_numpy(np.ascontiguousarray(bits, np.uint8))
        out = self._scan(x.to(self.device))
        return {key: val.cpu().numpy() for key, val in out.items()}
