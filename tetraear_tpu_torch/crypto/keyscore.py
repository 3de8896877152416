"""The deferred key search's plaintext scores on the card, and what
scoring does to the scoring decoder's parser.

``batch_decrypt_frames`` (crypto/batch.py) scores every plan entry's
plaintext as ``TetraDecoder._score_decrypt`` does: the score of
``frame.decoder.score_plaintext`` (printable and unique-byte terms, the
all-0x00 / all-0xFF penalties, the first-byte bonuses, the SDS term, the
soft CRC gate, the MAC bonus) and the effects ``apply_score_effects``
leaves on the parser (the SDS parse's data messages, the MAC PDU
applied).  ``key_score`` writes a record for every (key, frame)
plaintext of a ``tea_decrypt_fused`` output and every frame's own
payload (the BYPASS entry) in one launch of the hand-written kernel of
``dsp/csrc/keyscore.cu``; it replaces no TPU kernel (the reference
scores on the host, plaintext by plaintext).

A record is three int32 (``key_score``'s (3, R) output, column r):

  * ``SCORE``: the exact score; where ``FLAG`` is set, the score
    without its SDS term;
  * ``INFO``: bit ``FLAG`` where the SDS term is left to the host (the
    GSM-7 user type ``07 00``, whose candidate search the kernel does
    not walk, and the heuristic text fallback on a payload that Python's
    utf-8 decoder reads with a character past ASCII); bit ``COUNT``
    where parse_sds_data counts a data message; bit ``MAC_OK`` where
    extract_mac_fields finds fields, their PDU type in bits 3-4 and
    encryption mode in bits 5-6, and bit ``SYSINFO`` where they carry a
    SYSINFO network identity;
  * ``NETWORK``: that identity, mcc | mnc << 10 | colour code << 24.

Every other branch of parse_sds_data is decided exactly: the texts are
counted through ``SCORE_TABLE``, built here from the very character
predicates frame/sds.py's text gates count with, and every ratio is a
float64 division compared as Python compares it.  ``key_score_plain``
is the kernel's plain twin (PyTorch, the same records), which the
CPU device runs.

``pdu_types`` and ``pdus_of`` read a record's MAC part as
frame.mac.MacParser's ``buffer_keeps`` and ``replay_mac_fields`` take
it: crypto/batch.py replays the effects of a frame's scored entries on
its decoder's parser from them (frame.decoder.replay_score_effects).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tetraear_tpu_torch.dsp import cuda_kernels as ck
from tetraear_tpu_torch.frame import sds as sds_mod
from tetraear_tpu_torch.frame.decoder import FIRST_BONUS

# record rows of key_score's output
SCORE, INFO, NETWORK = 0, 1, 2
# INFO bits
FLAG, COUNT, MAC_OK, SYSINFO = 1, 2, 4, 128
TYPE_SHIFT, MODE_SHIFT = 3, 5

# SCORE_TABLE[0:256]: what unpack_gsm7 emits for septet c (entry c) and
# for c after the 0x1B escape (entry 128 + c): a character (PRESENT),
# its classes for the text gates of frame/sds.py, each the predicate
# sds.py counts with (str.isspace, what str.strip() strips;
# str.isalpha; score_text's printable and alphanumeric classes;
# is_valid_text's; the GSM7 last resort's ASCII alphanumeric class),
# and its code point from bit 8 up.
PRESENT, SPACE, ALPHA, PRINT_S, ALNUM_S, PRINT_V, ALNUM_V, ASCII = (
    1 << i for i in range(8))
# SCORE_TABLE[256 + b] and [512 + b]: byte b decoded as latin-1 and as
# cp1252: is_valid_text's printable and alphanumeric classes, its blank
# class (the characters it drops before asking for any other), and
# whether the codec has no character for the byte.
LATIN1, CP1252 = 256, 512
L_PRINT, L_ALNUM, L_BLANK, L_UNDEFINED = 1, 2, 4, 8

_GSM_CLASSES = (
    (SPACE, str.isspace),
    (ALPHA, str.isalpha),
    (PRINT_S, lambda c: c.isprintable() and c != "\x1b"),
    (ALNUM_S, lambda c: c.isalnum() or c.isspace()),
    (PRINT_V, lambda c: c.isprintable() or c in "\n\r\t"),
    (ALNUM_V, lambda c: c.isalnum() or c == " "),
    (ASCII, lambda c: c.isascii() and (c.isalnum() or c == " ")))
_LATIN_CLASSES = (
    (L_PRINT, lambda c: c.isprintable() or c in "\n\r\t"),
    (L_ALNUM, lambda c: c.isalnum() or c == " "),
    (L_BLANK, lambda c: c in "\n\r\t "))


def _score_table() -> np.ndarray:
    out = np.zeros(768, np.int32)
    chars = ([sds_mod.gsm7_map(c) for c in range(128)]
             + [sds_mod.GSM7_EXTENSION.get(c, "") for c in range(128)])
    for i, ch in enumerate(chars):
        if not ch:
            continue
        if ch == "\x00" or len(ch) != 1:
            # the walk has no room for strip("\x00") or a longer text
            raise ValueError(f"GSM7 entry {i}: {ch!r}")
        out[i] = PRESENT | (ord(ch) << 8) | sum(
            bit for bit, pred in _GSM_CLASSES if pred(ch))
    for at, codec in ((LATIN1, "latin-1"), (CP1252, "cp1252")):
        for b in range(256):
            try:
                ch = bytes([b]).decode(codec)
            except UnicodeDecodeError:
                out[at + b] = L_UNDEFINED
                continue
            out[at + b] = sum(bit for bit, pred in _LATIN_CLASSES
                              if pred(ch))
    return out


SCORE_TABLE = _score_table()
_TABLE_ON: dict = {}


def table_on(dev: torch.device) -> torch.Tensor:
    """SCORE_TABLE on ``dev`` as int32, uploaded once a device."""
    key = str(dev)
    if key not in _TABLE_ON:
        _TABLE_ON[key] = torch.from_numpy(SCORE_TABLE).to(dev)
    return _TABLE_ON[key]


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------


def _crc_table() -> torch.Tensor:
    """CRC-16-CCITT (0x1021) a byte at a time, MSB first."""
    t = []
    for v in range(256):
        c = v << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x1021) if c & 0x8000 else c << 1
        t.append(c & 0xFFFF)
    return torch.tensor(t, dtype=torch.int64)


_CRC = _crc_table()
_POPC = torch.tensor([bin(v).count("1") for v in range(256)])
_BREV = torch.tensor([int(f"{v:08b}"[::-1], 2) for v in range(256)])


def _rows(plains, v0, v1, lengths) -> tuple:
    """(R, L) int64 bytes of every row, zero from each row's length on,
    and (R,) lengths: the K x B plaintexts, then the B payloads."""
    k, b, length = plains.shape
    shifts = torch.tensor([24, 16, 8, 0])
    w = torch.stack([v0.to(torch.int64) & 0xFFFFFFFF,
                     v1.to(torch.int64) & 0xFFFFFFFF], dim=-1)
    pay = ((w[..., None] >> shifts) & 0xFF).reshape(b, length)
    x = torch.cat([plains.reshape(k * b, length).to(torch.int64), pay])
    n = lengths.to(torch.int64).clamp(0, length).repeat(k + 1)
    x = torch.where(torch.arange(length) < n[:, None], x, 0)
    return x, n


def _ratio(num, den) -> torch.Tensor:
    """num / den as Python divides two ints (float64)."""
    return num.to(torch.float64) / den.to(torch.float64)


def _crc_diff(x, n, reverse: bool) -> torch.Tensor:
    """Bits that differ between a row's last two bytes and the CRC of
    the bytes before them (their bits reversed, if asked)."""
    r, length = x.shape
    crc = torch.full((r,), 0xFFFF, dtype=torch.int64)
    body = n - 2
    for j in range(max(length - 2, 0)):
        if reverse:
            byte = _BREV[x.gather(1, (body - 1 - j).clamp(0, length - 1)
                                  [:, None])[:, 0]]
        else:
            byte = x[:, j]
        nxt = ((crc << 8) ^ _CRC[((crc >> 8) ^ byte) & 0xFF]) & 0xFFFF
        crc = torch.where(j < body, nxt, crc)
    last = (x.gather(1, (n - 2).clamp(0, length - 1)[:, None])[:, 0] << 8) \
        | x.gather(1, (n - 1).clamp(0, length - 1)[:, None])[:, 0]
    d = crc ^ last
    return _POPC[d & 0xFF] + _POPC[d >> 8]


def _bits(x, pos: int, width: int) -> torch.Tensor:
    """Bits [pos, pos + width) of each row, MSB first (bytes past the
    row read 0)."""
    length = x.shape[1]
    v = torch.zeros(x.shape[0], dtype=torch.int64)
    for j in range(pos // 8, pos // 8 + 4):
        v = (v << 8) | (x[:, j] if j < length else 0)
    return ((v << (pos % 8)) & 0xFFFFFFFF) >> (32 - width)


def _mac(x, n) -> tuple:
    """extract_mac_fields' outcome: (INFO's MAC bits, NETWORK)."""
    nbits = 8 * n
    t = x[:, 0] >> 6
    e = (x[:, 0] >> 4) & 3
    mcc, mnc, cc = _bits(x, 4, 10), _bits(x, 14, 14), _bits(x, 28, 6)
    gate = (nbits >= 34) & (mcc >= 200) & (mcc <= 799) & (mnc <= 999)
    ok = torch.where(
        t == 0, (nbits >= 35) & (_bits(x, 29, 6) * 8 <= nbits - 19),
        torch.where(t == 1, True,
                    torch.where(t == 2, (e != 0) | gate,
                                (nbits >= 11)
                                & (_bits(x, 5, 6) * 8 <= nbits + 5))))
    ok &= nbits >= 8
    sysinfo = ok & (t == 2) & (e == 0)
    info = torch.where(ok, MAC_OK | (t << TYPE_SHIFT) | (e << MODE_SHIFT),
                       0) | torch.where(sysinfo, SYSINFO, 0)
    return info, torch.where(sysinfo, mcc | (mnc << 10) | (cc << 24), 0)


def _valid_text(x, a: int, m, thr: float, table, codec: int = LATIN1):
    """is_valid_text(bytes [a, m) of each row decoded by ``codec``
    (LATIN1 or CP1252 of ``table``; a byte it has no character for counts
    as none of the classes), thr)."""
    length = x.shape[1]
    col = torch.arange(length)
    seg = (col >= a) & (col < m[:, None])
    cls = table[codec:codec + 256][x]
    ln = seg.sum(dim=1)
    blank = (seg & ((cls & L_BLANK) != 0)).sum(dim=1)
    pv = (seg & ((cls & L_PRINT) != 0)).sum(dim=1)
    av = (seg & ((cls & L_ALNUM) != 0)).sum(dim=1)
    first = x[:, min(a, length - 1)]
    same = ((x == first[:, None]) | ~seg).all(dim=1)
    return ((ln >= 2) & (blank < ln) & (_ratio(pv, ln) >= thr)
            & ~((ln > 4) & same) & (_ratio(av, ln) > 0.5))


def _gsm7_text(x, start, nbytes, table) -> dict:
    """unpack_gsm7 of each row's bytes [start, start + nbytes), then
    strip(): the stripped text's length and class counts, whether it
    has a letter and whether all its characters are one."""
    r, length = x.shape
    smax = 8 * length // 7
    k = torch.arange(smax)
    live = k < (8 * nbytes // 7)[:, None]
    idx = (7 * k) >> 3
    at = start[:, None] + idx

    def byte(pos, ok):
        got = x.gather(1, pos.clamp(0, length - 1))
        return torch.where(ok & (pos < length), got, 0)

    two = byte(at, live) | (byte(at + 1, idx + 1 < nbytes[:, None]) << 8)
    code = torch.where(live, (two >> ((7 * k) & 7)) & 0x7F, 0)
    esc = live & (code == 0x1B)
    # an escape takes the next septet unless it is itself taken: in a
    # run of 0x1B, every other one from the run's first escapes
    last_other = torch.cummax(torch.where(esc, -1, k.expand(r, -1)),
                              dim=1).values
    run = k - last_other
    taken = torch.zeros_like(esc)
    taken[:, 1:] = esc[:, :-1] & (run[:, :-1] % 2 == 1)
    e = table[torch.where(taken, 128 + code, code)]
    emits = live & ~(esc & ~taken) & ((e & PRESENT) != 0)
    word = emits & ((e & SPACE) == 0)
    started = word.any(dim=1)
    first = torch.argmax(word.to(torch.int8), dim=1)
    last = smax - 1 - torch.argmax(word.flip(1).to(torch.int8), dim=1)
    inside = emits & (k >= first[:, None]) & (k <= last[:, None]) \
        & started[:, None]
    out = {c: (inside & ((e & bit) != 0)).sum(dim=1)
           for c, bit in (("ps", PRINT_S), ("as", ALNUM_S), ("pv", PRINT_V),
                          ("av", ALNUM_V), ("asc", ASCII))}
    out["len"] = inside.sum(dim=1)
    out["alpha"] = (inside & ((e & ALPHA) != 0)).any(dim=1)
    cp = e >> 8
    out["same"] = ((cp == cp.gather(1, first[:, None])) | ~inside).all(dim=1)
    return out


def _gsm7_accepts(x, m, table) -> torch.Tensor:
    """The GSM7 last resort of parse_sds_data on the stripped rows (m
    bytes): unpack_gsm7 and unpack_gsm7_udh, the first best score_text
    (a repeated text scores the same, so the dedupe changes nothing),
    is_valid_text(best, 0.55) and the ASCII alphanumeric share."""
    zero = torch.zeros_like(m)
    udh = x[:, 0]
    has_udh = (m >= 2) & (udh > 0) & (udh + 1 < m)
    texts = [_gsm7_text(x, zero, m, table),
             _gsm7_text(x, udh + 1, torch.where(has_udh, m - udh - 1, 0),
                        table)]
    best = torch.zeros(len(m), dtype=torch.float64)
    pick = torch.full_like(m, -1)
    for i, t in enumerate(texts):
        s = (_ratio(t["ps"], t["len"]) + _ratio(t["as"], t["len"])) \
            + torch.where(t["alpha"], 0.5, 0.0)
        better = (t["len"] > 0) & (s > best)
        best = torch.where(better, s, best)
        pick = torch.where(better, i, pick)
    acc = torch.zeros_like(has_udh)
    for i, t in enumerate(texts):
        n = t["len"]
        ok = ((n >= 2) & (_ratio(t["pv"], n) >= 0.55)
              & ~((n > 4) & t["same"]) & (_ratio(t["av"], n) > 0.5)
              & (_ratio(t["asc"], n) >= 0.75))
        acc |= (pick == i) & ok
    return acc


def _utf8(x, m, rows) -> torch.Tensor:
    """Whether bytes [0, m) of each row of ``rows`` are UTF-8 as
    Python's strict decoder reads it (False elsewhere)."""
    out = torch.zeros(len(m), dtype=torch.bool)
    for r in torch.nonzero(rows).flatten().tolist():
        try:
            bytes(x[r, :m[r]].to(torch.uint8).tolist()).decode("utf-8")
        except UnicodeDecodeError:
            continue
        out[r] = True
    return out


def key_score_plain(plains: torch.Tensor, v0: torch.Tensor,
                    v1: torch.Tensor, lengths: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
    """Plain version of key_score."""
    x, n = _rows(plains, v0, v1, lengths)
    table = table.to(torch.int64)
    r, length = x.shape
    col = torch.arange(length)
    in_n = col < n[:, None]
    nz = x != 0
    m = torch.where(nz.any(dim=1),
                    length - torch.argmax(nz.flip(1).to(torch.int8), dim=1),
                    0)
    in_m = col < m[:, None]

    def distinct(mask):
        seen = torch.zeros(r, 257, dtype=torch.bool)
        seen.scatter_(1, torch.where(mask, x, 256), True)
        return seen[:, :256].sum(dim=1)

    unique, unique_m = distinct(in_n), distinct(in_m)
    printable = ((x >= 32) & (x <= 126)).sum(dim=1)
    first, second = x[:, 0], x[:, min(1, length - 1)]
    fb = torch.zeros_like(first, dtype=torch.bool)
    for v in FIRST_BONUS:
        fb |= first == v
    score = (2 * printable + torch.where(unique > n // 8, 30, 0)
             - torch.where(m == 0, 50, 0)
             - torch.where(((x == 0xFF) | ~in_n).all(dim=1), 50, 0)
             + torch.where(n >= 4, torch.where((first != 0) & (first != 0xFF),
                                               10, 0)
                           + torch.where(fb, 20, 0), 0)
             + torch.where(unique > 1, 10, 0))

    # parse_sds_data's branches, in its order
    high = in_m & (x >= 128)
    ascii_from = [~(high & (col >= a)).any(dim=1) for a in (0, 1, 3)]
    user = (n > 3) & (second == 0)
    sds1 = (m > 0) & user & (first == 0x05) & ascii_from[2] \
        & _valid_text(x, 3, m, 0.8, table)
    gsm_user = (m > 0) & ~sds1 & user & (first == 0x07)
    open_ = (m > 0) & ~sds1 & ~gsm_user
    p82 = open_ & (first == 0x82) & _valid_text(x, 1, m, 0.8, table)
    p03 = open_ & (first == 0x03) & ascii_from[1] \
        & _valid_text(x, 1, m, 0.8, table)
    lip = open_ & ((first == 0x83) | (first == 0x0C))
    open_ &= ~(p82 | p03 | lip)
    heur = open_ & (_ratio((in_m & (((x >= 32) & (x <= 126)) | (x == 10)
                                     | (x == 13))).sum(dim=1), m) > 0.6)
    # Python's decoders in turn: utf-8 (a text it reads with a character
    # past ASCII is left to the host), latin-1, ascii, cp1252
    heur_flag = heur & ~ascii_from[0] & _utf8(x, m, heur & ~ascii_from[0])
    cp_undefined = (in_m & ((table[CP1252:CP1252 + 256][x] & L_UNDEFINED)
                            != 0)).any(dim=1)
    heur_text = heur & ~heur_flag & (
        _valid_text(x, 0, m, 0.6, table)
        | (~ascii_from[0] & ~cp_undefined
           & _valid_text(x, 0, m, 0.6, table, CP1252)))
    open_ &= ~(heur_flag | heur_text)
    gsm = open_ & _gsm7_accepts(x, m, table)
    open_ &= ~gsm
    bin_enc = open_ & (m > 8) & (_ratio(unique_m, m) > 0.7)
    counted = sds1 | p82 | p03 | heur_text | gsm
    score += (torch.where(counted | lip, 120, 0)
              + torch.where(bin_enc, -20, 0)
              + torch.where(open_ & ~bin_enc, 40, 0))

    ones = _POPC[x].sum(dim=1)
    crc_ok = (n >= 2) & (ones > 0) & (ones < 8 * n) & (
        (_crc_diff(x, n, False) <= 2) | (_crc_diff(x, n, True) <= 2))
    mac, network = _mac(x, n)
    score += torch.where(crc_ok, 100, 0) + torch.where(mac != 0, 50, 0)
    info = (mac | torch.where(gsm_user | heur_flag, FLAG, 0)
            | torch.where(counted, COUNT, 0))
    return torch.stack([score, info, network]).to(torch.int32)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

def key_score(plains: torch.Tensor, v0: torch.Tensor, v1: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """Score every row: (K, B, L) uint8 plaintexts (tea_decrypt_fused's;
    K may be 0), the (B, L/8) int32 payload word pairs they came from
    and (B,) int32 row lengths (each row is scored over its frame's
    first ``lengths[b]`` bytes), with the device's SCORE_TABLE ->
    (3, R) int32 records, R = (K + 1) B: column k B + b is key k's
    plaintext of payload b, column K B + b payload b itself.

    Bound: the bytes, a row's L read and 12 written; the walks over a
    row (a byte pass, the text gates, two CRC passes, two GSM7
    unpackings) run one after another in its thread, so the launch takes
    far longer (PERF.md's kernels table).  Design: csrc/keyscore.cu, a
    thread a row (rows are independent and short), the row's bytes
    read through L1, which holds them across the walks, the table in
    shared memory."""
    if plains.dim() != 3:
        raise ValueError(f"plains: shape {tuple(plains.shape)}, expected "
                         "(K, B, L)")
    k, b, length = plains.shape
    w = length // 8
    table = table_on(plains.device)
    ck._check(plains, "plains", (k, b, 8 * w), torch.uint8)
    ck._check(v0, "v0", (b, w), torch.int32)
    ck._check(v1, "v1", (b, w), torch.int32)
    ck._check(lengths, "lengths", (b,), torch.int32)
    ck._check(table, "table", (768,), torch.int32)
    r = (k + 1) * b
    if b < 1 or w < 1 or r >= 1 << 31:
        raise ValueError(f"key_score: {k} keys x {b} payloads of {length} "
                         "bytes")
    if ck._route(plains, v0, v1, lengths, table) == "cpu":
        return key_score_plain(plains, v0, v1, lengths, table)
    out = torch.empty((3, r), dtype=torch.int32, device=plains.device)
    ck._launch("key_score", plains.device, ck.build().tt_key_score,
               *kernel_args(plains, v0, v1, lengths, table, out))
    return out


def kernel_args(plains, v0, v1, lengths, table, out) -> tuple:
    """The C entry's arguments but the stream: what ``key_score``
    launches and ``chip_smoke.py`` times alone."""
    k, b, length = plains.shape
    return (ck._ptr(plains), ck._ptr(v0), ck._ptr(v1), ck._ptr(lengths),
            ck._ptr(table), k, b, length // 8, ck._ptr(out))


# ---------------------------------------------------------------------------
# the host's side of a record
# ---------------------------------------------------------------------------

class Record(NamedTuple):
    """One record as the host reads it."""
    score: int
    info: int
    network: int


def record_of(scored) -> Record:
    """The record of frame.decoder.score_plaintext's result: what the
    kernel writes for an unflagged row (the host's record of a row the
    kernel flagged)."""
    f = scored.fields
    info = COUNT if scored.data_messages else 0
    network = 0
    if f is not None:
        info |= MAC_OK | (f.pdu_type_int << TYPE_SHIFT) \
            | (f.enc_mode << MODE_SHIFT)
        if f.sysinfo is not None:
            info |= SYSINFO
            mcc, mnc, cc = f.sysinfo
            network = mcc | (mnc << 10) | (cc << 24)
    return Record(scored.score, info, network)


def pdu_types(info: np.ndarray) -> np.ndarray:
    """Each record's MAC PDU type (pdu_type_int; -1: no fields), as
    MacParser.buffer_keeps takes them."""
    return np.where(info & MAC_OK != 0, (info >> TYPE_SHIFT) & 3, -1)


def pdus_of(info: np.ndarray, network: np.ndarray) -> list:
    """Records' MAC PDUs as MacParser.replay_mac_fields takes them:
    (pdu_type_int, enc_mode, sysinfo) or None."""
    return [None if not i & MAC_OK else (
        (i >> TYPE_SHIFT) & 3, (i >> MODE_SHIFT) & 3,
        (n & 0x3FF, (n >> 10) & 0x3FFF, (n >> 24) & 0x3F)
        if i & SYSINFO else None)
        for i, n in zip(info.tolist(), network.tolist())]
