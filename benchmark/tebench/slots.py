"""TETRA downlink slots as bits (510 bits, 255 symbols a slot).

A data slot carries a MAC-RESOURCE PDU in its data view (slot bits
0..107 and 122..229) with its CRC-16 in the last 16 bits of that view.
The 22-bit downlink sync word sits at slot bits 216..237, so the last 14
CRC bits are also sync bits: the free filler bits of the PDU are solved
over GF(2) so that the CRC equals the sync word there exactly, and the
slot passes the receiver's CRC gate with no error to spare.  A voice
slot carries 432 coded speech bits around the sync word; a stolen slot
carries the other sync word and one half-slot-coded frame in block 2.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from tebench.frozen import burst, crc

SLOT_BITS = 510
SLOT_SYMS = 255
SYNC_AT = 216
SYNC_C = burst.SYNC_CONTINUOUS_DOWNLINK
SYNC_D = burst.SYNC_DISCONTINUOUS_DOWNLINK
DATA_IDX = np.concatenate([np.arange(0, 108), np.arange(122, 230)])
BODY = 200                          # data view bits before the CRC


def _gf2_inverse(m: np.ndarray) -> np.ndarray | None:
    """Inverse of a square GF(2) matrix, or None if it is singular."""
    n = len(m)
    a = np.concatenate([m.astype(np.uint8) & 1, np.eye(n, dtype=np.uint8)],
                       axis=1)
    for col in range(n):
        rows = np.nonzero(a[col:, col])[0]
        if not len(rows):
            return None
        r = col + rows[0]
        a[[col, r]] = a[[r, col]]
        for rr in range(n):
            if rr != col and a[rr, col]:
                a[rr] ^= a[col]
    return a[:, n:]


@lru_cache(maxsize=None)
def _pivots(free_lo: int) -> tuple:
    """14 filler positions in [free_lo, 200) whose CRC columns (rows
    2..15) form an invertible matrix, and that matrix's inverse."""
    m, _ = crc.crc16_matrix(BODY)
    sub = m[2:16]
    for start in range(BODY - 14, free_lo - 1, -1):
        cols = np.arange(start, start + 14)
        inv = _gf2_inverse(sub[:, cols])
        if inv is not None:
            return cols, inv
    raise ValueError(f"no 14 free bits after {free_lo}")


def data_view(fixed: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """216-bit data view [fixed | random filler | CRC-16] whose CRC bits
    2..15 equal the first 14 sync bits."""
    fixed = np.asarray(fixed, np.uint8)
    if len(fixed) > BODY - 14:
        raise ValueError("fixed part too long")
    cols, inv = _pivots(len(fixed))
    m, c0 = crc.crc16_matrix(BODY)
    body = np.concatenate([fixed, rng.integers(0, 2, BODY - len(fixed))
                           .astype(np.uint8)])
    body[cols] = 0
    cur = (m[2:16].astype(np.int64) @ body + c0[2:16]) & 1
    body[cols] = (inv.astype(np.int64) @ (cur ^ SYNC_C[:14])) & 1
    out = np.concatenate([body, crc.crc16_bits(body)])
    assert np.array_equal(out[202:216], SYNC_C[:14])
    return out


def mac_resource_fixed(payload: bytes, enc_mode: int = 0,
                       address: int = 0x123456) -> np.ndarray:
    """MAC-RESOURCE header (type 00, encryption mode), 24-bit address,
    6-bit length in bytes, payload."""
    header = np.zeros(5, np.uint8)
    header[2] = (enc_mode >> 1) & 1
    header[3] = enc_mode & 1
    addr = np.array([(address >> i) & 1 for i in range(23, -1, -1)],
                    np.uint8)
    n = len(payload)
    if n > 63:
        raise ValueError("payload too long for the length field")
    length = np.array([(n >> i) & 1 for i in range(5, -1, -1)], np.uint8)
    return np.concatenate([header, addr, length,
                           burst.bytes_to_bits(payload)])


def data_slots(view: np.ndarray, n: int,
               rng: np.random.Generator) -> np.ndarray:
    """(n, 510) slots carrying the same data view, other bits random."""
    s = rng.integers(0, 2, (n, SLOT_BITS)).astype(np.uint8)
    s[:, DATA_IDX] = view
    s[:, SYNC_AT:SYNC_AT + 22] = SYNC_C
    return s


def voice_slots(coded: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(n, 432) coded speech bits (already starting 0100) -> (n, 510)."""
    n = len(coded)
    s = rng.integers(0, 2, (n, SLOT_BITS)).astype(np.uint8)
    s[:, 0:216] = coded[:, 0:216]
    s[:, SYNC_AT:SYNC_AT + 22] = SYNC_C
    s[:, 238:454] = coded[:, 216:432]
    return s


def stolen_slots(half: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(n, 216) half-slot bits -> (n, 510) stolen slots: block 1 filler
    signalling under a MAC-FRAG header, block 2 the speech frame."""
    n = len(half)
    s = rng.integers(0, 2, (n, SLOT_BITS)).astype(np.uint8)
    s[:, SYNC_AT:SYNC_AT + 22] = SYNC_D
    s[:, 238:454] = half
    s[:, 0:4] = (0, 1, 0, 0)
    return s


def crc_verdicts(body: np.ndarray) -> np.ndarray:
    """(n,) the receiver's CRC verdict on each sent data slot.  A slot
    whose bits at its midpoint (255..276) agree with a sync word in more
    than 80% is read as a synchronization burst, whose data view is the
    whole slot (the frame decoder's rule, ``frozen/burst.py``); every
    other slot carries an exact CRC."""
    mid = body[:, 255:277]
    agree = np.maximum((mid == SYNC_C).sum(axis=1),
                       (mid == SYNC_D).sum(axis=1))
    out = np.ones(len(body), bool)
    for i in np.nonzero(agree > 0.8 * 22)[0]:
        out[i] = burst.parse_burst_bits(body[i]).crc_ok
    return out
