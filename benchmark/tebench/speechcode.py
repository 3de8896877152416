"""TETRA TCH/S speech channel encoder (ETSI EN 300 395-2), in numpy.

The benchmark's own encoder, vectorized over slots: two 137-bit speech
frames -> the 432 bits of a traffic slot, and one frame -> the 216 bits
of a stolen half slot.  It follows the class partition, CRC, RCPC code,
puncturing and interleaving of the standard (the tables are in
``frozen/etsi_tables.py``).  A bit goes on the air as 1 where the coded
soft value is positive, that is, as the complement of the code bit.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from tebench.frozen import etsi_tables as T

FRAME_BITS = 137

# ETSI_TAB_CRC_LEN / ETSI_FS_TAB_CRC of the standard's channel codec
FS_TAB_CRC = np.array([
    [1, 4, 5, 7, 9, 10, 11, 12, 16, 19, 20, 22, 24, 25, 26, 27],
    [1, 2, 4, 6, 7, 8, 9, 13, 16, 17, 19, 21, 22, 23, 24, 28],
    [2, 3, 5, 7, 8, 9, 10, 14, 17, 18, 20, 22, 23, 24, 25, 29],
    [3, 4, 6, 8, 9, 10, 11, 15, 18, 19, 21, 23, 24, 25, 26, 30]])


def _parity(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def _rcpc(ordered: np.ndarray, n0: int, n1: int, n2: int, ncrc: int,
          a2: np.ndarray) -> np.ndarray:
    """(F, n0 + steps) ordered bits -> (F, coded) code bits: class 0 as
    it is, then the K=5 rate-1/3 code punctured per the standard."""
    f = ordered.shape[0]
    out = [ordered[:, :n0]]
    reg = np.zeros(f, np.int64)
    steps = n1 + n2 + ncrc + 4
    for i in range(steps):
        b = ordered[:, n0 + i].astype(np.int64)
        lsb = reg & 1
        reg = (reg >> 1) | (b << 3)
        w = (reg << 1) | lsb
        if i < n1:
            streams = (T.G1,) + ((T.G2,) if T.A1[i % 8] else ())
        else:
            streams = (T.G1, T.G2) + ((T.G3,) if a2[(i - n1) % 8] else ())
        for g in streams:
            out.append(_parity(w & g)[:, None])
    return np.concatenate(out, axis=1).astype(np.uint8)


def encode_slots(frame_a: np.ndarray, frame_b: np.ndarray) -> np.ndarray:
    """(F, 137) + (F, 137) speech parameter bits -> (F, 432) slot bits as
    sent (interleaved, complemented)."""
    fa = np.asarray(frame_a, np.uint8)
    fb = np.asarray(frame_b, np.uint8)
    f = fa.shape[0]
    ordered = np.zeros((f, 286), np.uint8)
    for lo, tab in ((0, T.TAB0), (102, T.TAB1), (214, T.TAB2)):
        n = len(tab)
        ordered[:, lo:lo + 2 * n:2] = fa[:, tab - 1]
        ordered[:, lo + 1:lo + 2 * n:2] = fb[:, tab - 1]
    for k, taps in enumerate(T.TAB_CRC):
        ordered[:, 274 + k] = np.bitwise_xor.reduce(
            ordered[:, 214 + np.asarray(taps) - 1], axis=1)
    code = _rcpc(ordered, T.N0, T.N1, T.N2, T.NCRC, T.A2)
    assert code.shape[1] == 432, code.shape
    inter = code[:, T.interleave_index()]
    return (1 - inter).astype(np.uint8)


def encode_stolen(frame: np.ndarray) -> np.ndarray:
    """(F, 137) speech parameter bits -> (F, 216) half-slot bits as sent."""
    fr = np.asarray(frame, np.uint8)
    f = fr.shape[0]
    ordered = np.zeros((f, 145), np.uint8)
    ordered[:, 0:51] = fr[:, T.TAB0 - 1]
    ordered[:, 51:107] = fr[:, T.TAB1 - 1]
    ordered[:, 107:137] = fr[:, T.TAB2 - 1]
    for k in range(4):
        ordered[:, 137 + k] = np.bitwise_xor.reduce(
            ordered[:, 107 + FS_TAB_CRC[k] - 1], axis=1)
    code = _rcpc(ordered, 51, 56, 30, 4, T.FS_A2)
    assert code.shape[1] == 216, code.shape
    inter = np.zeros_like(code)
    inter[:, (101 * (np.arange(216) + 1)) % 216] = code
    return (1 - inter).astype(np.uint8)


@lru_cache(maxsize=None)
def _zero_slot() -> np.ndarray:
    return encode_slots(np.zeros((1, FRAME_BITS)), np.zeros((1, FRAME_BITS)))


@lru_cache(maxsize=None)
def header_bits() -> tuple:
    """[(slot bit, frame, parameter bit)] for the slot's first four bits:
    they are class-0 bits, sent uncoded, so each is one parameter bit of
    one frame (complemented)."""
    zero = _zero_slot()
    found = []
    for frame in range(2):
        for w in range(FRAME_BITS):
            p = np.zeros((2, 1, FRAME_BITS), np.uint8)
            p[frame, 0, w] = 1
            d = np.nonzero(encode_slots(p[0], p[1])[0] != zero[0])[0]
            if len(d) == 1 and d[0] < 4:
                found.append((int(d[0]), frame, w))
    return tuple(sorted(found))


def force_header(frame_a: np.ndarray, frame_b: np.ndarray,
                 want=(0, 1, 0, 0)) -> None:
    """Set, in place, the parameter bits behind the slot's first four
    bits so that the sent slot starts with ``want`` (a MAC-FRAG header,
    which routes the slot to the voice path)."""
    zero = _zero_slot()
    frames = (frame_a, frame_b)
    for bit, frame, w in header_bits():
        # sent bit = zero[bit] xor parameter bit
        frames[frame][:, w] = want[bit] ^ zero[0, bit]
