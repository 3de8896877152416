"""ETSI EN 300 395-2 TCH/S channel-coding constants (Python mirror).

Same spec constants as voice/csrc/etsi_tables.h (see its header comment
for provenance); tests/codec/test_jviterbi.py asserts the two stay in
lockstep by comparing full encoder outputs.
"""

from __future__ import annotations

import numpy as np

TAB0 = np.array([
    35, 36, 37, 38, 39, 40, 41, 42, 43, 47, 48, 56, 61, 62, 63, 64, 65,
    66, 67, 68, 69, 70, 74, 75, 83, 88, 89, 90, 91, 92, 93, 94, 95, 96,
    97, 101, 102, 110, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124,
    128, 129, 137], np.int32)

TAB1 = np.array([
    58, 85, 112, 54, 81, 108, 135, 50, 77, 104, 131, 45, 72, 99, 126, 55,
    82, 109, 136, 5, 13, 34, 8, 16, 17, 22, 23, 24, 25, 26, 6, 14, 7, 15,
    60, 87, 114, 46, 73, 100, 127, 44, 71, 98, 125, 33, 49, 76, 103, 130,
    59, 86, 113, 57, 84, 111], np.int32)

TAB2 = np.array([
    18, 19, 20, 21, 31, 32, 53, 80, 107, 134, 1, 2, 3, 4, 9, 10, 11, 12,
    27, 28, 29, 30, 52, 79, 106, 133, 51, 78, 105, 132], np.int32)

A1 = np.array([1, 0, 1, 0, 1, 0, 1, 0], np.int32)          # V2, class 1
A2 = np.array([1, 0, 0, 0, 1, 0, 0, 0], np.int32)          # V3, class 2
FS_A2 = np.array([1, 0, 0, 0, 0, 0, 0, 0], np.int32)       # V3, stolen

G1, G2, G3 = 0x1F, 0x1B, 0x15

TAB_CRC = [
    [1, 5, 8, 9, 13, 15, 16, 17, 19, 21, 22, 24, 25, 31, 32, 35, 36, 38,
     40, 43, 44, 45, 48, 49, 50, 51, 53, 54, 56],
    [2, 6, 9, 10, 14, 16, 17, 18, 20, 22, 23, 25, 26, 32, 33, 36, 37, 39,
     41, 44, 45, 46, 49, 50, 51, 52, 54, 55, 57],
    [3, 7, 10, 11, 15, 17, 18, 19, 21, 23, 24, 26, 27, 33, 34, 37, 38,
     40, 42, 45, 46, 47, 50, 51, 52, 53, 55, 56, 58],
    [1, 4, 5, 9, 11, 12, 13, 15, 17, 18, 20, 21, 27, 28, 31, 32, 34, 36,
     39, 40, 41, 44, 45, 46, 47, 49, 50, 52, 57, 59],
    [2, 5, 6, 10, 12, 13, 14, 16, 18, 19, 21, 22, 28, 29, 32, 33, 35, 37,
     40, 41, 42, 45, 46, 47, 48, 50, 51, 53, 58, 60],
    [3, 6, 7, 11, 13, 14, 15, 17, 19, 20, 22, 23, 29, 30, 33, 34, 36, 38,
     41, 42, 43, 46, 47, 48, 49, 51, 52, 54, 59],
    [4, 7, 8, 12, 14, 15, 16, 18, 20, 21, 23, 24, 30, 31, 34, 35, 37, 39,
     42, 43, 44, 47, 48, 49, 50, 52, 53, 55, 60],
    [1, 2, 3, 4, 8, 13, 14, 16, 19, 20, 22, 23, 25, 26, 27, 28, 29, 30,
     32, 33, 34, 36, 37, 40, 41, 42, 44, 48, 50, 53, 56, 57, 58, 59, 60],
]

N0, N1, N2, NCRC = 102, 112, 60, 8     # speech ordered-array sections
STEPS = N1 + N2 + NCRC + 4             # conv-encoder steps (184)


def parity(x: int) -> int:
    return bin(x).count("1") & 1


def puncture_schedule() -> np.ndarray:
    """(STEPS, 3) int32 presence of V1/V2/V3 per conv step (speech)."""
    p = np.zeros((STEPS, 3), np.int32)
    p[:, 0] = 1
    for i in range(N1):
        p[i, 1] = A1[i % 8]
    for i in range(N1, STEPS):
        p[i, 1] = 1
        p[i, 2] = A2[(i - N1) % 8]
    return p


def interleave_index() -> np.ndarray:
    """idx such that transmitted[i] = encoded[idx[i]] (18x24 block)."""
    idx = np.zeros(432, np.int32)
    for a in range(18):
        for b in range(24):
            idx[24 * a + b] = 18 * b + a
    return idx


def crc_matrix() -> np.ndarray:
    """(8, 68) GF(2) parity-check taps over [class2 (60) | crc (8)]."""
    m = np.zeros((8, 68), np.uint8)
    for k in range(8):
        for posn in TAB_CRC[k]:
            m[k, posn - 1] = 1
        m[k, 60 + k] = 1               # received CRC bit itself
    return m
