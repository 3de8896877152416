"""ETSI EN 300 395-2 ACELP decoder tables (numpy view).

Parsed at import from voice/csrc/etsi_acelp_tables.h — the single
source of truth the C++ codec compiles against — so the JAX decoder
(voice/jspeech.py) can never drift from the native one.  The header's
values were themselves recovered from the ETSI reference binary and are
pinned by tests/codec/test_acelp_oracle.py.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np

_HEADER = pathlib.Path(__file__).parent / "csrc" / "etsi_acelp_tables.h"


def _parse() -> dict:
    text = _HEADER.read_text()
    out = {}
    for m in re.finditer(
            r"static const short (\w+)\[(\d+)\]\s*=\s*\{([^}]*)\};", text):
        name, n, body = m.group(1), int(m.group(2)), m.group(3)
        vals = np.array([int(v) for v in body.split(",") if v.strip()],
                        np.int32)
        if vals.size != n:
            raise ValueError(f"{name}: parsed {vals.size} values, "
                             f"declared {n}")
        out[name] = vals
    return out


_T = _parse()

DICO1_CLSP = _T["ETSI_DICO1_CLSP"].reshape(256, 3)
DICO2_CLSP = _T["ETSI_DICO2_CLSP"].reshape(512, 3)
DICO3_CLSP = _T["ETSI_DICO3_CLSP"].reshape(512, 4)
T_QUA_ENER = _T["ETSI_T_QUA_ENER"].reshape(64, 2)
COEF1 = _T["ETSI_COEF1"]
COEF2 = _T["ETSI_COEF2"]
TAB_LOG2 = _T["ETSI_TAB_LOG2"]
TAB_POW2 = _T["ETSI_TAB_POW2"]
LSPOLD_INIT = _T["ETSI_LSPOLD_INIT"]

# serial-bit widths of the 23 speech parameters (Bits2prm layout;
# voice/csrc/etsi_acelp_dec.cpp kEtsiBitno)
BITNO = np.array([8, 9, 9, 8, 14, 1, 1, 6, 5, 14, 1, 1, 6, 5, 14, 1, 1,
                  6, 5, 14, 1, 1, 6], np.int32)
assert int(BITNO.sum()) == 137


def bits2prm_matrix() -> np.ndarray:
    """(137, 23) int32 weight matrix: prm = serial_bits @ W (bits in
    {0,1}; each parameter's bits are MSB-first contiguous)."""
    w = np.zeros((137, 23), np.int32)
    off = 0
    for j, nb in enumerate(BITNO):
        for k in range(nb):
            w[off + k, j] = 1 << (int(nb) - 1 - k)
        off += int(nb)
    return w
