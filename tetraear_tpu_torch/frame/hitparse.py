"""Native batch engine for the per-hit host frame layer.

The device scan reduces each block to O(hits) candidate 510-bit frame
windows; the host then parses them (burst typing, soft CRC, MAC fields,
frame dicts).  The pure-Python per-hit path is fine for mostly-idle fleets, but a
dense-traffic 10k-carrier fleet produces far more frames per second
than one core parses that way.  This module batches the STATELESS part of that path
through one C call per block (frame/csrc/hitparse.cpp):

    windows (N, 510) uint8 bits -> per-window burst type, stolen flag,
    soft-CRC verdict and extracted MAC PDU fields

after which TetraDecoder.decode_frame only runs the stateful /
dict-assembly remainder (MacParser.apply_mac_fields, SDS, crypto).

Build once per checkout: ``make -C tetraear_tpu_torch/frame/csrc``.  Without
the library the layer transparently falls back to the per-hit Python
oracles (same results, slower per hit).

Equivalence with the Python oracles is pinned by
tests/unit/test_hitparse.py.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tetraear_tpu_torch.frame.mac import MacFields

FRAME_BITS = 510
DATA_MAX_BYTES = 64

_LIB_PATHS = [
    # TETRAEAR_HITPARSE_LIB: explicit path — set by the single-file
    # app bootstrap (tools/build_exe.py)
    *([Path(os.environ["TETRAEAR_HITPARSE_LIB"])]
      if os.environ.get("TETRAEAR_HITPARSE_LIB") else []),
    Path(__file__).parent / "csrc" / "build" / "libhitparse.so",
]


def _load_library():
    if os.environ.get("TETRAEAR_HITPARSE", "") == "0":
        return None       # explicit opt-out (A/B, debugging)
    for p in _LIB_PATHS:
        if p.exists():
            try:
                lib = ctypes.CDLL(str(p))
            except OSError:
                continue
            lib.hitparse_batch.restype = ctypes.c_int
            return lib
    return None


_LIB = _load_library()


def available() -> bool:
    return _LIB is not None


@dataclass
class HitPre:
    """Pre-parsed verdicts for one candidate window, consumed by
    TetraDecoder.decode_frame(pre=...)."""
    is_sync: bool
    crc_ok: bool
    stolen: bool
    mac: MacFields | None


class HitBatch:
    """Struct-of-arrays result of one hitparse_batch call."""

    __slots__ = ("n", "is_sync", "stolen", "crc_ok", "mac_valid",
                 "pdu_type", "enc_mode", "fill_bit", "address", "length",
                 "has_sysinfo", "mcc", "mnc", "cc", "data_len", "data")

    def __init__(self, n: int):
        self.n = n
        self.is_sync = np.zeros(n, np.uint8)
        self.stolen = np.zeros(n, np.uint8)
        self.crc_ok = np.zeros(n, np.uint8)
        self.mac_valid = np.zeros(n, np.uint8)
        self.pdu_type = np.zeros(n, np.uint8)
        self.enc_mode = np.zeros(n, np.uint8)
        self.fill_bit = np.zeros(n, np.uint8)
        self.address = np.zeros(n, np.int64)
        self.length = np.zeros(n, np.int32)
        self.has_sysinfo = np.zeros(n, np.uint8)
        self.mcc = np.zeros(n, np.int32)
        self.mnc = np.zeros(n, np.int32)
        self.cc = np.zeros(n, np.int32)
        self.data_len = np.zeros(n, np.int32)
        self.data = np.zeros((n, DATA_MAX_BYTES), np.uint8)

    def mac_fields(self, i: int) -> MacFields | None:
        """Rebuild the MacFields the Python oracle would return for
        window i (None where extract_mac_fields would reject)."""
        if not self.mac_valid[i]:
            return None
        addr = int(self.address[i])
        sysinfo = ((int(self.mcc[i]), int(self.mnc[i]), int(self.cc[i]))
                   if self.has_sysinfo[i] else None)
        return MacFields(
            pdu_type_int=int(self.pdu_type[i]),
            enc_mode=int(self.enc_mode[i]),
            fill_bit=int(self.fill_bit[i]),
            address=addr if addr >= 0 else None,
            length=int(self.length[i]),
            data_bytes=self.data[i, :int(self.data_len[i])].tobytes(),
            sysinfo=sysinfo,
        )

    def subset(self, idx) -> "HitBatch":
        """New HitBatch with rows idx (fancy index) — the sharded frame
        layer ships per-worker subsets as 15 arrays instead of N
        per-candidate objects (pickle cost is per-object)."""
        out = HitBatch.__new__(HitBatch)
        idx = np.asarray(idx, np.int64)
        out.n = int(len(idx))
        for name in self.__slots__:
            if name != "n":
                setattr(out, name, getattr(self, name)[idx])
        return out

    def __getstate__(self):
        return {name: getattr(self, name) for name in self.__slots__}

    def __setstate__(self, state):
        for name, v in state.items():
            setattr(self, name, v)

    def pre(self, i: int, crc_hint: bool | None = None) -> HitPre:
        """HitPre for window i; a TRUE device CRC hint is trusted for
        normal bursts exactly as burst.parse_burst does."""
        sync = bool(self.is_sync[i])
        crc = bool(self.crc_ok[i])
        if crc_hint and not sync:
            crc = True
        return HitPre(is_sync=sync, crc_ok=crc,
                      stolen=bool(self.stolen[i]),
                      mac=self.mac_fields(i))


def parse_windows(wins: np.ndarray) -> HitBatch | None:
    """Parse (N, 510) candidate windows through the native engine.

    Returns None when the library is not built (callers fall back to
    the per-hit Python path)."""
    if _LIB is None:
        return None
    wins = np.ascontiguousarray(np.asarray(wins, np.uint8))
    if wins.ndim != 2 or wins.shape[1] != FRAME_BITS:
        raise ValueError(f"windows must be (N, {FRAME_BITS}) bits, got "
                         f"{wins.shape}")
    out = HitBatch(wins.shape[0])
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)

    def p(a, t):
        return a.ctypes.data_as(t)

    rc = _LIB.hitparse_batch(
        p(wins, u8), ctypes.c_int64(wins.shape[0]),
        p(out.is_sync, u8), p(out.stolen, u8), p(out.crc_ok, u8),
        p(out.mac_valid, u8), p(out.pdu_type, u8), p(out.enc_mode, u8),
        p(out.fill_bit, u8), p(out.address, i64), p(out.length, i32),
        p(out.has_sysinfo, u8), p(out.mcc, i32), p(out.mnc, i32),
        p(out.cc, i32), p(out.data_len, i32), p(out.data, u8))
    if rc != 0:
        raise RuntimeError(f"hitparse_batch failed: rc={rc}")
    return out
