"""The standard's speech decoder, as the reference runs it.

``frozen/csrc`` holds the ETSI EN 300 395-2 ACELP decoder in C++ (a
frozen copy of the program's host codec) and ``speech_ref.cpp``, which
decodes one carrier's frames in order on one state.  It is built with
g++ at first use into ``build/benchmark/refspeech/<hash of the
sources>/`` under the checkout and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "frozen" / "csrc"
SOURCES = ("etsi_acelp_dec.cpp", "speech_ref.cpp")
_LIB = None


def _build_dir() -> Path:
    h = hashlib.sha256()
    for f in sorted(SRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    root = Path(__file__).resolve().parents[2]
    return root / "build" / "benchmark" / "refspeech" / h.hexdigest()[:16]


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    out = _build_dir() / "libetsidec.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", "-O2", "-fPIC", "-std=c++17", "-shared",
                        "-o", str(tmp)] + [str(SRC / s) for s in SOURCES],
                       check=True)
        os.replace(tmp, out)
    so = ctypes.CDLL(str(out))
    p16 = ctypes.POINTER(ctypes.c_int16)
    so.ref_decode_stream.argtypes = [p16, ctypes.c_int32, p16]
    so.ref_decode_stream.restype = ctypes.c_int
    _LIB = so
    return so


def decode(frames: np.ndarray) -> np.ndarray:
    """(n, 138) int16 [BFI, 137 parameter bits] of one carrier, in order
    -> (n * 240,) int16 PCM."""
    fr = np.ascontiguousarray(np.asarray(frames, np.int16))
    out = np.zeros(len(fr) * 240, np.int16)
    p16 = ctypes.POINTER(ctypes.c_int16)
    rc = lib().ref_decode_stream(fr.ctypes.data_as(p16), len(fr),
                                 out.ctypes.data_as(p16))
    if rc != 0:
        raise RuntimeError(f"reference speech decode failed at frame {rc}")
    return out
