"""The port's host libraries, built with g++ at first use.

Two C++ libraries serve the host side of the receive path, each from its
own ``csrc`` directory of the port and its Makefile:

  ``frame``  frame/csrc -> frame/csrc/build/libhitparse.so, the per-hit
             frame parser (burst type, soft CRC and MAC fields of every
             candidate window of a block in one call; frame/hitparse.py)
  ``voice``  voice/csrc -> voice/csrc/build/libtetracodec.so, the ETSI
             speech codec (channel coding and ACELP; voice/codec.py)

``build(name)`` runs ``make`` into a private directory and renames the
library into ``build/``, under a file lock, so that several processes
that reach the first use together (test workers) compile once and never
load a half-written file.  A library newer than every source of its
directory is taken as it is.  A failed build raises with the compiler's
log.

``hitparse()`` and ``codec()`` return the two binding modules with their
library loaded.  Both modules load their library when they are imported
(they are host copies of the JAX package's); a module imported before
the build is given the library here.  ``TETRAEAR_HITPARSE=0`` still
switches the native parser off: an explicit choice, not a fallback.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent
LIBS = {"frame": ("frame/csrc", "libhitparse.so"),
        "voice": ("voice/csrc", "libtetracodec.so")}
build_info: dict = {}          # name -> {"path", "seconds", "built"}
                               # of the first call, or of the build


def library_path(name: str) -> Path:
    sub, lib = LIBS[name]
    return _ROOT / sub / "build" / lib


def _stale(lib: Path, src: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in src.iterdir() if p.is_file())
    return lib.stat().st_mtime < newest


def build(name: str) -> Path:
    """Build library ``name`` ("frame" or "voice") unless it is up to
    date; returns its path."""
    sub, libname = LIBS[name]
    src = _ROOT / sub
    lib = library_path(name)
    t0 = time.time()
    built = False
    if _stale(lib, src):
        lib.parent.mkdir(exist_ok=True)
        with open(lib.parent / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _stale(lib, src):
                _make(src, lib)
                built = True
    if built or name not in build_info:
        build_info[name] = {"path": str(lib), "seconds": time.time() - t0,
                            "built": built}
    return lib


def _make(src: Path, lib: Path) -> None:
    if shutil.which("make") is None:
        raise RuntimeError(f"make not found: {lib.name} is built with "
                           f"make -C {src}")
    tmp = Path(tempfile.mkdtemp(prefix="tmp", dir=lib.parent))
    try:
        r = subprocess.run(["make", "-C", str(src), f"BUILD={tmp}"],
                           capture_output=True, text=True, timeout=600)
        if r.returncode or not (tmp / lib.name).exists():
            raise RuntimeError(f"building {lib.name} failed "
                               f"(make -C {src}, rc {r.returncode}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp / lib.name, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def hitparse():
    """frame.hitparse with the native parser built and loaded (unless
    TETRAEAR_HITPARSE=0 switches it off)."""
    build("frame")
    from tetraear_tpu_torch.frame import hitparse as mod
    if mod._LIB is None:
        mod._LIB = mod._load_library()
    return mod


def codec():
    """voice.codec with the codec library built and loaded; raises when
    it cannot be loaded."""
    build("voice")
    from tetraear_tpu_torch.voice import codec as mod
    if mod._LIB is None:
        mod._LIB = mod._load_library()
    if mod._LIB is None:
        raise RuntimeError(f"the voice codec library "
                           f"{library_path('voice')} does not load")
    return mod
