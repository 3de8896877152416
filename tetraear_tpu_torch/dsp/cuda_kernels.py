"""The receive path's hand-written CUDA kernels, their plain PyTorch
versions and their build.

Each wrapper replaces one Pallas kernel of
``tetraear_tpu/dsp/pallas_kernels.py``:

  ``fft2p_planes_spliced``  csrc/fft2p.cu         fft2p_planes_spliced
                                                   (+ fft2p_planes, o2 = 0)
  ``fft2p_pass1``           csrc/fft2p.cu         the pass-1 probe of
                                                   perf/fft2p_stage_probe.py
  ``band_synth``            csrc/band_synth.cu    band_synth(phasor_drop=)
  ``band_synth_y``          csrc/band_synth.cu    band_synth (no phasor)
  ``band_synth_ph``         csrc/band_synth.cu    band_synth(y_out=False)
  ``fused_backhalf``        csrc/backhalf.cu      fused_backhalf
  ``frame_scan_even``       csrc/frame_scan.cu    frame_scan_even
  ``band_extract_rows``     csrc/band_extract.cu  band_extract_rows
  ``band_extract``          csrc/band_extract.cu  band_extract

The first, third and sixth carry the fused receive path; the classic
chain runs ``band_synth_y`` (or an extraction kernel) and
``frame_scan_even``.  The other measurement instruments (``bit_place``,
``ops_probe``, ``iir_recursion``, ``int_rate``: csrc/probes.cu;
``synth_chain``: csrc/speech.cu) have
their wrappers in ``dsp/probes.py``, and the TEA key search
(``tea_search``: csrc/tea.cu) has its wrappers in ``crypto/batch.py``
and its plaintexts' scores (``key_score``: csrc/keyscore.cu) theirs in
``crypto/keyscore.py``,
the speech channel decoder (``viterbi_decode``: csrc/viterbi.cu) its
wrapper in ``voice/viterbi.py``, the ACELP speech decoder
(``acelp_decode``: csrc/speech.cu + speech.cuh) its wrapper in
``voice/speech.py``; all share this module's build,
dispatch rule and launch counts.

Dispatch rule: a wrapper given CPU tensors runs the plain PyTorch
version of its function; given CUDA tensors it launches the kernel or
raises.  There is no fallback between the two.  ``launches`` counts the
kernel launches of each wrapper (the plain versions do not count).

The kernels are CUDA C++ for sm_90a with a plain C interface, compiled
by ``nvcc`` at first use into ``build/tetraear_tpu_torch/`` of the
checkout (one ``nvcc -c`` per source, all started together, then one
link; keyed by a hash of the sources and flags) and loaded with
ctypes.  Nothing is compiled or loaded at import time.  Launches go on
PyTorch's current stream and do not synchronise; a wrapper may drop its
scratch tensors on return because the caching allocator hands freed
memory only to work queued later on the same stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from tetraear_tpu_torch.dsp import framescan

TAILBITS = 1200

launches = {"fft2p": 0, "fft2p_pass1": 0, "band_synth": 0, "band_synth_y": 0,
            "band_synth_ph": 0, "fused_backhalf": 0, "frame_scan_even": 0,
            "band_extract_rows": 0, "band_extract": 0, "bit_place": 0,
            "ops_probe": 0, "iir_recursion": 0, "int_rate": 0,
            "tea_search": 0, "key_score": 0, "viterbi_decode": 0,
            "acelp_decode": 0, "synth_chain": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("common.cuh", "radix.cuh", "scan.cuh", "place.cuh", "fft2p.cu",
            "band_synth.cu", "backhalf.cu", "frame_scan.cu",
            "band_extract.cu", "probes.cu", "tea.cu", "keyscore.cu",
            "viterbi.cu", "speech.cuh", "speech.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "tetraear_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# -fmad=false: no multiply-add contraction, so every float expression
# rounds as the plain PyTorch version's separate ops do.  The sources
# named here are held to a tolerance instead and keep contraction on.
_FMAD_SOURCES = ("fft2p.cu", "band_synth.cu")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS if name in _FMAD_SOURCES else (*NVCC_FLAGS,
                                                     "-fmad=false")

_lib = None
_build_lock = threading.Lock()
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library.

    Threads of one process share one build: the first caller compiles
    and the others wait for it (the GUI's capture thread makes the first
    call off the main thread, and the object files are named by process
    only)."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is None:
            _lib = _compile_and_load()
    return _lib


def _compile_and_load() -> ctypes.CDLL:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(" ".join((name, *_flags(name))).encode())
        h.update((_CSRC / name).read_bytes())
    key = h.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libtetraear_kernels_{key}.so"
    t0 = time.time()
    log = ""
    if not so.exists():
        # one compile per source, all started together, then one link
        tag = f"{key}.{os.getpid()}"
        units = [name for name in _SOURCES if name.endswith(".cu")]
        objs = [BUILD_DIR / f"{Path(name).stem}.{tag}.o" for name in units]
        procs = [subprocess.Popen(
            [_nvcc(), *_flags(name), "-c", "-o", str(obj),
             str(_CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(units, objs)]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        failed = [name for name, proc in zip(units, procs)
                  if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        r = subprocess.run(
            [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        log += r.stdout + r.stderr
        if r.returncode:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{log}")
        os.replace(tmp, so)
        for obj in objs:
            obj.unlink()
    lib = ctypes.CDLL(str(so))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tt_fft2p.argtypes = [vp] * 8 + [cl] * 2 + [ci] * 6 + [vp]
    lib.tt_fft2p_pass1.argtypes = [vp] * 6 + [cl] + [ci] * 5 + [vp]
    lib.tt_band_synth.argtypes = ([vp, cl, vp, ci, vp, vp, vp, vp, vp]
                                  + [ci] * 4 + [vp])
    lib.tt_fused_backhalf.argtypes = [vp] * 14 + [ci] * 6 + [vp]
    lib.tt_frame_scan_even.argtypes = [vp] * 4 + [ci] * 4 + [vp]
    lib.tt_band_extract_staged.argtypes = [vp] * 3 + [ci] * 2 + [vp]
    lib.tt_band_extract_pairs.argtypes = [vp] * 3 + [ci] * 2 + [vp]
    lib.tt_bit_place.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    lib.tt_ops_probe.argtypes = [ci, vp, vp, vp, ci, ci, vp]
    lib.tt_iir_recursion.argtypes = [vp] * 4 + [ci] * 2 + [vp]
    lib.tt_int_rate.argtypes = [ci, ci, ctypes.c_uint, vp, ci, vp]
    lib.tt_tea.argtypes = [ci] + [vp] * 4 + [ctypes.c_uint] * 10 + [vp, vp]
    lib.tt_key_score.argtypes = [vp] * 5 + [ctypes.c_uint] * 3 + [vp, vp]
    lib.tt_viterbi.argtypes = [vp] * 4 + [ci] * 2 + [vp]
    lib.tt_acelp.argtypes = [vp] * 3 + [ci] * 2 + [vp] * 11
    lib.tt_synth_chain.argtypes = [vp, vp, ci] + [vp] * 4
    for fn in (lib.tt_fft2p, lib.tt_fft2p_pass1, lib.tt_band_synth,
               lib.tt_fused_backhalf, lib.tt_frame_scan_even,
               lib.tt_band_extract_staged, lib.tt_band_extract_pairs,
               lib.tt_bit_place, lib.tt_ops_probe, lib.tt_iir_recursion,
               lib.tt_int_rate, lib.tt_tea, lib.tt_key_score, lib.tt_viterbi,
               lib.tt_acelp,
               lib.tt_synth_chain):
        fn.restype = ci
    build_info.update(path=str(so), seconds=time.time() - t0, log=log)
    return lib


def _launch(name: str, dev: torch.device, fn, *args) -> None:
    """Count and launch kernel ``name`` on ``dev``'s current stream (with
    ``dev`` the current device); raise on the C entry's CUDA error."""
    launches[name] += 1
    with torch.cuda.device(dev):
        rc = fn(*args, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name(dev)})")


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# argument checks and dispatch
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, shape: tuple, dtype) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _route(*tensors) -> str:
    """'cpu' (plain version) or 'cuda' (kernel) from the tensors' device;
    mixed or other devices raise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError("tensors on several devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


_TW_CACHE: dict = {}


def _twiddles(n: int, dev: torch.device) -> torch.Tensor:
    """(n/2, 2) float32 table exp(-2 pi i k / n), from float64."""
    key = (n, str(dev))
    if key not in _TW_CACHE:
        k = np.arange(n // 2)
        w = np.exp(-2j * np.pi * k / n)
        tab = np.stack([w.real, w.imag], axis=1).astype(np.float32)
        _TW_CACHE[key] = torch.from_numpy(tab).to(dev)
    return _TW_CACHE[key]


def _log2_exact(n: int, what: str) -> int:
    lg = int(round(math.log2(n))) if n > 0 else -1
    if n <= 0 or 1 << lg != n:
        raise ValueError(f"{what}={n} must be a power of two")
    return lg


# ---------------------------------------------------------------------------
# kernel 1: wideband FFT, four-step, spliced
# ---------------------------------------------------------------------------

class Fft2pPlan(NamedTuple):
    """Geometry of the two-pass transform of la * lb points: pass 1 runs
    la-point transforms on t1 adjacent columns a block, pass 2 lb-point
    transforms on t2 adjacent rows; the scratch G between them is
    (la / t2, lb, t2) complex.  Pass 2 runs as thread block clusters of
    cl2 neighbouring tiles that store runs of t2 * cl2 bins.  The
    four-step twiddle's phase splits at bit ``hbits``."""
    la: int
    lb: int
    t1: int
    t2: int
    cl2: int
    hbits: int


def fft2p_plan(n1: int, n2: int) -> Fft2pPlan:
    """The plan of the (n2, n1) window: tiles of at most 16384 points
    (139 KB of shared memory with the padding), at most 16 wide; pass 2
    in clusters (of at most 8 blocks) where its tile is under 8 wide,
    so that its stores are runs of 32 bytes.

    The paths use this one choice per (n1, n2).  The C entries take the
    plan's fields as run-time geometry, the two passes' lengths exchanged
    and clusters of 8 included, only so that ``dsp/tune_fft2p.py`` can
    time other tilings against it; neither beat it on the H100."""
    la, lb = n2, n1

    def width(length, other):
        return max(1, min(16, 16384 // length, other))

    lgn = _log2_exact(la, "n2") + _log2_exact(lb, "n1")
    t2 = width(lb, la)
    return Fft2pPlan(la, lb, width(la, lb), t2,
                     max(1, min(8 // t2, la // t2)), (lgn + 1) // 2)


def fourstep_tables(nfft: int, hbits: int) -> tuple:
    """(whi, wlo) float32 (., 2) tables, made in float64, whose product
    whi[m >> hbits] * wlo[m & (2^hbits - 1)] is exp(-2 pi i m / nfft)."""
    def table(k):
        w = np.exp(-2j * np.pi * k / nfft)
        return np.stack([w.real, w.imag], axis=1).astype(np.float32)
    return (table(np.arange(nfft >> hbits, dtype=np.float64)
                  * float(1 << hbits)),
            table(np.arange(1 << hbits, dtype=np.float64)))


def _fourstep_tables(nfft: int, hbits: int, dev: torch.device) -> tuple:
    key = ("fourstep", nfft, hbits, str(dev))
    if key not in _TW_CACHE:
        _TW_CACHE[key] = tuple(torch.from_numpy(t).to(dev)
                               for t in fourstep_tables(nfft, hbits))
    return _TW_CACHE[key]


def _fft2p_args(tail_p, x_p, n1, n2, wrap_k1) -> int:
    """Shape and range checks of the two fft2p wrappers; returns o2."""
    o2 = tail_p.shape[1] if tail_p.dim() == 3 else -1
    _check(tail_p, "tail_p", (2, o2, n1), torch.float32)
    _check(x_p, "x_p", (2, n2 - o2, n1), torch.float32)
    if n1 % 128 or n2 % 128 or not 0 <= wrap_k1 <= n1:
        raise ValueError(f"fft2p needs 128 | n1, n2 and wrap <= n1 "
                         f"(got {n1}, {n2}, {wrap_k1})")
    return o2


def _fft2p_kernel_args(dev, n1, n2, plan) -> tuple:
    """What the two C entries share: (scratch G, the two four-step
    tables, the trailing geometry arguments)."""
    if max(n1, n2) > 16384:
        raise ValueError(f"fft2p kernel: n1, n2 <= 16384 (got {n1}, {n2})")
    g = torch.empty((plan.la // plan.t2, plan.lb, plan.t2, 2),
                    dtype=torch.float32, device=dev)
    whi, wlo = _fourstep_tables(n1 * n2, plan.hbits, dev)
    geom = (_log2_exact(plan.la, "la"), _log2_exact(plan.lb, "lb"),
            _log2_exact(plan.t1, "t1"), _log2_exact(plan.t2, "t2"),
            _log2_exact(plan.cl2, "cl2"), plan.hbits)
    return g, whi, wlo, geom


def fft2p_planes_spliced(tail_p: torch.Tensor, x_p: torch.Tensor, n1: int,
                         n2: int, wrap_k1: int = 0) -> torch.Tensor:
    """Forward nfft-point DFT (nfft = n1 n2) of the overlap-save window
    [tail rows ++ block rows] -> natural-order spectrum planes.

    tail_p (2, o2, n1) and x_p (2, n2 - o2, n1) are planar float32 rows
    of the (n2, n1) row-major window; o2 = 0 is the unspliced transform
    (the JAX ``fft2p_planes``).  Returns (2, (n1 + wrap_k1) n2 / 128,
    128) float32: bins 0..nfft-1, then bins 0..wrap_k1 n2 - 1 again.

    Replaces ``fft2p_planes_spliced`` / ``fft2p_planes``
    (tetraear_tpu/dsp/pallas_kernels.py), which run the four-step
    transform as bf16x3 MXU matmuls; the port runs float32 FFTs.
    Bound: device memory, two read+write passes over 8 nfft bytes; what
    keeps a pass from that rate is shared-memory traffic and barriers
    between butterfly stages, and runs shorter than a 32-byte sector on
    the strided side of each pass.  Design (csrc/fft2p.cu): radix-16 and
    radix-8 butterflies in registers with one to three exchanges through
    a padded shared-memory tile, the first stage fed from device memory
    and the last writing it; the four-step twiddle from two float32
    tables (``fourstep_tables``); the scratch G interleaved and tiled so
    that both passes move it in long runs; where pass 2's tile is too
    narrow for 32-byte stores, a thread block cluster shares its last
    stage through distributed shared memory (``fft2p_plan``)."""
    o2 = _fft2p_args(tail_p, x_p, n1, n2, wrap_k1)
    if _route(tail_p, x_p) == "cpu":
        return fft2p_plain(tail_p, x_p, n1, n2, wrap_k1)
    plan = fft2p_plan(n1, n2)
    dev = x_p.device
    g, whi, wlo, geom = _fft2p_kernel_args(dev, n1, n2, plan)
    lib = build()
    out = torch.empty((2, (n1 + wrap_k1) * n2 // 128, 128),
                      dtype=torch.float32, device=dev)
    _launch("fft2p", dev, lib.tt_fft2p, _ptr(tail_p), _ptr(x_p), _ptr(g),
            _ptr(out), _ptr(_twiddles(plan.la, dev)),
            _ptr(_twiddles(plan.lb, dev)), _ptr(whi), _ptr(wlo), o2 * n1,
            wrap_k1 * n2, *geom)
    return out


def fft2p_plain(tail_p, x_p, n1, n2, wrap_k1):
    """Plain version of fft2p_planes_spliced: torch.fft of the window."""
    win = torch.cat([tail_p, x_p], dim=1).reshape(2, n1 * n2)
    big = torch.fft.fft(torch.complex(win[0], win[1]))
    ext = torch.cat([big, big[:wrap_k1 * n2]])
    return torch.stack([ext.real, ext.imag]).reshape(2, -1, 128)


def fft2p_pass1(tail_p: torch.Tensor, x_p: torch.Tensor, n1: int,
                n2: int) -> torch.Tensor:
    """Pass 1 of fft2p_planes_spliced alone: the transforms over the
    window's columns times the four-step twiddle, as the scratch G that
    pass 2 reads: (la / t2, lb, t2, 2) float32 with G[k2 // t2, i1,
    k2 % t2] = w_nfft^(i1 k2) sum_i2 window[i1 + lb i2] w_la^(i2 k2)
    (``fft2p_plan`` gives la, lb, t2).  It localises an error to one
    pass and times the passes apart.

    Replaces the private pass-1 ``pallas_call`` of
    perf/fft2p_stage_probe.py.  Bound: device memory, 8 nfft bytes in
    and out.  The launch is the first of csrc/fft2p.cu's two."""
    _fft2p_args(tail_p, x_p, n1, n2, 0)
    if _route(tail_p, x_p) == "cpu":
        return fft2p_pass1_plain(tail_p, x_p, n1, n2)
    plan = fft2p_plan(n1, n2)
    dev = x_p.device
    g, whi, wlo, geom = _fft2p_kernel_args(dev, n1, n2, plan)
    lib = build()
    _launch("fft2p_pass1", dev, lib.tt_fft2p_pass1, _ptr(tail_p), _ptr(x_p),
            _ptr(g), _ptr(_twiddles(plan.la, dev)), _ptr(whi), _ptr(wlo),
            tail_p.shape[1] * n1, *geom[:4], plan.hbits)
    return g


def fft2p_pass1_plain(tail_p, x_p, n1, n2):
    """Plain version of fft2p_pass1: torch.fft over the columns, the
    twiddle as the product of the two float32 tables, G's tiling."""
    plan = fft2p_plan(n1, n2)
    la, lb, t2 = plan.la, plan.lb, plan.t2
    dev = x_p.device
    win = torch.cat([tail_p, x_p], dim=1).reshape(2, la, lb)
    cols = torch.fft.fft(torch.complex(win[0], win[1]), dim=0)   # (k2, i1)
    whi, wlo = (torch.view_as_complex(t)
                for t in _fourstep_tables(la * lb, plan.hbits, dev))
    m = (torch.arange(la, device=dev)[:, None]
         * torch.arange(lb, device=dev)[None, :]) % (la * lb)
    g = cols * (whi[m >> plan.hbits] * wlo[m & ((1 << plan.hbits) - 1)])
    g = g.reshape(la // t2, t2, lb).transpose(1, 2).contiguous()
    return torch.view_as_real(g)


def fft2p_pass2_plain(g, n1, n2, wrap_k1):
    """Plain pass 2 over fft2p_pass1's G: torch.fft over i1, bins
    k2 + la k1 in natural order, the wrap rows appended."""
    plan = fft2p_plan(n1, n2)
    rows = torch.view_as_complex(g).transpose(1, 2).reshape(plan.la,
                                                            plan.lb)
    big = torch.fft.fft(rows, dim=1).t().reshape(-1)             # (k1, k2)
    ext = torch.cat([big, big[:wrap_k1 * n2]])
    return torch.stack([ext.real, ext.imag]).reshape(2, -1, 128)


# ---------------------------------------------------------------------------
# kernel 2: band synthesis + timing phasor
# ---------------------------------------------------------------------------

def _band_synth_args(planes, h1_planes, row_starts, d_shift, m1c, m2re,
                     m2im, twre, twim, rows_per_band) -> tuple:
    """Shape, type and range checks shared by the three band_synth
    forms; returns (C, P, D, R)."""
    c = row_starts.shape[0] if row_starts.dim() == 1 else -1
    p = int(rows_per_band)
    n_rolls = h1_planes.shape[1] if h1_planes.dim() == 4 else -1
    r_rows = planes.shape[1] if planes.dim() == 3 else -1
    _check(planes, "planes", (2, r_rows, 128), torch.float32)
    _check(h1_planes, "h1_planes", (2, n_rolls, p, 128), torch.float32)
    _check(row_starts, "row_starts", (c,), torch.int32)
    _check(d_shift, "d_shift", (c,), torch.int32)
    _check(m1c, "m1c", (2 * p, 2 * p), torch.float32)
    for name, t in (("m2re", m2re), ("m2im", m2im)):
        _check(t, name, (128, 128), torch.float32)
    for name, t in (("twre", twre), ("twim", twim)):
        _check(t, name, (128, p), torch.float32)
    return c, p, n_rolls, r_rows


def _band_synth_launch(name, mode, planes, h1_planes, row_starts, d_shift,
                       c, p, n_rolls, r_rows, phasor_drop) -> tuple:
    """Launch csrc/band_synth.cu in ``mode`` (0: y and phasor, 1: y
    only, 2: phasor only); returns (y or None, ph or None)."""
    lg = _log2_exact(128 * p, "n_band")
    if not 7 <= lg <= 14:
        raise ValueError(f"band_synth kernel: 128 <= n_band <= 16384 "
                         f"(got {128 * p})")
    dev = planes.device
    lib = build()
    y = (torch.empty((c, 2, 128, p), dtype=torch.float32, device=dev)
         if mode != 2 else None)
    ph = (torch.empty((c, 1, 128), dtype=torch.float32, device=dev)
          if mode != 1 else None)
    _launch(name, dev, lib.tt_band_synth, _ptr(planes), r_rows * 128,
            _ptr(h1_planes), n_rolls, _ptr(row_starts), _ptr(d_shift),
            _ptr(y) if y is not None else None,
            _ptr(ph) if ph is not None else None,
            _ptr(_twiddles(128 * p, dev)), lg, int(phasor_drop), c, mode)
    return y, ph


def band_synth(planes: torch.Tensor, h1_planes: torch.Tensor,
               row_starts: torch.Tensor, d_shift: torch.Tensor,
               m1c: torch.Tensor, m2re: torch.Tensor, m2im: torch.Tensor,
               twre: torch.Tensor, twim: torch.Tensor, rows_per_band: int,
               phasor_drop: int) -> tuple:
    """Per carrier: gather P = rows_per_band spectrum rows at
    row_starts[c], multiply by h1_planes[:, d_shift[c]], inverse n_band
    DFT (n_band = 128 P), and the Oerder-Meyr phasor
    sum_{k >= phasor_drop} |y_k|^2 e^{-j pi k / 2}.

    planes (2, R, 128) f32, h1_planes (2, D, P, 128) f32, row_starts and
    d_shift (C,) int32, m1c (2P, 2P), m2re/m2im (128, 128), twre/twim
    (128, P) f32 (the channelizer's Cooley-Tukey tables).  Returns
    y (C, 2, 128, P) f32 — sample k = s + P t at [c, :, t, s] — and
    ph (C, 1, 128) f32 with the phasor in lanes 0/1.  row_starts must
    keep every band inside the planes (the channelizer's do).

    Replaces ``band_synth(..., phasor_drop=drop)``
    (tetraear_tpu/dsp/pallas_kernels.py).  Bound: device memory (64 KB
    in and out per carrier; the rolled filter table stays in L2).
    Design: csrc/band_synth.cu runs the transform as 2 to 4 radix-8 /
    radix-16 stages in registers (``band_plan``), the first fed from
    device memory with the filter product, the last scaling, summing the
    phasor and storing y, with a padded shared-memory tile for the
    exchanges between stages only; ``band_synth_staged`` is that order of
    steps in plain torch.  The Cooley-Tukey tables define the transform
    for the plain version only."""
    c, p, n_rolls, r_rows = _band_synth_args(
        planes, h1_planes, row_starts, d_shift, m1c, m2re, m2im, twre,
        twim, rows_per_band)
    if phasor_drop % 4 or p % 4:
        raise ValueError("phasor fusion needs drop % 4 == 0 and "
                         f"P % 4 == 0 (drop={phasor_drop}, P={p})")
    if _route(planes, h1_planes, row_starts, d_shift, m1c, m2re, m2im,
              twre, twim) == "cpu":
        return band_synth_plain(planes, h1_planes, row_starts, d_shift,
                                m1c, m2re, m2im, twre, twim, p,
                                phasor_drop)
    return _band_synth_launch("band_synth", 0, planes, h1_planes,
                              row_starts, d_shift, c, p, n_rolls, r_rows,
                              phasor_drop)


def band_synth_y(planes: torch.Tensor, h1_planes: torch.Tensor,
                 row_starts: torch.Tensor, d_shift: torch.Tensor,
                 m1c: torch.Tensor, m2re: torch.Tensor, m2im: torch.Tensor,
                 twre: torch.Tensor, twim: torch.Tensor,
                 rows_per_band: int) -> torch.Tensor:
    """band_synth without the phasor: returns y (C, 2, 128, P) only; the
    kernel neither computes nor writes the phasor.  The classic chain's
    channelizer step calls it (FFTChannelizer.step).

    Replaces ``band_synth`` without ``phasor_drop`` (_band_synth_kernel,
    tetraear_tpu/dsp/pallas_kernels.py).  Bound and design as
    band_synth; a compile-time variant of csrc/band_synth.cu."""
    c, p, n_rolls, r_rows = _band_synth_args(
        planes, h1_planes, row_starts, d_shift, m1c, m2re, m2im, twre,
        twim, rows_per_band)
    if _route(planes, h1_planes, row_starts, d_shift, m1c, m2re, m2im,
              twre, twim) == "cpu":
        return band_synth_plain(planes, h1_planes, row_starts, d_shift,
                                m1c, m2re, m2im, twre, twim, p, None)[0]
    return _band_synth_launch("band_synth_y", 1, planes, h1_planes,
                              row_starts, d_shift, c, p, n_rolls, r_rows,
                              0)[0]


def band_synth_ph(planes: torch.Tensor, h1_planes: torch.Tensor,
                  row_starts: torch.Tensor, d_shift: torch.Tensor,
                  m1c: torch.Tensor, m2re: torch.Tensor, m2im: torch.Tensor,
                  twre: torch.Tensor, twim: torch.Tensor,
                  rows_per_band: int, phasor_drop: int) -> torch.Tensor:
    """band_synth's phasor alone: returns ph (C, 1, 128); the synthesis
    runs in shared memory and y never reaches device memory.

    Replaces ``band_synth(..., phasor_drop=drop, y_out=False)``
    (_band_synth_phonly_kernel, tetraear_tpu/dsp/pallas_kernels.py), the
    measurement variant that prices a scalar pre-pass.  Bound: device
    memory, 64 KB in per carrier.  A compile-time variant of
    csrc/band_synth.cu."""
    c, p, n_rolls, r_rows = _band_synth_args(
        planes, h1_planes, row_starts, d_shift, m1c, m2re, m2im, twre,
        twim, rows_per_band)
    if phasor_drop % 4 or p % 4:
        raise ValueError("phasor fusion needs drop % 4 == 0 and "
                         f"P % 4 == 0 (drop={phasor_drop}, P={p})")
    if _route(planes, h1_planes, row_starts, d_shift, m1c, m2re, m2im,
              twre, twim) == "cpu":
        return band_synth_plain(planes, h1_planes, row_starts, d_shift,
                                m1c, m2re, m2im, twre, twim, p,
                                phasor_drop)[1]
    return _band_synth_launch("band_synth_ph", 2, planes, h1_planes,
                              row_starts, d_shift, c, p, n_rolls, r_rows,
                              phasor_drop)[1]


def band_plan(n_band: int) -> tuple:
    """log2 of the radix of each stage of the kernel's n_band-point
    transform, first stage first: radix-8 stages, then radix-16 ones
    (csrc/radix.cuh ``make_plan``)."""
    lgn = _log2_exact(n_band, "n_band")
    a = 0
    while (lgn - 3 * a) % 4:
        a += 1
    return (3,) * a + (4,) * ((lgn - 3 * a) // 4)


def band_synth_staged(planes, h1_planes, row_starts, d_shift, p,
                      phasor_drop):
    """The kernel's own order of steps in plain torch (complex64): the
    filter product with re and im exchanged (the inverse transform is the
    forward one on exchanged data), ``band_plan``'s stages in place,
    decimation in frequency, each followed by its twiddles from the
    float32 table; the last stage's outputs go to the bins that its tile
    positions' digits spell (the digit reversal), are exchanged back and
    scaled by 1 / n_band; the phasor sums each bin's power under the
    weight of k & 3.  Returns (y (C, 2, 128, P), ph (C, 1, 128) or None
    when ``phasor_drop`` is None).  A check of the design on the CPU: no
    path calls it."""
    c = row_starts.shape[0]
    dev = planes.device
    n = 128 * p
    plan = band_plan(n)
    lgn = sum(plan)
    idx = (row_starts.long()[:, None] * 128
           + torch.arange(n, device=dev)[None, :])              # (C, n)
    flat = planes.reshape(2, -1)
    nre, nim = flat[0][idx], flat[1][idx]
    h = h1_planes[:, d_shift.long()].reshape(2, c, n)
    tile = torch.complex(nre * h[1] + nim * h[0], nre * h[0] - nim * h[1])
    half = torch.view_as_complex(_twiddles(n, dev))
    circle = torch.cat([half, -half])                   # exp(-2 pi i t / n)
    lgns = lgn
    for lgr in plan[:-1]:
        r, sub = 1 << lgr, 1 << (lgns - lgr)
        v = torch.fft.fft(tile.reshape(c, -1, r, sub), dim=2)
        j = torch.arange(sub, device=dev)[None, :]
        m = torch.arange(r, device=dev)[:, None]
        tile = (v * circle[(j * m) << (lgn - lgns)]).reshape(c, n)
        lgns -= lgr
    r = 1 << plan[-1]
    v = torch.fft.fft(tile.reshape(c, n // r, r), dim=2)
    base = torch.arange(n // r, device=dev) * r          # tile positions
    k_low = torch.zeros_like(base)
    cum = 0
    for lgr in plan[:-1]:
        digit = (base >> (lgn - cum - lgr)) & ((1 << lgr) - 1)
        k_low = k_low + (digit << cum)
        cum += lgr
    k = k_low[:, None] + (torch.arange(r, device=dev)[None, :] << cum)
    out = torch.empty((c, n), dtype=tile.dtype, device=dev)
    out[:, k.reshape(-1)] = v.reshape(c, n)
    scale = 1.0 / n
    yre, yim = out.imag * scale, out.real * scale
    y = torch.stack([yre, yim], dim=1).reshape(c, 2, 128, p).contiguous()
    if phasor_drop is None:
        return y, None
    kk = torch.arange(n, device=dev)
    pw = (yre * yre + yim * yim) * (kk >= phasor_drop)
    k4 = kk & 3
    ph = torch.zeros((c, 1, 128), dtype=torch.float32, device=dev)
    ph[:, 0, 0] = (pw * ((k4 == 0).float() - (k4 == 2).float())).sum(dim=1)
    ph[:, 0, 1] = (pw * ((k4 == 3).float() - (k4 == 1).float())).sum(dim=1)
    return y, ph


def band_synth_plain(planes, h1_planes, row_starts, d_shift, m1c, m2re,
                     m2im, twre, twim, p, phasor_drop):
    """Plain version of band_synth: the reference's three-matmul
    Cooley-Tukey synthesis (i = l + 128 r, k = s + P t) in float32.
    Returns (y, ph); ph is None when ``phasor_drop`` is None (the y-only
    form)."""
    c = row_starts.shape[0]
    dev = planes.device
    rows = (row_starts.long()[:, None]
            + torch.arange(p, device=dev)[None, :])          # (C, P)
    nat = planes[:, rows, :]                                 # (2, C, P, 128)
    h = h1_planes[:, d_shift.long()]                         # (2, C, P, 128)
    bre = nat[0] * h[0] - nat[1] * h[1]
    bim = nat[0] * h[1] + nat[1] * h[0]
    a = torch.cat([bre, bim], dim=1)                         # (C, 2P, 128)
    t2 = torch.matmul(a.transpose(1, 2), m1c)                # (C, 128, 2P)
    tre, tim = t2[..., :p], t2[..., p:]
    ure = tre * twre - tim * twim                            # (C, 128, P)
    uim = tre * twim + tim * twre
    u2 = torch.cat([ure, uim], dim=2)
    u2s = torch.cat([-uim, ure], dim=2)
    y2 = torch.matmul(m2re, u2) + torch.matmul(m2im, u2s)    # (C, 128, 2P)
    yre, yim = y2[..., :p], y2[..., p:]
    y = torch.stack([yre, yim], dim=1).contiguous()          # (C, 2, 128, P)
    if phasor_drop is None:
        return y, None
    k = (torch.arange(p, device=dev)[None, :]
         + p * torch.arange(128, device=dev)[:, None])       # (128, P)
    live = (k >= phasor_drop).to(torch.float32)
    s4 = torch.arange(p, device=dev) % 4
    wre = (s4 == 0).to(torch.float32) - (s4 == 2).to(torch.float32)
    wim = (s4 == 3).to(torch.float32) - (s4 == 1).to(torch.float32)
    pw = yre * yre + yim * yim
    ph = torch.zeros((c, 1, 128), dtype=torch.float32, device=dev)
    ph[:, 0, 0] = (pw * wre * live).sum(dim=(1, 2))
    ph[:, 0, 1] = (pw * wim * live).sum(dim=(1, 2))
    return y, ph


# ---------------------------------------------------------------------------
# kernel 3: fused back half
# ---------------------------------------------------------------------------

def z_rows_for(p: int) -> int:
    """Rows of 128 bits in the scan row: 1200 tail bits + 2 bits for
    each of the 128 P/4 symbol slots + 256 bits of zero pad."""
    return -(-(TAILBITS + 2 * 128 * (p // 4) + 256) // 128)


_SCAN_CACHE: dict = {}


def _scan_taps(dev: torch.device) -> tuple:
    """framescan.scan_taps on ``dev`` (the plain versions' tables)."""
    key = str(dev)
    if key not in _SCAN_CACHE:
        _SCAN_CACHE[key] = tuple(torch.from_numpy(t).to(dev)
                                 for t in framescan.scan_taps())
    return _SCAN_CACHE[key]


def _scan_words() -> ctypes.c_void_p:
    """framescan.scan_words in host memory: the C entries copy the table
    into their kernel's parameters."""
    if "words" not in _SCAN_CACHE:
        words = np.ascontiguousarray(framescan.scan_words(), np.uint32)
        if words.shape != (149,):
            raise RuntimeError(f"scan table of {words.shape} words")
        _SCAN_CACHE["words"] = words
    return ctypes.c_void_p(_SCAN_CACHE["words"].ctypes.data)


def fused_backhalf(y: torch.Tensor, bt: torch.Tensor, rr: torch.Tensor,
                   rc: torch.Tensor, sc: torch.Tensor, bsel: torch.Tensor,
                   dsel: torch.Tensor, drop: int, k_max: int) -> tuple:
    """Timing interpolation, pi/4-DQPSK and the even-position sync + CRC
    scan on the raw band-synthesis planes.

    y (C, 2, 128, P) f32; bt (C, TR, 128) f32 {0,1} carried tail bits
    (the first 1200 are read); rr (C, 2, 128, 1) and rc (C, 2, 1, P) f32
    row and lane ramps; sc (C, 16) f32 [c0..c3 Catmull-Rom weights,
    n_valid, prev_re, prev_im, tail_re 0..3, tail_im 0..3, 0]; bsel,
    dsel (C,) int32.  Returns (corr (C, M, 64) f32, err (C, M, 64) i32,
    soft (C, 2, P/4, 128) f32, bt2 (C, TR, 128) f32, last (C, 2, 1, P)
    f32, misc (C, 1, 128) f32): element [m, j] of corr / err is even
    bit position pe = 64 m + j of the scan row z; soft[c, :, u, t] is
    symbol P/4 t + u; last is the corrected last sample row; misc lanes
    0/1 the last valid symbol (0 when there is none).

    Replaces ``fused_backhalf`` (tetraear_tpu/dsp/pallas_kernels.py).
    Bound: device memory (64 KB in, ~40 KB out per carrier), then the
    scan's integer work.  Design (csrc/backhalf.cu): one block of 256
    threads per carrier, three or more to an SM, so one carrier's loads
    run under another's scan; a thread reads its symbol's two 16-byte
    sample groups straight from device memory and interpolates once;
    soft bits leave transposed through shared memory as whole rows; the
    bit row is packed by ballot and scanned in runs of 8 positions a
    thread, the first in full and the rest by the sliding step
    (csrc/scan.cuh, whose numpy references are
    framescan.host_scan_rows_even and host_scan_rows_even_sliding)."""
    c = y.shape[0] if y.dim() == 4 else -1
    p = y.shape[3] if y.dim() == 4 else -1
    tr = bt.shape[1] if bt.dim() == 3 else -1
    _check(y, "y", (c, 2, 128, p), torch.float32)
    _check(bt, "bt", (c, tr, 128), torch.float32)
    _check(rr, "rr", (c, 2, 128, 1), torch.float32)
    _check(rc, "rc", (c, 2, 1, p), torch.float32)
    _check(sc, "sc", (c, 16), torch.float32)
    _check(bsel, "bsel", (c,), torch.int32)
    _check(dsel, "dsel", (c,), torch.int32)
    sy = p // 4
    if drop % 4 or drop < 8 or p % 4:
        raise ValueError(f"fused_backhalf needs drop % 4 == 0, "
                         f"drop >= 8, P % 4 == 0 (drop={drop}, P={p})")
    if k_max > 128 * sy:
        raise ValueError(f"k_max {k_max} exceeds symbol capacity "
                         f"{128 * sy}")
    if tr * 128 < TAILBITS:
        raise ValueError(f"bt holds {tr * 128} < {TAILBITS} tail bits")
    z_rows = z_rows_for(p)
    if _route(y, bt, rr, rc, sc, bsel, dsel) == "cpu":
        return fused_backhalf_plain(y, bt, rr, rc, sc, bsel, dsel, drop,
                                    k_max, z_rows)
    if 128 * p > 16384:
        raise ValueError(f"fused_backhalf kernel: n_band <= 16384 "
                         f"(got {128 * p})")
    dev = y.device
    lib = build()
    m = z_rows - 2
    corr = torch.empty((c, m, 64), dtype=torch.float32, device=dev)
    err = torch.empty((c, m, 64), dtype=torch.int32, device=dev)
    soft = torch.empty((c, 2, sy, 128), dtype=torch.float32, device=dev)
    bt2 = torch.empty((c, tr, 128), dtype=torch.float32, device=dev)
    last = torch.empty((c, 2, 1, p), dtype=torch.float32, device=dev)
    misc = torch.empty((c, 1, 128), dtype=torch.float32, device=dev)
    _launch("fused_backhalf", dev, lib.tt_fused_backhalf, _ptr(y), _ptr(bt),
            _ptr(rr), _ptr(rc), _ptr(sc), _ptr(bsel), _ptr(dsel),
            _scan_words(), _ptr(corr), _ptr(err),
            _ptr(soft), _ptr(bt2), _ptr(last), _ptr(misc), p, int(drop),
            int(k_max), tr, z_rows, c)
    return corr, err, soft, bt2, last, misc


def fused_backhalf_plain(y, bt, rr, rc, sc, bsel, dsel, drop, k_max,
                         z_rows):
    """Plain version of fused_backhalf: gathers for the interpolation
    and a stride-2 conv for the scan, in the kernel's float order."""
    c, _, _, p = y.shape
    dev = y.device
    n = 128 * p
    sy = p // 4
    ns = 128 * sy
    tr = bt.shape[1]
    cor_re = rr[:, 0] * rc[:, 0] - rr[:, 1] * rc[:, 1]       # (C, 128, P)
    cor_im = rr[:, 0] * rc[:, 1] + rr[:, 1] * rc[:, 0]
    xr = (y[:, 0] * cor_re - y[:, 1] * cor_im).reshape(c, n)
    xi = (y[:, 0] * cor_im + y[:, 1] * cor_re).reshape(c, n)
    d0 = drop - 4
    xr[:, d0:d0 + 4] = sc[:, 7:11]
    xi[:, d0:d0 + 4] = sc[:, 11:15]
    last = torch.stack([xr[:, n - p:], xi[:, n - p:]], dim=1)[:, :, None]

    i = torch.arange(ns, device=dev)
    base = d0 + 4 * i[None, :] + bsel.long()[:, None]        # (C, NS)

    def tap(j):
        idx = (base + j) % n
        return (torch.gather(xr, 1, idx), torch.gather(xi, 1, idx))

    taps = [tap(j) for j in range(4)]
    cw = [sc[:, j:j + 1] for j in range(4)]
    sym_re = ((cw[0] * taps[0][0] + cw[1] * taps[1][0])
              + cw[2] * taps[2][0]) + cw[3] * taps[3][0]
    sym_im = ((cw[0] * taps[0][1] + cw[1] * taps[1][1])
              + cw[2] * taps[2][1]) + cw[3] * taps[3][1]
    prv_re = torch.cat([sc[:, 5:6], sym_re[:, :-1]], dim=1)
    prv_im = torch.cat([sc[:, 6:7], sym_im[:, :-1]], dim=1)
    dre = sym_re * prv_re + sym_im * prv_im
    dim_ = sym_im * prv_re - sym_re * prv_im
    mag = torch.sqrt(dre * dre + dim_ * dim_) + 1e-12
    soft = torch.stack([-dim_ / mag, -dre / mag], dim=1)     # (C, 2, NS)
    soft = soft.reshape(c, 2, 128, sy).transpose(2, 3).contiguous()

    fi = i.to(torch.float32)[None, :]
    nv = sc[:, 4:5]
    valid = fi < nv
    msb = (valid & (dim_ < 0)).to(torch.float32)
    lsb = (valid & (dre < 0)).to(torch.float32)
    sel = fi == nv - 1.0
    misc = torch.zeros((c, 1, 128), dtype=torch.float32, device=dev)
    misc[:, 0, 0] = torch.where(sel, sym_re, 0.0).sum(dim=1)
    misc[:, 0, 1] = torch.where(sel, sym_im, 0.0).sum(dim=1)

    zb = z_rows * 128
    z = torch.zeros((c, zb), dtype=torch.float32, device=dev)
    z[:, :TAILBITS] = bt.reshape(c, -1)[:, :TAILBITS]
    z[:, TAILBITS:TAILBITS + 2 * ns:2] = msb
    z[:, TAILBITS + 1:TAILBITS + 2 * ns:2] = lsb

    taps_k, c0, zs = _scan_taps(dev)
    m = z_rows - 2
    out = torch.nn.functional.conv1d(z[:, None, :], taps_k, stride=2)
    out = out[:, :, :64 * m]                                 # (C, 19, 64M)
    n_agree = torch.maximum(out[:, 17] + zs[0], out[:, 18] + zs[1])
    corr = n_agree * (1.0 / framescan.SYNC_LEN)
    par = torch.remainder(out[:, :16], 2.0)
    err = torch.abs(par - c0[None, :, None]).sum(dim=1)
    ones = out[:, 16]
    deg = (ones == 0.0) | (ones == float(framescan.DATA_BITS))
    err = torch.where(deg, 99.0, err)
    corr = corr.reshape(c, m, 64)
    err = torch.round(err).to(torch.int32).reshape(c, m, 64)

    off = 2 * k_max - 4 + 2 * dsel.long()                     # (C,)
    src = off[:, None] + torch.arange(TAILBITS, device=dev)[None, :]
    zpad = torch.cat([z, torch.zeros((c, TAILBITS), device=dev)], dim=1)
    bt2 = torch.zeros((c, tr * 128), dtype=torch.float32, device=dev)
    bt2[:, :TAILBITS] = torch.gather(zpad, 1, src)
    return (corr, err, soft, bt2.reshape(c, tr, 128), last.contiguous(),
            misc)


# ---------------------------------------------------------------------------
# kernel 4: standalone even-position frame scan
# ---------------------------------------------------------------------------

def frame_scan_even(bits: torch.Tensor) -> tuple:
    """Even-position sync + burst-CRC scan of (C, n) uint8 {0,1} bit
    rows.  Returns (corr (C, (n-22)//2 + 1) f32, crc_err
    (C, (n-230)//2 + 1) int32): corr[c, pe] is the best TS1/TS2
    agreement of bits[c, 2pe : 2pe+22] times float32(1/22), crc_err
    [c, pe] the forward CRC-16 syndrome weight of the frame starting at
    bit 2pe (99 for an all-zero or all-one data view); both planes at
    their final widths.

    corr is n_agree * float32(1/22), the reference kernel's own form
    (the fused back-half kernel's too); host_scan_rows_even divides by
    float32(22) instead, which differs in the last bit for some counts.
    ``sparse_hits`` reads corr only through round(corr * 22), which
    either form maps back to n_agree exactly.

    Replaces ``frame_scan_even`` (tetraear_tpu/dsp/pallas_kernels.py).
    Bound: the integer instruction rate (a position evaluated in full is
    about 210 integer instructions against 2 bits in and 8 bytes out).
    Design: csrc/frame_scan.cu packs each row into 32-bit words in
    shared memory from 16-byte loads, and a thread takes a run of 16
    neighbouring positions through csrc/scan.cuh: the first in full, the
    rest by the sliding step (the CRC taps are a polynomial remainder,
    ``framescan.scan_slide``; ``framescan.host_scan_rows_even_sliding``
    is that order of steps in numpy); the verdicts leave through shared
    memory as 16-byte vectors.  No (C, R, 128) padding, selector tables
    or reshape passes."""
    c = bits.shape[0] if bits.dim() == 2 else -1
    n = bits.shape[1] if bits.dim() == 2 else -1
    _check(bits, "bits", (c, n), torch.uint8)
    if n < framescan.SYNC_LEN or n > 1_000_000:
        raise ValueError(f"frame_scan_even: row of {n} bits (need "
                         f"{framescan.SYNC_LEN} <= n <= 1000000)")
    if _route(bits) == "cpu":
        return frame_scan_even_plain(bits)
    if bits.data_ptr() % 16:
        raise ValueError("bits: storage must be 16-byte aligned")
    pe_n, pc_n = framescan.plane_dims(n)
    pc_n = max(pc_n, 0)
    dev = bits.device
    lib = build()
    corr = torch.empty((c, pe_n), dtype=torch.float32, device=dev)
    err = torch.empty((c, pc_n), dtype=torch.int32, device=dev)
    _launch("frame_scan_even", dev, lib.tt_frame_scan_even, _ptr(bits),
            _scan_words(), _ptr(corr), _ptr(err), n, pe_n,
            pc_n, c)
    return corr, err


def frame_scan_even_plain(bits: torch.Tensor) -> tuple:
    """Plain version of frame_scan_even: the 19-row stride-2 tap conv of
    framescan.scan_taps (all sums exact small integers in float32)."""
    c, n = bits.shape
    dev = bits.device
    pe_n, pc_n = framescan.plane_dims(n)
    pc_n = max(pc_n, 0)
    taps_k, c0, zs = _scan_taps(dev)
    z = torch.nn.functional.pad(bits.to(torch.float32),
                                (0, framescan.CRC_SPAN))
    out = torch.nn.functional.conv1d(z[:, None, :], taps_k, stride=2)
    n_agree = torch.maximum(out[:, 17, :pe_n] + zs[0],
                            out[:, 18, :pe_n] + zs[1])
    corr = n_agree * (1.0 / framescan.SYNC_LEN)
    par = torch.remainder(out[:, :16, :pc_n], 2.0)
    err = torch.abs(par - c0[None, :, None]).sum(dim=1)
    ones = out[:, 16, :pc_n]
    deg = (ones == 0.0) | (ones == float(framescan.DATA_BITS))
    err = torch.where(deg, 99.0, err)
    return corr.contiguous(), torch.round(err).to(torch.int32)


# ---------------------------------------------------------------------------
# kernels 5 and 6: per-carrier band extraction
# ---------------------------------------------------------------------------

# csrc/band_extract.cu's ring (kStages stages of kStageBytes) and its
# persistent grid: two CTAs on each of the H100 SXM's 132 SMs, and the
# chunks a CTA should get at least (smaller chunks where the runs are
# short)
EXTRACT_STAGES = 4
EXTRACT_STAGE_BYTES = 16384
EXTRACT_CTAS = 264
EXTRACT_CHUNKS_PER_CTA = 4


def _host_starts(starts, name: str, span: int, n_rows: int) -> np.ndarray:
    """``starts`` ((C,) int32, a numpy array or a CPU tensor) as numpy,
    checked: every slice [start, start + span) lies inside n_rows."""
    if isinstance(starts, torch.Tensor):
        if starts.device.type != "cpu":
            raise ValueError(
                f"{name} on {starts.device}: starts are checked on the host, "
                f"so make an ExtractPlan of host starts once")
        if starts.dtype != torch.int32:
            raise ValueError(f"{name}: dtype {starts.dtype}, expected "
                             f"torch.int32")
        starts = starts.numpy()
    starts = np.asarray(starts)
    if starts.dtype != np.int32 or starts.ndim != 1:
        raise ValueError(f"{name}: {starts.dtype} {starts.shape}, expected "
                         f"(C,) int32")
    if span < 1:
        raise ValueError(f"{name}: span {span}")
    if len(starts):
        lo, hi = int(starts.min()), int(starts.max())
        if lo < 0 or hi + span > n_rows:
            raise ValueError(f"{name}: slices [{lo}, {hi + span}) leave the "
                             f"{n_rows} rows of the spectrum")
    return starts.copy()


class ExtractPlan:
    """One band-extraction shape, fixed on the host as a cuFFT plan fixes
    a transform: the form, the carriers' starts, the band's span and the
    source's rows.

      * "rows": out[c, pl] = planes[pl, starts[c] : starts[c] + span],
        planes (2, n_rows, 128) float32, out (C, 2, span, 128);
      * "pairs": out[c] = x[starts[c] : starts[c] + span], x (n_rows, 2)
        float32 [re, im] pairs, out (C, span, 2).

    The starts ((C,) int32, a numpy array or a CPU tensor) are checked
    here, once.  ``table`` is what csrc/band_extract.cu reads, made here
    and uploaded once a device (``table_on``), so that a launch neither
    checks nor copies anything between host and card.  Rows (the staged
    bulk copy): the CTAs' chunk bounds (n_ctas + 1), then n_chunks + 1
    chunks (src offset; load bytes | first store << 32), then the stores
    (dst offset; stage offset | bytes << 32), all int64.  Pairs (a
    thread copy a band): the starts as int64."""

    def __init__(self, form: str, starts, span: int, n_rows: int):
        if form not in ("rows", "pairs"):
            raise ValueError(f"form {form!r}: 'rows' or 'pairs'")
        self.form, self.span, self.n_rows = form, int(span), int(n_rows)
        self.starts = _host_starts(
            starts, "row_starts" if form == "rows" else "starts", self.span,
            self.n_rows)
        self.row_bytes = 512 if form == "rows" else 8
        c = len(self.starts)
        self.out_shape = ((c, 2, self.span, 128) if form == "rows"
                          else (c, self.span, 2))
        if form == "rows" and c:
            self.table, self.n_ctas, self.n_chunks = _extract_schedule(
                *self.segments())
        else:
            self.table = self.starts.astype(np.int64)
            self.n_ctas, self.n_chunks = c, 0
        self._on: dict = {}

    def segments(self) -> tuple:
        """(src, dst) int64 byte offsets of the copied segments and their
        length in bytes: 2C segments (carrier-major, then plane) for rows,
        C for pairs."""
        length = self.span * self.row_bytes
        c = len(self.starts)
        if self.form == "rows":
            pl = np.tile(np.arange(2), c)
            s = np.repeat(self.starts.astype(np.int64), 2)
            src = (pl * self.n_rows + s) * 512
        else:
            src = self.starts.astype(np.int64) * 8
        return src, np.arange(len(src), dtype=np.int64) * length, length

    @property
    def out_bytes(self) -> int:
        return 4 * math.prod(self.out_shape)

    @property
    def source_bytes(self) -> int:
        """Distinct source bytes the slices cover: what the copy must read
        at least once."""
        src, _, length = self.segments()
        s = np.sort(src)
        return int(length * (len(s) > 0)
                   + np.minimum(np.diff(s), length).sum())

    def table_on(self, dev: torch.device) -> torch.Tensor:
        """``table`` on ``dev``, uploaded once."""
        key = str(dev)
        if key not in self._on:
            self._on[key] = torch.from_numpy(self.table).to(dev)
        return self._on[key]


def _extract_schedule(src: np.ndarray, dst: np.ndarray, length: int):
    """(table, n_ctas, n_chunks) of the staged kernel for byte segments
    [src, src + length) -> [dst, dst + length), every offset and the
    length multiples of 16.  Segments sorted by source offset and merged
    where they overlap make runs; a run is cut into chunks of at most
    EXTRACT_STAGE_BYTES (less where the runs are short, down to 512
    bytes), each loaded once; every segment meeting a chunk gets a bulk
    store of the bytes they share."""
    stage = EXTRACT_STAGE_BYTES
    order = np.argsort(src, kind="stable")
    s, d = src[order], dst[order]
    hi = s + length
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > np.maximum.accumulate(hi)[:-1]
    run = np.cumsum(new) - 1
    first = np.flatnonzero(new)
    run_lo, run_hi = s[first], np.maximum.reduceat(hi, first)
    # chunks under a stage where the runs are short, so that every CTA
    # of the grid has EXTRACT_CHUNKS_PER_CTA
    total = int((run_hi - run_lo).sum())
    per = EXTRACT_CHUNKS_PER_CTA * EXTRACT_CTAS
    stage = min(stage, max(512, (-(-total // per) + 15) & ~15))
    per_run = -(-(run_hi - run_lo) // stage)
    chunk0 = np.cumsum(per_run) - per_run
    n_chunks = int(per_run.sum())
    ch_run = np.repeat(np.arange(len(first)), per_run)
    ch_lo = run_lo[ch_run] + (np.arange(n_chunks) - chunk0[ch_run]) * stage
    ch_hi = np.minimum(ch_lo + stage, run_hi[ch_run])
    # segment i meets chunks k0 .. k1 of its run
    rel = s - run_lo[run]
    k0, k1 = rel // stage, (rel + length - 1) // stage
    per_seg = k1 - k0 + 1
    seg = np.repeat(np.arange(len(s)), per_seg)
    k = (chunk0[run[seg]] + k0[seg] + np.arange(len(seg))
         - np.repeat(np.cumsum(per_seg) - per_seg, per_seg))
    a = np.maximum(ch_lo[k], s[seg])
    nbytes = np.minimum(ch_hi[k], s[seg] + length) - a
    smem, gdst = a - ch_lo[k], d[seg] + a - s[seg]
    by_chunk = np.argsort(k, kind="stable")
    k, smem, gdst, nbytes = (v[by_chunk] for v in (k, smem, gdst, nbytes))
    per_chunk = np.bincount(k, minlength=n_chunks)
    # the CTAs: contiguous ranges of chunks of about equal bytes moved
    w = (ch_hi - ch_lo) + np.bincount(k, weights=nbytes, minlength=n_chunks)
    n_ctas = min(EXTRACT_CTAS, n_chunks)
    bounds = np.searchsorted(np.cumsum(w) - w / 2,
                             w.sum() * np.arange(n_ctas + 1) / n_ctas)
    chunks = np.zeros((n_chunks + 1, 2), np.int64)
    chunks[:-1, 0] = ch_lo
    chunks[1:, 1] = np.cumsum(per_chunk) << 32
    chunks[:-1, 1] += ch_hi - ch_lo
    stores = np.stack([gdst, smem + (nbytes << 32)], axis=1)
    table = np.concatenate([bounds.astype(np.int64), chunks.reshape(-1),
                            stores.reshape(-1)])
    return table, n_ctas, n_chunks


def _plan_for(starts, form: str, span: int, n_rows: int,
              cpu: bool) -> ExtractPlan | np.ndarray:
    """On the card, ``starts``, which must be an ExtractPlan of this
    shape; on the CPU route, the checked host starts as numpy (a plan's,
    or host starts given)."""
    if isinstance(starts, ExtractPlan):
        if (starts.form, starts.span, starts.n_rows) != (form, int(span),
                                                         n_rows):
            raise ValueError(
                f"a {starts.form} plan of span {starts.span} over "
                f"{starts.n_rows} rows, called as {form} of span {span} "
                f"over {n_rows}")
        return starts.starts if cpu else starts
    if not cpu:
        raise ValueError(
            f"band extraction on the card takes an ExtractPlan (made once "
            f"from host starts), not {type(starts).__name__}")
    return _host_starts(starts, "row_starts" if form == "rows" else "starts",
                        int(span), n_rows)


def extract_entry(plan: ExtractPlan, src: torch.Tensor,
                  out: torch.Tensor) -> tuple:
    """(C entry, its arguments but the stream) of the plan's launch from
    ``src`` into ``out``, the table uploaded: the launch alone, which
    ``chip_smoke.py`` also times."""
    lib = build()
    table = plan.table_on(src.device)
    if plan.form == "rows":
        return lib.tt_band_extract_staged, (
            _ptr(src), _ptr(out), _ptr(table), plan.n_ctas, plan.n_chunks)
    return lib.tt_band_extract_pairs, (
        _ptr(src), _ptr(table), _ptr(out), plan.span, len(plan.starts))


def _launch_extract(name: str, plan: ExtractPlan, src: torch.Tensor,
                    out: torch.Tensor) -> None:
    if src.data_ptr() % 16:
        raise ValueError(f"{name}: source storage must be 16-byte aligned")
    if len(plan.starts):
        fn, args = extract_entry(plan, src, out)
        _launch(name, src.device, fn, *args)


def band_extract_rows(planes: torch.Tensor, row_starts,
                      rows_per_band: int) -> torch.Tensor:
    """Per-carrier slices of 128-lane rows of the spectrum planes:
    planes (2, R, 128) f32 -> (C, 2, P, 128) f32 with out[c, pl] =
    planes[pl, row_starts[c] : row_starts[c] + P].  ``row_starts`` is an
    ExtractPlan("rows", ., P, R), made once; on the CPU route host starts
    ((C,) int32) are taken too.

    Replaces ``band_extract_rows`` (tetraear_tpu/dsp/pallas_kernels.py),
    one DMA per carrier there.  Bound: device memory, the distinct source
    bytes read once (``ExtractPlan.source_bytes``) plus the output.
    Design: csrc/band_extract.cu, TMA bulk copies through a ring of
    shared-memory stages, each source chunk loaded once for all the bands
    that cover it."""
    r_rows = planes.shape[1] if planes.dim() == 3 else -1
    _check(planes, "planes", (2, r_rows, 128), torch.float32)
    cpu = _route(planes) == "cpu"
    plan = _plan_for(row_starts, "rows", rows_per_band, r_rows, cpu)
    if cpu:
        return band_extract_rows_plain(planes, torch.from_numpy(plan),
                                       rows_per_band)
    out = torch.empty(plan.out_shape, dtype=torch.float32,
                      device=planes.device)
    _launch_extract("band_extract_rows", plan, planes, out)
    return out


def band_extract_rows_plain(planes, row_starts, p):
    """Plain version of band_extract_rows: the row index gather."""
    rows = (row_starts.long()[:, None]
            + torch.arange(p, device=planes.device)[None, :])   # (C, P)
    return planes[:, rows, :].transpose(0, 1).contiguous()


def band_extract(x_ext_r: torch.Tensor, starts,
                 n_band: int) -> torch.Tensor:
    """Per-carrier contiguous slices of the interleaved wrap-extended
    spectrum: x_ext_r (N, 2) f32 [re, im] pairs -> (C, n_band, 2) f32
    with out[c] = x_ext_r[starts[c] : starts[c] + n_band].  ``starts``
    is an ExtractPlan("pairs", ., n_band, N), made once; on the CPU
    route host starts ((C,) int32) are taken too.

    Replaces ``band_extract`` (tetraear_tpu/dsp/pallas_kernels.py).
    Bound: device memory, as band_extract_rows.  Design:
    csrc/band_extract.cu, a CTA of threads a band with 16-byte stores
    (two 8-byte loads each where the start is odd; pair by pair for an
    odd n_band): its callers' bands are at most 512 bytes, where a
    staged bulk copy's load round trip costs more than it saves."""
    n_rows = x_ext_r.shape[0] if x_ext_r.dim() == 2 else -1
    _check(x_ext_r, "x_ext_r", (n_rows, 2), torch.float32)
    cpu = _route(x_ext_r) == "cpu"
    plan = _plan_for(starts, "pairs", n_band, n_rows, cpu)
    if cpu:
        return band_extract_plain(x_ext_r, torch.from_numpy(plan), n_band)
    out = torch.empty(plan.out_shape, dtype=torch.float32,
                      device=x_ext_r.device)
    _launch_extract("band_extract", plan, x_ext_r, out)
    return out


def band_extract_plain(x_ext_r, starts, n_band):
    """Plain version of band_extract: the element index gather."""
    idx = (starts.long()[:, None]
           + torch.arange(n_band, device=x_ext_r.device)[None, :])
    return x_ext_r[idx]
