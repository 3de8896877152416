"""The port's ACELP speech decoder (voice/speech.py, voice/fixed.py)
against the JAX package's (voice/jspeech.py, voice/jfixed.py) and the
port's C++ decoder (voice/csrc, ``tetra_speech_decode_many``), on the
CPU: PCM and every SpeechState leaf bit for bit, tolerance 0.

On the CPU ``speech.decode_block`` runs its plain version; the CUDA
kernel (dsp/csrc/speech.cu) is held against it on the card
(tests/test_torch_cuda.py, chip_smoke.py phase ``speech``).

Compiling ``jspeech.decode_block_jit`` takes about a minute on a CPU, so
the JAX decoder runs at ONE shape, (S=8, F=4), in one module fixture:
two successive calls that carry the state.  Every JAX comparison reuses
that fixture.  The operator tests run jfixed eagerly (no compile).
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tetraear_tpu.voice import jfixed  # noqa: E402
from tetraear_tpu.voice import jspeech  # noqa: E402
from tetraear_tpu_torch import native  # noqa: E402
from tetraear_tpu_torch.voice import acelp_tables as T  # noqa: E402
from tetraear_tpu_torch.voice import fixed  # noqa: E402
from tetraear_tpu_torch.voice import speech  # noqa: E402
from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool  # noqa

S, F_CALL = 8, 4


def corner_stream(rng, n: int, pitch1: int, deltas) -> np.ndarray:
    """Random parameters with the subframe-1 pitch index ``pitch1`` and
    the three delta lags ``deltas``: 255 reaches t0 = 143 and, with delta
    30, t0 = 143 with frac = +1 (the excitation-history corner), with
    delta 31 t0 = 144; 196 and 197 straddle the fractional / integer
    pitch boundary; 0 gives the least lag."""
    prms = np.zeros((n, 24), np.int32)
    prms[:, 1:] = np.array([rng.integers(0, 1 << int(nb))
                            for nb in T.BITNO], np.int32)[None]
    prms[:, 4] = pitch1
    prms[:, 9], prms[:, 14], prms[:, 19] = deltas
    return speech.prm2bits(prms)


def streams(seed: int, s: int, n: int) -> tuple:
    """(s, n, 138) frames and (s, n) valid: corner streams in the first
    rows (and the last, with t0 = 19), a first frame that is BFI, runs of
    BFI, an all-BFI slot, random bits with about 1 BFI in 8, and holes in
    ``valid``."""
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, 2, (s, n, 138)).astype(np.int32)
    fr[:, :, 0] = rng.random((s, n)) < 0.125
    corners = [(255, (31, 30, 0)), (196, (30, 15, 31)), (197, (0, 30, 1)),
               (255, (30, 0, 31))]
    for i, (p1, d) in enumerate(corners[:max(0, s - 4)]):
        fr[i] = corner_stream(rng, n, p1, d)
    if s >= 8:
        # t0 = 144 in the last subframe, then BFI frames that keep it (the
        # excitation window starts one word before the buffer)
        fr[3, 1::2, 0] = 1
        fr[s - 1] = corner_stream(rng, n, 0, (15, 31, 30))     # t0 = 19
    r = s - 4
    fr[r, 0, 0] = 1                              # first frame BFI
    fr[r, 2:5, 0] = 1                            # a run of BFI
    fr[r + 1, :, 0] = 1                          # an all-BFI slot
    valid = rng.random((s, n)) > 0.15
    valid[r + 2, 1:3] = False                    # a run of holes
    return fr, valid


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX decoder over two calls of (S=8, F=4) from a fresh state:
    (frames, valid, [state after each call], [PCM of each call]), all
    numpy."""
    fr, valid = streams(seed=71, s=S, n=2 * F_CALL)
    st = jspeech.init_state(S)
    states, pcms = [], []
    for c in range(2):
        sl = slice(c * F_CALL, (c + 1) * F_CALL)
        st, pcm = jspeech.decode_block_jit(st, jnp.asarray(fr[:, sl]),
                                           jnp.asarray(valid[:, sl]))
        states.append([np.asarray(x) for x in st])
        pcms.append(np.asarray(pcm))
    return fr, valid, states, pcms


@pytest.fixture(scope="module")
def port_run(jax_ref):
    """The port's plain decoder over the same two calls."""
    fr, valid, _, _ = jax_ref
    st = speech.init_state(S, "cpu")
    states, pcms = [], []
    for c in range(2):
        sl = slice(c * F_CALL, (c + 1) * F_CALL)
        st, pcm = speech.decode_block(st, torch.from_numpy(fr[:, sl].copy()),
                                      torch.from_numpy(valid[:, sl].copy()))
        states.append([x.numpy() for x in st])
        pcms.append(pcm.numpy())
    return states, pcms


@pytest.mark.parametrize("call", [0, 1])
def test_plain_equals_jax_pcm_and_every_state_leaf(jax_ref, port_run, call):
    _, valid, j_states, j_pcms = jax_ref
    p_states, p_pcms = port_run
    np.testing.assert_array_equal(p_pcms[call], j_pcms[call])
    for name, got, want in zip(speech.SpeechState._fields, p_states[call],
                               j_states[call]):
        assert got.dtype == np.int32 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    sl = slice(call * F_CALL, (call + 1) * F_CALL)
    assert not p_pcms[call][~valid[:, sl]].any()
    assert p_pcms[call][valid[:, sl]].any()


def test_rows_decode_only_their_slots(jax_ref, port_run):
    """The second call on a subset of the slots (``rows``): their PCM and
    state are the JAX package's, every other slot keeps its state."""
    fr, valid, j_states, j_pcms = jax_ref
    p_states, _ = port_run
    rows = np.array([6, 1, 4, 3], np.int32)
    st1 = speech.SpeechState(*(torch.from_numpy(x) for x in p_states[0]))
    sl = slice(F_CALL, 2 * F_CALL)
    st2, pcm = speech.decode_block(
        st1, torch.from_numpy(fr[rows, sl].copy()),
        torch.from_numpy(valid[rows, sl].copy()), torch.from_numpy(rows))
    np.testing.assert_array_equal(pcm.numpy(), j_pcms[1][rows])
    others = np.setdiff1d(np.arange(S), rows)
    for got, want1, want2 in zip(st2, p_states[0], j_states[1]):
        np.testing.assert_array_equal(got.numpy()[rows], want2[rows])
        np.testing.assert_array_equal(got.numpy()[others], want1[others])
    # the given state is not changed
    for got, want in zip(st1, p_states[0]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_jax_state_restores_into_a_port_pool(jax_ref):
    """The JAX decoder's state after its first call, restored into a port
    pool (one slot a carrier), decodes the second call's frames to the
    JAX PCM."""
    fr, valid, j_states, j_pcms = jax_ref
    pool = DeviceSpeechPool(slots=S, device="cpu")
    meta = {"map": [[100 + i, i] for i in range(S)], "free": [],
            "slots": S}
    pool.restore_state(j_states[0], meta)
    sl = slice(F_CALL, 2 * F_CALL)
    # every frame valid here: the pool's items are frame streams
    keep = [i for i in range(S) if valid[i, sl].all()]
    assert len(keep) >= 4
    items = [(100 + i, fr[i, sl].astype(np.int16)) for i in keep]
    got = pool.synthesize(items)
    for i, pcm in zip(keep, got):
        want = j_pcms[1][i].reshape(-1).astype(np.float32) / 32768.0
        np.testing.assert_array_equal(pcm, want)


def c_decode(frames: np.ndarray) -> np.ndarray:
    """(n, 138) frames through one fresh C++ decoder: (n, 240) int16."""
    lib = native.codec()._LIB
    dec = lib.tetra_speech_decoder_new()
    try:
        fr = np.ascontiguousarray(frames.astype(np.int16))
        out = np.zeros((len(fr), 240), np.int16)
        ptr = ctypes.POINTER(ctypes.c_int16)
        assert lib.tetra_speech_decode_many(
            dec, fr.ctypes.data_as(ptr), len(fr),
            out.ctypes.data_as(ptr)) == 0
        return out
    finally:
        lib.tetra_speech_decoder_free(dec)


@pytest.mark.parametrize("seed", [81, 82])
def test_plain_equals_cpp_decoder(seed):
    """Other streams, without JAX: six slots over three calls of four
    frames (state carried), each slot's valid frames equal to a fresh C++
    decoder's on the same frames in order."""
    s, n = 6, 12
    fr, valid = streams(seed, s, n)
    st = speech.init_state(s, "cpu")
    pcm = []
    for lo in range(0, n, 4):
        st, p = speech.decode_block(
            st, torch.from_numpy(np.ascontiguousarray(fr[:, lo:lo + 4])),
            torch.from_numpy(np.ascontiguousarray(valid[:, lo:lo + 4])))
        pcm.append(p.numpy())
    pcm = np.concatenate(pcm, axis=1)
    for i in range(s):
        np.testing.assert_array_equal(pcm[i][valid[i]],
                                      c_decode(fr[i][valid[i]]),
                                      err_msg=f"slot {i}")
    assert not pcm[~valid].any()


def test_bits2prm_equals_the_jax_matrix():
    rng = np.random.default_rng(5)
    fr = rng.integers(0, 2, (7, 3, 138)).astype(np.int32)
    fr[..., 1:] |= rng.integers(0, 4, fr[..., 1:].shape) * 2   # high bits
    want = np.concatenate([fr[..., :1], (fr[..., 1:] & 1) @ jspeech._B2P],
                          axis=-1)
    np.testing.assert_array_equal(
        speech.bits2prm(torch.from_numpy(fr)).numpy(), want)
    # prm2bits inverts it on the low bits
    np.testing.assert_array_equal(speech.prm2bits(want)[..., 1:],
                                  fr[..., 1:] & 1)


# ---- the basic operators, one by one --------------------------------------

W16 = np.array([-32768, -32767, -16384, -12345, -2, -1, 0, 1, 2, 12345,
                16383, 16384, 32767], np.int64)
W32 = np.array([-2 ** 31, -2 ** 31 + 1, -2 ** 30 - 1, -2 ** 30, -65536,
                -32769, -32768, -1, 0, 1, 32767, 32768, 65535, 2 ** 30 - 1,
                2 ** 30, 1234567891, 2 ** 31 - 1], np.int64)
SHIFTS = np.array([-40, -32, -31, -17, -16, -15, -2, -1, 0, 1, 2, 14, 15,
                   16, 17, 30, 31, 32, 40], np.int64)


def _grid(*axes):
    mesh = np.meshgrid(*axes, indexing="ij")
    return [m.reshape(-1) for m in mesh]


OPS = {
    # name: argument kinds ("h" Word16, "l" Word32, "n" shift count,
    # "s<k>" the constant k)
    "add": "hh", "sub": "hh", "abs_s": "h", "negate": "h",
    "extract_h": "l", "extract_l": "l", "mult": "hh", "mult_r": "hh",
    "L_add": "ll", "L_sub": "ll", "L_mult": "hh", "L_mult0": "hh",
    "L_mac": "lhh", "L_msu": "lhh", "L_mac0": "lhh", "L_msu0": "lhh",
    "L_negate": "l", "L_abs": "l", "L_deposit_h": "h", "L_deposit_l": "h",
    "shr": "hn", "shl": "hn", "L_shr": "ln", "L_shl": "ln",
    "L_shr_r": "ln", "round_w": "l", "norm_s": "h", "norm_l": "l",
    "Load_sh16": "h", "add_sh16": "lh", "sub_sh16": "lh",
    "L_comp": "hh", "L_extract": "l", "mpy_32": "hhhh", "mpy_mix": "hhh",
}
CONST_OPS = {"Load_sh": "h", "add_sh": "lh", "sub_sh": "lh",
             "store_hi": "l"}


def _args(kinds: str) -> list:
    pools = {"h": W16, "l": W32, "n": SHIFTS}
    if len(kinds) == 4:            # keep the grid small: two values vary
        h = np.array([-32768, -1, 0, 1, 16384, 32767], np.int64)
        return _grid(h, h, h, h)
    return _grid(*(pools[k] for k in kinds))


def _compare(name: str, args: list, *const) -> None:
    with jax.disable_jit():
        want = getattr(jfixed, name)(*(jnp.asarray(a, jnp.int32)
                                       for a in args), *const)
    got = getattr(fixed, name)(*(torch.from_numpy(a) for a in args),
                               *const)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("name", sorted(OPS))
def test_fixed_op_equals_jfixed(name):
    _compare(name, _args(OPS[name]))


@pytest.mark.parametrize("name", sorted(CONST_OPS))
def test_fixed_op_with_a_constant_shift_equals_jfixed(name):
    for k in range(8 if name == "store_hi" else 16):
        _compare(name, _args(CONST_OPS[name]), k)


@pytest.mark.parametrize("name", ["shr", "shl", "L_shr", "L_shl",
                                  "L_shr_r"])
def test_shift_by_an_int_count_equals_jfixed(name):
    """The direct path a Python int count takes equals the tensor path
    and jfixed, every count of SHIFTS."""
    vals = W16 if OPS[name][0] == "h" else W32
    for n in SHIFTS.tolist():
        with jax.disable_jit():
            want = getattr(jfixed, name)(jnp.asarray(vals, jnp.int32), n)
        got = getattr(fixed, name)(torch.from_numpy(vals), n)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=f"{name} by {n}")


def test_div_s_equals_jfixed():
    num, den = _grid(np.array([0, 1, 2, 100, 16383, 32767]),
                     np.array([1, 2, 3, 100, 16384, 32767]))
    keep = num <= den
    _compare("div_s", [num[keep], den[keep]])


# ---- the kernel's source, compiled for the host -----------------------------

_SHIM = r"""
// the CUDA names speech.cu uses, for a host build of it: a CTA's threads
// run as threads with barriers for __syncthreads / __syncwarp, shuffles
// through a per-warp buffer, launches rewritten to tt_launch
#pragma once
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __restrict__
#define __launch_bounds__(x)
static std::atomic<long> tt_fallbacks[2];
#define TT_FALLBACK(which) (tt_fallbacks[which]++)
extern "C" long tt_fallback_count(int which) { return tt_fallbacks[which]; }
struct tt_dim3 { unsigned x; };
static thread_local tt_dim3 blockIdx, threadIdx;
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaMemcpyHostToDevice = 1 };
template <class T>
inline cudaError_t cudaMemcpyToSymbolAsync(T& sym, const void* src,
                                           size_t n, size_t off, int,
                                           cudaStream_t) {
  std::memcpy((char*)&sym + off, src, n);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline long long clock64() {
  return (long long)std::chrono::steady_clock::now().time_since_epoch()
      .count();
}
struct tt_barrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0;
  long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lk(m);
    const long g = gen;
    if (++count == n) {
      count = 0;
      gen++;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return gen != g; });
    }
  }
};
static tt_barrier tt_block_bar, tt_warp_bar[32];
static long long tt_shfl[32][32];
inline void __syncthreads() { tt_block_bar.wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  tt_warp_bar[threadIdx.x / 32].wait();
}
template <class T>
inline T tt_exchange(T v, int src) {
  const int w = threadIdx.x / 32;
  tt_shfl[w][threadIdx.x % 32] = (long long)v;
  __syncwarp();
  const T r = (T)tt_shfl[w][src & 31];
  __syncwarp();
  return r;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) { return tt_exchange(v, src); }
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m) {
  return tt_exchange(v, (int)(threadIdx.x % 32) ^ m);
}
template <class F>
inline void tt_launch(unsigned grid, unsigned block, F body) {
  tt_block_bar.n = (int)block;
  for (unsigned w = 0; w * 32 < block; w++)
    tt_warp_bar[w].n = block - w * 32 < 32 ? (int)(block - w * 32) : 32;
  for (unsigned b = 0; b < grid; b++) {
    std::vector<std::thread> th;
    for (unsigned t = 0; t < block; t++)
      th.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        body();
      });
    for (auto& x : th) x.join();
  }
}
#define TT_LAUNCH(grid, block, kernel, ...) \
  tt_launch(grid, block, [&] { kernel(__VA_ARGS__); })
"""

# the exact reorderings of speech.cuh behind a C interface, for the
# host build of the helper tests
_HELPERS = r"""
#include "cuda_runtime.h"
#include "speech.cuh"
using namespace ttsp;
extern "C" {
int32_t h_mac0_chain32(const int16_t* x, const int32_t* c, uint32_t sum_c) {
  return mac0_chain32(x, c, sum_c);
}
int32_t h_sq_chain(int32_t L0, const int16_t* x, int n) {
  return sq_chain(L0, x, n);
}
uint32_t h_sat_add_pos(uint32_t a, uint32_t b) { return sat_add_pos(a, b); }
int h_syn_filt(const int16_t* a, const int16_t* x, int nx, int16_t* y,
               int16_t* mem, int pass_only) {
  uint32_t x_max = 0, sum_a = 0;
  for (int i = 0; i < nx; i++) {
    const uint32_t m = (uint32_t)(x[i] < 0 ? -x[i] : x[i]);
    x_max = m > x_max ? m : x_max;
  }
  for (int j = 1; j <= 10; j++) sum_a += (uint32_t)(a[j] < 0 ? -a[j] : a[j]);
  if (pass_only) return syn_filt_pass(a, x, nx, y, mem, x_max, sum_a);
  syn_filt(a, x, nx, x_max, y, mem, true);
  return 1;
}
void h_syn_filt_serial(const int16_t* a, const int16_t* x, int nx,
                       int16_t* y, int16_t* mem) {
  syn_filt_serial(a, x, nx, y, mem, true);
}
int32_t h_norm_l(int32_t L) { return norm_l(L); }
int32_t h_L_shl(int32_t L, int n) { return L_shl(L, (Word16)n); }
}
"""


def _build(tmp_path_factory, name: str, source: str) -> ctypes.CDLL:
    """``source`` built with g++ against the CUDA-name shim and the
    kernel's headers: a shared library through ctypes."""
    import shutil
    import subprocess
    from pathlib import Path
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    csrc = Path(speech.__file__).resolve().parents[1] / "dsp" / "csrc"
    d = tmp_path_factory.mktemp(name)
    (d / "cuda_runtime.h").write_text(_SHIM)
    for header in ("common.cuh", "speech.cuh"):
        (d / header).write_text((csrc / header).read_text())
    (d / f"{name}.cpp").write_text(source)
    so = d / f"lib{name}.so"
    r = subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared",
                        "-pthread", "-I", str(d), "-o", str(so),
                        str(d / f"{name}.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """dsp/csrc/speech.cu built with g++ against a shim of the CUDA names
    it uses: a CTA's threads run as threads, __syncthreads and
    __syncwarp are barriers, shuffles go through a per-warp buffer, and
    the launch becomes tt_launch (the blocks one after another).  The
    kernel's own code on the CPU, ``tt_acelp`` through ctypes;
    ``tt_fallback_count(k)`` counts the step-by-step redos (0 a
    Syn_Filt pass, 1 an interpolated sample)."""
    from pathlib import Path
    csrc = Path(speech.__file__).resolve().parents[1] / "dsp" / "csrc"
    src = (csrc / "speech.cu").read_text()
    for launch, host in (
            ("acelp_kernel<<<grid, kThreads, 0, st>>>(",
             "TT_LAUNCH(grid, kThreads, acelp_kernel, "),
            ("synth_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(",
             "TT_LAUNCH(1, 32, synth_chain_kernel, ")):
        assert src.count(launch) == 1
        src = src.replace(launch, host)
    lib = _build(tmp_path_factory, "speech_host", src)
    vp = ctypes.c_void_p
    lib.tt_acelp.argtypes = [vp] * 3 + [ctypes.c_int] * 2 + [vp] * 11
    lib.tt_acelp.restype = ctypes.c_int
    lib.tt_synth_chain.argtypes = [vp, vp, ctypes.c_int] + [vp] * 4
    lib.tt_synth_chain.restype = ctypes.c_int
    lib.tt_fallback_count.restype = ctypes.c_long
    return lib


def run_host_kernel(lib, state, frames, valid, rows=None) -> tuple:
    """One tt_acelp call of the host build: (new state leaves, PCM); the
    given state is not changed."""
    st = [np.ascontiguousarray(np.array(x, np.int32)) for x in state]
    rows = (np.arange(len(st[0]), dtype=np.int32) if rows is None
            else np.ascontiguousarray(rows, np.int32))
    frames = np.ascontiguousarray(frames, np.int32)
    valid = np.ascontiguousarray(valid, np.bool_)
    pcm = np.full(frames.shape[:2] + (240,), 7, np.int32)
    rc = lib.tt_acelp(frames.ctypes.data, valid.ctypes.data, rows.ctypes.data,
                      len(rows), frames.shape[1], *(x.ctypes.data for x in st),
                      pcm.ctypes.data, speech._K_TAB.ctypes.data, None)
    assert rc == 0
    return st, pcm


def test_kernel_source_on_the_host_equals_plain(jax_ref, port_run,
                                                host_kernel):
    """The kernel's code, run on the host over the JAX fixture's second
    call for a subset of slots (``rows``, as the pool calls it): PCM and
    every state leaf equal the plain version's and the JAX package's."""
    fr, valid, j_states, j_pcms = jax_ref
    p_states, _ = port_run
    rows = np.array([5, 0, 2, 7, 3], np.int32)
    sl = slice(F_CALL, 2 * F_CALL)
    state, pcm = run_host_kernel(host_kernel, p_states[0], fr[rows, sl],
                                 valid[rows, sl], rows)
    np.testing.assert_array_equal(pcm, j_pcms[1][rows])
    others = np.setdiff1d(np.arange(S), rows)
    for name, got, want1, want2 in zip(speech.SpeechState._fields, state,
                                       p_states[0], j_states[1]):
        np.testing.assert_array_equal(got[rows], want2[rows], err_msg=name)
        np.testing.assert_array_equal(got[others], want1[others],
                                      err_msg=name)


def c_decode_from(state_row, frames: np.ndarray) -> np.ndarray:
    """(n, 138) frames through a C++ decoder set to ``state_row`` (the
    eight leaves of one slot): (n, 240) int16."""
    lib = native.codec()._LIB
    ptr = ctypes.POINTER(ctypes.c_int16)
    dec = lib.tetra_speech_decoder_new()
    try:
        buf = np.ascontiguousarray(np.concatenate(
            [np.asarray(x).reshape(-1) for x in state_row]).astype(np.int16))
        assert 2 * len(buf) == lib.tetra_speech_decoder_state_size()
        lib.tetra_speech_decoder_set_state(dec, buf.ctypes.data_as(ptr))
        fr = np.ascontiguousarray(frames.astype(np.int16))
        out = np.zeros((len(fr), 240), np.int16)
        assert lib.tetra_speech_decode_many(
            dec, fr.ctypes.data_as(ptr), len(fr),
            out.ctypes.data_as(ptr)) == 0
        return out
    finally:
        lib.tetra_speech_decoder_free(dec)


def corner_state(s: int) -> list:
    """Fresh states with a saturation corner in each slot, in turn: the
    excitation history at +-32767 (the interpolation's sums leave
    int32), that and clustered LSPs (an LPC with large coefficients: the
    filters' sums leave int32), clustered LSPs and the synthesis memory
    at +-32767, that alone; the predicted energies at their caps."""
    st = [x.numpy().copy() for x in speech.init_state(s, "cpu")]
    alt = np.where(np.arange(speech.EXC_LEN) % 2 == 0, 32767, -32768)
    for r in range(s):
        kind = r % 4
        if kind in (0, 1):
            st[0][r] = alt
        if kind in (1, 2):
            st[1][r] = st[2][r] = 0x2000 + 8 * np.arange(10)[::-1]
        if kind in (2, 3):
            st[3][r] = alt[:10]
        st[6][r], st[7][r] = 0x1B00, 0x1900
    return st


def corner_frames(s: int, n: int, seed: int) -> np.ndarray:
    """(s, n, 138) frames with the largest gains in every subframe, the
    first subframe's pitch index 0 (t0 = 19 with frac = +1), 255, 123 and
    121 in turn over the slots, and a BFI frame every other frame from
    the second in odd slots."""
    rng = np.random.default_rng(seed)
    g_max = int(np.argmax(np.asarray(T.T_QUA_ENER).reshape(-1, 2)[:, 1]))
    prm = np.zeros((s, n, 24), np.int64)
    prm[..., 1:] = rng.integers(0, 1 << np.asarray(T.BITNO, np.int64),
                                (s, n, 23))
    prm[..., [8, 13, 18, 23]] = g_max
    prm[:, :, 4] = np.array([0, 255, 123, 121])[np.arange(s) % 4, None]
    prm[1::2, 1::2, 0] = 1
    return speech.prm2bits(prm)


def test_kernel_source_on_the_host_saturation_corners(host_kernel):
    """States and frames that saturate: the host build's PCM and every
    leaf equal the plain version's, every slot's PCM the C++ decoder's
    from the same state, and both step-by-step redos (a Syn_Filt pass's
    and an interpolated sample's) ran."""
    s, n = 8, 4
    st0 = corner_state(s)
    fr = corner_frames(s, n, seed=5)
    valid = np.ones((s, n), bool)
    before = [host_kernel.tt_fallback_count(k) for k in (0, 1)]
    state, pcm = run_host_kernel(host_kernel, st0, fr, valid)
    redos = [host_kernel.tt_fallback_count(k) - b
             for k, b in zip((0, 1), before)]
    p_state, p_pcm = speech.decode_block(
        speech.SpeechState(*(torch.from_numpy(x) for x in st0)),
        torch.from_numpy(fr), torch.from_numpy(valid))
    np.testing.assert_array_equal(pcm, p_pcm.numpy())
    for name, got, want in zip(speech.SpeechState._fields, state, p_state):
        np.testing.assert_array_equal(got, want.numpy(), err_msg=name)
    saturated = 0
    for r in range(s):
        want = c_decode_from([x[r] for x in st0], fr[r])
        np.testing.assert_array_equal(pcm[r], want, err_msg=f"slot {r}")
        saturated += int((np.abs(want) >= 32767).sum())
    assert saturated > 0
    assert redos[0] > 0 and redos[1] > 0, redos


@pytest.mark.parametrize("seed", [83, 84])
def test_kernel_source_on_the_host_over_passes(host_kernel, seed):
    """Calls of 3 and 17 frames (the kernel decodes 16 frames a pass, so
    the second call takes two): each slot's valid frames equal a fresh
    C++ decoder's, the state carried across passes and calls."""
    s, n = 6, 20
    fr, valid = streams(seed, s, n)
    state = [x.numpy() for x in speech.init_state(s, "cpu")]
    pcm = []
    for lo, hi in ((0, 3), (3, n)):
        state, p = run_host_kernel(host_kernel, state, fr[:, lo:hi],
                                   valid[:, lo:hi])
        pcm.append(p)
    pcm = np.concatenate(pcm, axis=1)
    for i in range(s):
        np.testing.assert_array_equal(pcm[i][valid[i]],
                                      c_decode(fr[i][valid[i]]),
                                      err_msg=f"slot {i}")
    assert not pcm[~valid].any()


@pytest.mark.parametrize("old_t0", [0, -5, -30000, 30000])
def test_kernel_source_on_the_host_runs_a_state_no_decoder_left(host_kernel,
                                                                old_t0):
    """A BFI frame replays the state's lag, which a decoder keeps in
    19..144: from a lag outside that range the host build still runs
    through (no stalled rounds, no read before its buffers) and leaves a
    state of the right shapes."""
    s, n = 2, 3
    fr, _ = streams(97, s, n)
    fr[:, :, 0] = 1
    state = [x.numpy() for x in speech.init_state(s, "cpu")]
    state[5][:] = old_t0
    new, pcm = run_host_kernel(host_kernel, state, fr, np.ones((s, n), bool))
    assert pcm.shape == (s, n, 240)
    assert [x.shape for x in new] == [x.shape for x in state]
    assert (new[5] == old_t0).all()


@pytest.mark.parametrize("scale", [1, 8])
def test_synth_chain_on_the_host_equals_plain(host_kernel, scale):
    """The floor's yardstick (csrc/speech.cu synth_chain_kernel, built for
    the host) gives probes.synth_chain_plain's outputs and memory: 64
    subframes carried one into the next, LPC of the size a decoder's
    filters have (scale 1: the reordered pass holds) and eight times
    that with inputs at the Word16 limits (scale 8: the step-by-step
    redo)."""
    from tetraear_tpu_torch.dsp import probes
    rng = np.random.default_rng(11 + scale)
    n = probes.SYNTH_CHAIN_MAX
    a = rng.integers(-3000 * scale, 3000 * scale + 1, (n, 11))
    a = np.clip(a, -32768, 32767).astype(np.int32)
    a[:, 0] = 4096
    x = rng.integers(-1000 * scale, 1000 * scale + 1, (n, 60))
    x = np.clip(x, -32768, 32767).astype(np.int32)
    mem = rng.integers(-2000, 2001, 10).astype(np.int32)
    y = np.zeros((n, 60), np.int32)
    m = mem.copy()
    cycles = np.zeros(1, np.int64)
    before = host_kernel.tt_fallback_count(0)
    assert host_kernel.tt_synth_chain(a.ctypes.data, x.ctypes.data, n,
                                      m.ctypes.data, y.ctypes.data,
                                      cycles.ctypes.data, None) == 0
    redos = host_kernel.tt_fallback_count(0) - before
    want_y, want_m, _ = probes.synth_chain(
        torch.from_numpy(a), torch.from_numpy(x), torch.from_numpy(mem))
    np.testing.assert_array_equal(y, want_y.numpy())
    np.testing.assert_array_equal(m, want_m.numpy())
    assert cycles[0] > 0
    assert (redos > 0) == (scale > 1)


# ---- the exact reorderings (speech.cuh), on the host ----------------------

from hypothesis import given, settings, strategies as hst  # noqa: E402

_W16 = hst.integers(-32768, 32767)
_EXTREME16 = hst.sampled_from([-32768, -32767, -16384, -1, 0, 1, 16384,
                               32766, 32767])
_WORD16 = hst.one_of(_W16, _EXTREME16)
_WORD32 = hst.one_of(hst.integers(-2 ** 31, 2 ** 31 - 1),
                     hst.sampled_from([-2 ** 31, -2 ** 31 + 1, -1, 0, 1,
                                       2 ** 30, 2 ** 31 - 1]))
_SETTINGS = settings(max_examples=150, deadline=None, database=None)


@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    lib = _build(tmp_path_factory, "speech_helpers", _HELPERS)
    i16p, i32 = ctypes.POINTER(ctypes.c_int16), ctypes.c_int32
    lib.h_mac0_chain32.argtypes = [i16p, ctypes.POINTER(i32), ctypes.c_uint32]
    lib.h_mac0_chain32.restype = i32
    lib.h_sq_chain.argtypes = [i32, i16p, ctypes.c_int]
    lib.h_sq_chain.restype = i32
    lib.h_sat_add_pos.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.h_sat_add_pos.restype = ctypes.c_uint32
    lib.h_syn_filt.argtypes = [i16p, i16p, ctypes.c_int, i16p, i16p,
                               ctypes.c_int]
    lib.h_syn_filt.restype = ctypes.c_int
    lib.h_syn_filt_serial.argtypes = [i16p, i16p, ctypes.c_int, i16p, i16p]
    lib.h_norm_l.argtypes = [i32]
    lib.h_norm_l.restype = i32
    lib.h_L_shl.argtypes = [i32, ctypes.c_int]
    lib.h_L_shl.restype = i32
    return lib


def _i16(a) -> tuple:
    arr = np.ascontiguousarray(a, np.int16)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _t(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int64)


def _serial_mac0(L0: int, x, c) -> int:
    """The reference's chain with voice/fixed.py's L_mac0, step by step."""
    L = _t(L0)
    for xv, cv in zip(x, c):
        L = fixed.L_mac0(L, _t(int(xv)), _t(int(cv)))
    return int(L)


@_SETTINGS
@given(x=hst.lists(_WORD16, min_size=32, max_size=32),
       which=hst.sampled_from(["COEF1", "COEF2"]))
def test_mac0_chain32_equals_the_serial_chain(helpers, x, which):
    """The interpolation's form (the filters' own coefficients, as the
    kernel holds them) against L_mac0 step by step."""
    c = np.asarray(getattr(T, which), np.int32)
    xa, xp = _i16(x)
    cc = np.ascontiguousarray(c, np.int32)
    got = helpers.h_mac0_chain32(
        xp, cc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(np.abs(c).sum()))
    assert got == _serial_mac0(0, x, c)


def test_mac0_chain32_redoes_a_saturating_window(helpers):
    """Every window sample at +-32767 with the coefficients' signs: the
    sum leaves int32 and the redo gives the saturated chain."""
    c = np.asarray(T.COEF1, np.int32)
    x = np.where(c >= 0, 32767, -32768)
    xa, xp = _i16(x)
    got = helpers.h_mac0_chain32(
        xp, np.ascontiguousarray(c).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)), int(np.abs(c).sum()))
    assert got == _serial_mac0(0, x, c) == 2 ** 31 - 1


@_SETTINGS
@given(L0=hst.integers(0, 2 ** 31 - 1),
       x=hst.lists(_WORD16, min_size=0, max_size=70))
def test_sq_chain_equals_the_serial_chain(helpers, L0, x):
    xa, xp = _i16(x)
    assert helpers.h_sq_chain(L0, xp, len(x)) == _serial_mac0(L0, x, x)


@_SETTINGS
@given(a=hst.integers(0, 2 ** 31 - 1), b=hst.integers(0, 2 ** 31 - 1))
def test_sat_add_pos_is_the_saturating_sum(helpers, a, b):
    assert helpers.h_sat_add_pos(a, b) == int(fixed.L_add(_t(a), _t(b)))


def _serial_syn_filt(a, x, mem) -> tuple:
    """Syn_Filt over 60 samples with voice/fixed.py, step by step (the
    plain version's _syn_filt on one row)."""
    cols = [_t([int(v)]) for v in x] + [_t([0])] * (60 - len(x))
    y, m = speech._syn_filt([_t([int(v)]) for v in a], cols,
                            [_t([int(v)]) for v in mem])
    return (np.array([int(v) for v in y], np.int16),
            np.array([int(v) for v in m], np.int16))


@_SETTINGS
@given(data=hst.data(), scale=hst.sampled_from([1, 8, 64, 4096, 32767]),
       nx=hst.sampled_from([1, 11, 60]))
def test_syn_filt_equals_the_serial_filter(helpers, data, scale, nx):
    """The reordered filter (with its redo) and the kernel's serial one
    against the plain version's step-by-step filter: outputs and memory,
    from LPCs of every size (scale) and memories up to the extremes."""
    a = [4096] + [data.draw(hst.integers(-scale, min(scale, 32767)))
                  for _ in range(10)]
    x = data.draw(hst.lists(_WORD16, min_size=nx, max_size=nx))
    mem = data.draw(hst.lists(_WORD16, min_size=10, max_size=10))
    want_y, want_m = _serial_syn_filt(a, x, mem)
    aa, ap = _i16(a)
    xa, xp = _i16(x)
    for fn in ("h_syn_filt", "h_syn_filt_serial"):
        y, yp = _i16(np.zeros(60))
        m, mp = _i16(mem)
        if fn == "h_syn_filt":
            helpers.h_syn_filt(ap, xp, nx, yp, mp, 0)
        else:
            helpers.h_syn_filt_serial(ap, xp, nx, yp, mp)
        np.testing.assert_array_equal(y, want_y, err_msg=fn)
        np.testing.assert_array_equal(m, want_m, err_msg=fn)


def test_syn_filt_takes_the_fast_pass_on_speech_and_redoes_overflow(helpers):
    """A speech-like LPC and input: the reordered pass holds on its own
    (no redo); a large-coefficient LPC on a memory at +-32767: the pass
    gives way and the redo still equals the serial filter."""
    a = [4096, -6000, 3000, -800, 300, -100, 50, -20, 10, -5, 2]
    rng = np.random.default_rng(2)
    x = rng.integers(-3000, 3000, 60)
    aa, ap = _i16(a)
    xa, xp = _i16(x)
    y, yp = _i16(np.zeros(60))
    m, mp = _i16(np.zeros(10))
    assert helpers.h_syn_filt(ap, xp, 60, yp, mp, 1) == 1
    a2 = [4096] + [30000, -30000] * 5
    mem = np.where(np.arange(10) % 2 == 0, 32767, -32768)
    aa2, ap2 = _i16(a2)
    m2, mp2 = _i16(mem)
    assert helpers.h_syn_filt(ap2, xp, 60, yp, mp2, 1) == 0
    want_y, want_m = _serial_syn_filt(a2, x, mem)
    m2, mp2 = _i16(mem)
    helpers.h_syn_filt(ap2, xp, 60, yp, mp2, 0)
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(m2, want_m)


@_SETTINGS
@given(L=_WORD32, n=hst.integers(-40, 40))
def test_closed_form_norm_l_and_L_shl_equal_fixed(helpers, L, n):
    assert helpers.h_norm_l(L) == int(fixed.norm_l(_t(L)))
    assert helpers.h_L_shl(L, n) == int(fixed.L_shl(_t(L), n))
