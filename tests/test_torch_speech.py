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
// the CUDA names speech.cu uses, for a host build of it
#pragma once
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __restrict__
#define __launch_bounds__(x)
struct tt_dim3 { unsigned x; };
static tt_dim3 blockIdx, threadIdx;
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
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """dsp/csrc/speech.cu built with g++ against a shim of the CUDA names
    it uses, the launch rewritten as a loop over blocks and threads: the
    kernel's own code on the CPU, ``tt_acelp`` through ctypes."""
    import shutil
    import subprocess
    from pathlib import Path
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    csrc = Path(speech.__file__).resolve().parents[1] / "dsp" / "csrc"
    d = tmp_path_factory.mktemp("speech_host")
    (d / "cuda_runtime.h").write_text(_SHIM)
    for name in ("common.cuh", "speech.cuh"):
        (d / name).write_text((csrc / name).read_text())
    src = (csrc / "speech.cu").read_text()
    launch = "acelp_kernel<<<grid, kThreads, 0, st>>>("
    assert src.count(launch) == 1
    src = src.replace(launch, (
        "for (blockIdx.x = 0; blockIdx.x < grid; ++blockIdx.x) "
        "for (threadIdx.x = 0; threadIdx.x < kThreads; ++threadIdx.x) "
        "acelp_kernel("))
    (d / "speech_host.cpp").write_text(src)
    so = d / "libspeech_host.so"
    r = subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared",
                        "-I", str(d), "-o", str(so),
                        str(d / "speech_host.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.tt_acelp.argtypes = [vp] * 3 + [ctypes.c_int] * 2 + [vp] * 11
    lib.tt_acelp.restype = ctypes.c_int
    return lib


def test_kernel_source_on_the_host_equals_plain(jax_ref, port_run,
                                                host_kernel):
    """The kernel's code, run on the host over the JAX fixture's second
    call for a subset of slots (``rows``, as the pool calls it): PCM and
    every state leaf equal the plain version's and the JAX package's."""
    fr, valid, j_states, j_pcms = jax_ref
    p_states, _ = port_run
    rows = np.array([5, 0, 2, 7, 3], np.int32)
    sl = slice(F_CALL, 2 * F_CALL)
    frames = np.ascontiguousarray(fr[rows, sl])
    v = np.ascontiguousarray(valid[rows, sl])
    state = [np.ascontiguousarray(x.copy()) for x in p_states[0]]
    pcm = np.full((len(rows), F_CALL, 240), 7, np.int32)
    rc = host_kernel.tt_acelp(
        frames.ctypes.data, v.ctypes.data, rows.ctypes.data, len(rows),
        F_CALL, *(x.ctypes.data for x in state), pcm.ctypes.data,
        speech._K_TAB.ctypes.data, None)
    assert rc == 0
    np.testing.assert_array_equal(pcm, j_pcms[1][rows])
    others = np.setdiff1d(np.arange(S), rows)
    for name, got, want1, want2 in zip(speech.SpeechState._fields, state,
                                       p_states[0], j_states[1]):
        np.testing.assert_array_equal(got[rows], want2[rows], err_msg=name)
        np.testing.assert_array_equal(got[others], want1[others],
                                      err_msg=name)
