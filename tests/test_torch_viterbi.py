"""The speech channel decoder of the port (voice/viterbi.py) against the
JAX package's batched decoder (voice/jviterbi.py) and the port's C++
decoder (voice/csrc/channel.cpp, tetra_channel_decode): frames and BFI
bit for bit, tolerance 0.

On the CPU ``viterbi.decode`` runs its plain PyTorch version; the CUDA
kernel (dsp/csrc/viterbi.cu) is held against it on the card
(tests/test_torch_cuda.py, chip_smoke.py).  ``test_kernel_tables`` walks
the kernel's own tables and bit layout (its deinterleave arithmetic,
step positions with the zero pad, int8 signs, ballot words, CRC tap
words) in numpy, so an error there shows here too.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tetraear_tpu.voice import jviterbi  # noqa: E402
from tetraear_tpu_torch import native  # noqa: E402
from tetraear_tpu_torch.dsp import cuda_kernels as ck  # noqa: E402
from tetraear_tpu_torch.voice import etsi_tables as T  # noqa: E402
from tetraear_tpu_torch.voice import viterbi  # noqa: E402


@pytest.fixture(scope="module")
def codec():
    return native.codec()


def _encoded_blocks(codec, b: int, sigma: float, seed: int) -> np.ndarray:
    """(b, 432) int32 soft bits: random speech parameters channel-coded by
    the C++ encoder (+-127), plus Gaussian noise of ``sigma``, clipped to
    the codec block's range."""
    rng = np.random.default_rng(seed)
    ptr = ctypes.POINTER(ctypes.c_int16)
    out = np.zeros((b, 432), np.int32)
    for i in range(b):
        params = np.zeros((2, 138), np.int16)
        params[:, 1:] = rng.integers(0, 2, (2, 137))
        block = np.zeros(690, np.int16)
        codec._LIB.tetra_channel_encode(params.ctypes.data_as(ptr),
                                        block.ctypes.data_as(ptr))
        out[i] = codec.block_soft_bits(block.tobytes())
    noisy = out + sigma * rng.standard_normal(out.shape)
    return np.clip(np.round(noisy), -127, 127).astype(np.int32)


def _cpp(codec, soft: np.ndarray) -> tuple:
    """The C++ decoder on each block: ((B, 2, 137) frames, (B,) bfi)."""
    vp = codec.VoiceProcessor()
    frames, bfi = [], []
    for row in soft:
        block = np.zeros(690, np.int16)
        block[0] = codec.CODEC_HEADER
        spans = [(1, 115), (116, 230), (231, 345), (346, 436)]
        pos = 0
        for lo, hi in spans:
            block[lo:hi] = row[pos:pos + hi - lo]
            pos += hi - lo
        out = vp.channel_decode(block.tobytes())
        assert out[0, 0] == out[1, 0]
        frames.append(out[:, 1:].astype(np.uint8))
        bfi.append(bool(out[0, 0]))
    return np.stack(frames), np.array(bfi)


def _check_all_three(codec, soft: np.ndarray) -> dict:
    got = viterbi.channel_decode_batch(soft, device="cpu")
    want = jviterbi.channel_decode_batch(soft)
    np.testing.assert_array_equal(got["frames"], want["frames"])
    np.testing.assert_array_equal(got["bfi"], want["bfi"])
    frames, bfi = _cpp(codec, soft)
    np.testing.assert_array_equal(got["frames"], frames)
    np.testing.assert_array_equal(got["bfi"], bfi)
    return got


@pytest.mark.parametrize("sigma", [0, 40, 80, 120])
def test_encoded_blocks_with_noise(codec, sigma):
    soft = _encoded_blocks(codec, 17, sigma, seed=sigma)
    got = _check_all_three(codec, soft)
    if sigma == 0:
        assert not got["bfi"].any()


@pytest.mark.parametrize("b", [1, 2, 17])
def test_pure_noise_blocks(codec, b):
    """Noise gives many equal path metrics: the even predecessor must win
    every tie, as in the C++ decoder."""
    rng = np.random.default_rng(100 + b)
    soft = rng.integers(-127, 128, (b, 432)).astype(np.int32)
    # small values make ties likelier still
    soft[::2] = rng.integers(-2, 3, soft[::2].shape)
    _check_all_three(codec, soft)


def test_all_zero_blocks(codec):
    _check_all_three(codec, np.zeros((3, 432), np.int32))


def test_empty_batch():
    got = viterbi.channel_decode_batch(np.zeros((0, 432), np.int32),
                                       device="cpu")
    assert got["frames"].shape == (0, 2, 137)
    assert got["bfi"].shape == (0,)


def test_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        viterbi.decode(torch.zeros((2, 431), dtype=torch.int32))
    with pytest.raises(ValueError):
        viterbi.decode(torch.zeros((2, 432), dtype=torch.int16))


def _kernel_walk(soft: np.ndarray) -> tuple:
    """viterbi.cu's steps in numpy, all blocks at once, from the kernel's
    table (_K_TABLE: step codes, lane codes, CRC words) and its layout:
    the deinterleaved row with its zero pad, the class-0 signs as ballot
    words, each step's four sums r0 + r1 + r2, r0 + r1 - r2, r0 - r1 + r2,
    r0 - r1 - r2 wrapping as int32, each state's sum index and sign for
    both parities, ballot words, the traceback as a history register h
    (a rotate of the decision word by h, a shift-or; a word of decoded
    bits every 32 steps), the CRC words cut from them, the output row
    packed as bit words and expanded four bits to four bytes."""
    b = soft.shape[0]
    m32 = np.uint64(0xFFFFFFFF)
    tab = viterbi._K_TABLE
    step, lanes = tab[:T.STEPS].astype(np.int64), tab[T.STEPS:T.STEPS + 16]
    crc = tab[T.STEPS + 16:].view(np.uint32).reshape(8, 3)
    i = np.arange(432)
    row = np.zeros((b, 436), np.int64)
    row[:, 18 * (i % 24) + i // 24] = soft
    j = np.arange(128)
    neg = ((j < T.N0) & (row[:, np.minimum(j, 435)] < 0)).astype(np.uint64)
    ob = np.zeros((b, 10), np.uint64)
    ob[:, :4] = (neg.reshape(b, 4, 32) << np.arange(32, dtype=np.uint64)
                 ).sum(axis=2)
    r = [row[:, (step >> sh) & 1023].astype(np.uint32)
         for sh in (0, 10, 20)]                                  # (B, 184)
    a, d = r[0] + r[1], r[0] - r[1]
    sums = np.stack([a + r[2], a - r[2], d + r[2], d - r[2]], axis=-1)
    idx = np.stack([lanes & 3, (lanes >> 3) & 3], axis=1)        # (16, 2)
    sign = np.where(np.stack([(lanes >> 2) & 1, (lanes >> 5) & 1], axis=1),
                    np.uint32(0xFFFFFFFF), np.uint32(1)).astype(np.uint32)
    ns = np.arange(16)
    p0 = 2 * (ns & 7)
    m = np.where(ns == 0, 0, -(1 << 28)).astype(np.int32)[None].repeat(b, 0)
    dec = np.zeros((b, 196), np.int64)
    for st in range(T.STEPS):
        q = sums[:, st]                                          # (B, 4)
        c0 = (q[:, idx[:, 0]] * sign[:, 0] + m[:, p0].view(np.uint32))
        c1 = (q[:, idx[:, 1]] * sign[:, 1] + m[:, p0 + 1].view(np.uint32))
        c0, c1 = c0.view(np.int32), c1.view(np.int32)
        take1 = c1 > c0
        m = np.maximum(c0, c1)
        dec[:, st] = (take1.astype(np.int64) << ns).sum(axis=1)
    h = np.zeros(b, np.uint64)
    wd = np.zeros((b, 6), np.uint64)
    for k in range(5, -1, -1):
        for jj in range(31, -1, -1):
            dd = dec[:, 32 * k + 4 + jj].astype(np.uint64)
            dd = dd | (dd << np.uint64(16))                  # the half, twice
            bit = (dd >> (h & np.uint64(31))) & np.uint64(1)
            h = ((h << np.uint64(1)) | bit) & m32
        wd[:, k] = h
    c = [((wd[:, 3] >> np.uint64(16)) | (wd[:, 4] << np.uint64(16))) & m32,
         ((wd[:, 4] >> np.uint64(16)) | (wd[:, 5] << np.uint64(16))) & m32,
         (wd[:, 5] >> np.uint64(16)) & np.uint64(0xF)]
    bad = np.zeros(b, np.int64)
    for k in range(8):
        bad |= sum(np.array([bin(int(x) & int(crc[k, jj])).count("1")
                             for x in c[jj]]) for jj in range(3)) & 1
    ob[:, 3] |= (wd[:, 0] << np.uint64(6)) & m32
    for k in range(4, 9):
        ob[:, k] = ((wd[:, k - 4] >> np.uint64(26))
                    | (wd[:, k - 3] << np.uint64(6))) & m32
    t = np.arange(0, viterbi.ORDERED_BITS, 4)
    x = ((ob[:, t >> 5] | (ob[:, (t >> 5) + 1] << np.uint64(32)))
         >> (t & 31).astype(np.uint64)) & np.uint64(15)
    words = (x * np.uint64(0x00204081)) & np.uint64(0x01010101)
    ordered = np.ascontiguousarray(words.astype("<u4")).view(
        np.uint8).reshape(b, -1)
    return ordered[:, :viterbi.ORDERED_BITS], bad.astype(bool)


def test_kernel_tables(codec):
    soft = np.concatenate([
        _encoded_blocks(codec, 3, 60, seed=5),
        np.random.default_rng(6).integers(-127, 128, (3, 432)),
        np.zeros((1, 432), np.int64)]).astype(np.int32)
    ordered, bfi = viterbi.decode(torch.from_numpy(soft))
    got_o, got_b = _kernel_walk(soft)
    np.testing.assert_array_equal(got_o, ordered.numpy())
    np.testing.assert_array_equal(got_b, bfi.numpy())


def _kind_blocks(codec, kind: str, b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "encoded":
        return _encoded_blocks(codec, b, 40, seed)
    if kind == "noise":
        return rng.integers(-127, 128, (b, 432)).astype(np.int32)
    if kind == "ties":
        return rng.integers(-2, 3, (b, 432)).astype(np.int32)
    return np.zeros((b, 432), np.int32)


@pytest.mark.parametrize("b", [1, 2, 17, 170])
@pytest.mark.parametrize("kind", ["encoded", "noise", "ties", "zero"])
def test_kernel_walk_equals_plain_jax_and_cpp(codec, kind, b):
    """The kernel's steps on its tables (the walk) equal decode_plain, the
    JAX channel_decode_batch_traced and the C++ decoder, bit for bit, on
    encoded blocks under noise (sigma 40), pure noise, small values in
    [-2, 2] (ties everywhere) and zero blocks, at B 1, 2, 17 and 170
    (170: the voice fleet's launches)."""
    soft = _kind_blocks(codec, kind, b, seed=b)
    got_o, got_b = _kernel_walk(soft)
    o_p, b_p = viterbi.decode_plain(torch.from_numpy(soft))
    np.testing.assert_array_equal(got_o, o_p.numpy())
    np.testing.assert_array_equal(got_b, b_p.numpy())
    o_j, b_j = jviterbi.channel_decode_batch_traced(soft)
    np.testing.assert_array_equal(got_o, np.asarray(o_j))
    np.testing.assert_array_equal(got_b, np.asarray(b_j))
    frames, bfi = _cpp(codec, soft)
    np.testing.assert_array_equal(viterbi._unbuild(got_o), frames)
    np.testing.assert_array_equal(got_b, bfi)


def test_sum_table_matches_the_signs():
    """Each state's (index, sign) names the sum that equals its branch
    metric s0 r0 + s1 r1 + s2 r2 for both parities, on random values."""
    rng = np.random.default_rng(3)
    r = rng.integers(-2**31, 2**31, (64, 3)).astype(np.int64)
    sums = np.stack([r[:, 0] + r[:, 1] + r[:, 2], r[:, 0] + r[:, 1] - r[:, 2],
                     r[:, 0] - r[:, 1] + r[:, 2], r[:, 0] - r[:, 1] - r[:, 2]],
                    axis=1)
    for ns in range(16):
        for par in range(2):
            want = r @ viterbi._SIGNS[ns, par].astype(np.int64)
            q = sums[:, viterbi._K_SUM_IDX[ns, par]]
            got = -q if viterbi._K_SUM_NEG[ns, par] else q
            np.testing.assert_array_equal((got - want) % 2**32, 0)


def test_cta_warps_spread_small_batches():
    """A CTA of one warp up to two CTAs an SM (the live path's B ~170 on
    ~85 SMs), two, then four."""
    assert [viterbi.cta_warps(b, 132) for b in (1, 2, 170, 528)] == [1] * 4
    assert viterbi.cta_warps(529, 132) == 2
    assert viterbi.cta_warps(1057, 132) == 4
    assert viterbi.cta_warps(81920, 132) == 4


def test_decode_passes_no_host_tables(monkeypatch):
    """On the kernel route a call launches with device pointers and
    integers only: the table is one tensor uploaded on the first call and
    reused, and no host memory is passed to the C entry.  (The route is
    forced on CPU tensors with a recording stand-in for the C entry.)"""
    launched = []
    monkeypatch.setattr(ck, "_route", lambda *t: "cuda")
    monkeypatch.setattr(ck, "build", lambda: type("L", (), {
        "tt_viterbi": "tt_viterbi"})())
    monkeypatch.setattr(ck, "_launch",
                        lambda name, dev, fn, *args: launched.append(
                            (name, fn, args)))
    monkeypatch.setattr(viterbi, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(viterbi, "_TABLE_ON", {})
    soft = torch.zeros((5, 432), dtype=torch.int32)
    outs = []
    for _ in range(2):
        ordered, bfi = viterbi.decode(soft)
        assert ordered.shape == (5, 286) and bfi.dtype == torch.bool
        outs.append((ordered, bfi))
    assert len(launched) == 2 and len(viterbi._TABLE_ON) == 1
    table = viterbi._TABLE_ON["cpu"]
    for (name, fn, args), (ordered, bfi) in zip(launched, outs):
        assert (name, fn) == ("viterbi_decode", "tt_viterbi")
        ptrs = [a.value for a in args if not isinstance(a, int)]
        assert ptrs == [soft.data_ptr(), table.data_ptr(),
                        ordered.data_ptr(), bfi.data_ptr()]
        assert args[4:] == (5, 1)
    assert torch.equal(table, torch.from_numpy(viterbi._K_TABLE))
