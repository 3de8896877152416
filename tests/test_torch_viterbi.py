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
    """viterbi.cu's steps in numpy, one block at a time, from the
    kernel's tables (_K_POS, _K_SIGN, _K_CRC) and its bit layout."""
    b = soft.shape[0]
    ordered = np.zeros((b, viterbi.ORDERED_BITS), np.uint8)
    bfi = np.zeros(b, bool)
    i = np.arange(432)
    pos = viterbi._K_POS.reshape(T.STEPS, 3)
    sign = viterbi._K_SIGN.reshape(16, 6).astype(np.int64)
    crc = viterbi._K_CRC.reshape(8, 3)
    ns = np.arange(16)
    p0 = 2 * (ns & 7)
    for k in range(b):
        row = np.zeros(436, np.int64)
        row[18 * (i % 24) + i // 24] = soft[k]
        ordered[k, :T.N0] = row[:T.N0] < 0
        m = np.where(ns == 0, 0, -(1 << 28)).astype(np.int64)
        words = []
        for st in range(T.STEPS):
            r = row[pos[st]]
            c0 = m[p0] + sign[:, :3] @ r
            c1 = m[p0 + 1] + sign[:, 3:] @ r
            take1 = c1 > c0
            m = np.where(take1, c1, c0)
            words.append(int(np.sum(take1.astype(np.int64) << ns)))
        w = [0, 0, 0]
        state = 0
        for st in range(T.STEPS - 1, -1, -1):
            bit = state >> 3
            ordered[k, T.N0 + st] = bit
            q = T.N0 + st - 214
            if 0 <= q < 68:
                w[q >> 5] |= bit << (q & 31)
            state = 2 * (state & 7) + ((words[st] >> state) & 1)
        bad = 0
        for c in range(8):
            bad |= sum(bin(w[j] & int(crc[c, j])).count("1")
                       for j in range(3)) & 1
        bfi[k] = bool(bad)
    return ordered, bfi


def test_kernel_tables(codec):
    soft = np.concatenate([
        _encoded_blocks(codec, 3, 60, seed=5),
        np.random.default_rng(6).integers(-127, 128, (3, 432)),
        np.zeros((1, 432), np.int64)]).astype(np.int32)
    ordered, bfi = viterbi.decode(torch.from_numpy(soft))
    got_o, got_b = _kernel_walk(soft)
    np.testing.assert_array_equal(got_o, ordered.numpy())
    np.testing.assert_array_equal(got_b, bfi.numpy())
