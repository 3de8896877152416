"""The port's native frame parser (frame/csrc/hitparse.cpp, built with g++
at first use by tetraear_tpu_torch.native) against its Python path and
against the JAX package's native parser, on the same candidate windows:
clean CRC-passing slots (SDS texts, sync bursts, stolen slots, SYSINFO
headers), the same slots with bit errors that fail the CRC, and slots
cut short (zeros after a random point, as at the end of a capture).
Every verdict and every decoded frame must agree exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tetraear_tpu.frame import hitparse as jax_hitparse  # noqa: E402
from tetraear_tpu.frame.decoder import TetraDecoder as JaxDecoder  # noqa
from tetraear_tpu_torch import native  # noqa: E402
from tetraear_tpu_torch.frame import burst as burst_mod  # noqa: E402
from tetraear_tpu_torch.frame.decoder import (FRAME_LENGTH,  # noqa: E402
                                              SYNC_LEN, TS_OFFSET_BITS,
                                              TetraDecoder)
from tetraear_tpu_torch.ref import golden  # noqa: E402


@pytest.fixture(scope="module")
def hitparse():
    mod = native.hitparse()
    assert mod.available(), "the port's native parser did not load"
    return mod


def _windows(kind: str, n: int = 40, seed: int = 5) -> np.ndarray:
    """n candidate windows of one kind (see the module docstring)."""
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 2, (n, FRAME_LENGTH)).astype(np.uint8)
    for i in range(n):
        sub = i % 4
        if sub == 0:
            payload = golden.sds_text_payload(f"WIN {i:02d} TEST")
            slot = golden.build_slot(
                golden.build_mac_resource_data_bits(payload), rng=rng)
            wins[i] = slot[:FRAME_LENGTH]
        elif sub == 1:
            wins[i, 255:277] = burst_mod.SYNC_CONTINUOUS_DOWNLINK
        elif sub == 2:
            wins[i, TS_OFFSET_BITS:TS_OFFSET_BITS + SYNC_LEN] = (
                burst_mod.SYNC_DISCONTINUOUS_DOWNLINK)
        else:
            head = np.zeros(40, np.uint8)
            head[0:2] = [1, 0]
            head[4:14] = [(260 >> (9 - j)) & 1 for j in range(10)]
            wins[i, :40] = head
    if kind == "crc_fail":
        for i in range(n):
            flip = rng.choice(np.r_[0:216, 238:454], 4, replace=False)
            wins[i, flip] ^= 1
    elif kind == "truncated":
        for i in range(n):
            wins[i, rng.integers(100, FRAME_LENGTH):] = 0
    return wins


def _strip(frame):
    return None if frame is None else {k: v for k, v in frame.items()
                                       if k != "bits"}


@pytest.mark.parametrize("kind", ["clean", "crc_fail", "truncated"])
def test_native_python_and_jax_parsers_agree(hitparse, kind):
    wins = _windows(kind, seed={"clean": 5, "crc_fail": 6,
                                "truncated": 7}[kind])
    hb = hitparse.parse_windows(wins)
    jb = jax_hitparse.parse_windows(wins)
    assert jb is not None, "the JAX package's parser is not built"
    for name in hb.__slots__:
        if name != "n":
            np.testing.assert_array_equal(getattr(hb, name),
                                          getattr(jb, name), name)
    native_dec = TetraDecoder(auto_decrypt=False)
    python_dec = TetraDecoder(auto_decrypt=False)
    jax_dec = JaxDecoder(auto_decrypt=False)
    n_crc = 0
    for i, win in enumerate(wins):
        fn = native_dec.decode_frame(win, 0, frame_number=i, pre=hb.pre(i))
        fp = python_dec.decode_frame(win, 0, frame_number=i)
        fj = jax_dec.decode_frame(win, 0, frame_number=i, pre=jb.pre(i))
        assert _strip(fn) == _strip(fp), i
        assert _strip(fn) == _strip(fj), i
        n_crc += bool(hb.crc_ok[i])
    assert native_dec.protocol_parser.stats == python_dec.protocol_parser.stats
    if kind == "clean":
        assert n_crc >= 10


def test_frame_layer_native_equals_python(hitparse, monkeypatch):
    """BatchedFrameDecoder.process on a golden symbol stream: the frames
    of the native parse equal those of the Python parse."""
    from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder
    payloads = [golden.sds_text_payload(f"LAYER {i}") for i in range(12)]
    bits = golden.build_stream(payloads, seed=3, sysinfo_every=4)
    rng = np.random.default_rng(4)
    rows = []
    for shift in (0, 6, 14):
        b = np.concatenate([rng.integers(0, 2, 2 * shift), bits])
        b = b[:len(bits) // 2 * 2]
        rows.append((b[0::2] << 1) | b[1::2])
    hard = np.stack(rows).astype(np.uint8)
    valid = np.ones(hard.shape, bool)

    def run():
        layer = BatchedFrameDecoder(len(hard), auto_decrypt=False,
                                    device="cpu")
        return [_strip(f) for f in layer.process(hard, None, valid)]

    native_frames = run()
    # the explicit switch: the layer's build step then loads no library
    monkeypatch.setenv("TETRAEAR_HITPARSE", "0")
    monkeypatch.setattr(hitparse, "_LIB", None)
    python_frames = run()
    assert not hitparse.available()
    assert native_frames == python_frames
    assert sum(1 for f in native_frames if f.get("burst_crc")) >= 20
