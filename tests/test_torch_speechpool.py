"""Speech synthesis on the device (PipelineConfig.device_voice): the
port's slot bank (voice/speech_pool.py) and the Pipeline's device voice
path, on the CPU (the plain decoder stands in for the kernel).

  * the pool's carrier -> slot map, LRU eviction and the fresh-decoder
    resync of an evicted carrier (as tests/unit/test_device_voice.py);
  * its checkpoint leaves: count, order, shapes and dtypes of the JAX
    package's SpeechState, and a restore that goes on where it stopped;
  * ``Pipeline(device="cpu", device_voice=True)`` on the golden voice
    captures, with and without frame stealing, against the JAX
    ``Pipeline`` with host synthesis (``device_voice=False``, so no JAX
    speech compile): the same audio, has_voice flags and counts, also
    across a checkpoint split.

The JAX decoder's own state restoring into a port pool is held in
tests/test_torch_speech.py, where its one compile is.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tetraear_tpu.api import Pipeline as JaxPipeline  # noqa: E402
from tetraear_tpu.api import PipelineConfig as JaxConfig  # noqa: E402
from tetraear_tpu.ref import golden as jax_golden  # noqa: E402
from tetraear_tpu.voice import jspeech  # noqa: E402
from tetraear_tpu_torch import golden, native  # noqa: E402
from tetraear_tpu_torch.api import Pipeline, PipelineConfig  # noqa: E402
from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool  # noqa

FS = 2.4e6


def _stream(rng, n: int) -> np.ndarray:
    s = rng.integers(0, 2, (n, 138)).astype(np.int16)
    s[:, 0] = 0
    return s


def _c_fresh(frames: np.ndarray) -> np.ndarray:
    """The C++ decoder from a fresh state: float32 PCM / 32768."""
    lib = native.codec()._LIB
    dec = lib.tetra_speech_decoder_new()
    try:
        fr = np.ascontiguousarray(frames.astype(np.int16))
        out = np.zeros((len(fr), 240), np.int16)
        ptr = ctypes.POINTER(ctypes.c_int16)
        assert lib.tetra_speech_decode_many(
            dec, fr.ctypes.data_as(ptr), len(fr),
            out.ctypes.data_as(ptr)) == 0
        return out.reshape(-1).astype(np.float32) / 32768.0
    finally:
        lib.tetra_speech_decoder_free(dec)


def test_slot_mapping_and_lru_order():
    rng = np.random.default_rng(41)
    pool = DeviceSpeechPool(slots=2, device="cpu")
    one = _stream(rng, 1)
    pool.synthesize([(7, one), (9, one)])
    assert dict(pool._map) == {7: 0, 9: 1} and pool._free == []
    pool.synthesize([(7, one)])                 # 7 is now the newest
    assert list(pool._map) == [9, 7]
    pool.synthesize([(11, one)])                # evicts 9, the oldest
    assert dict(pool._map) == {7: 0, 11: 1}
    assert list(pool._map) == [7, 11]


def test_pool_eviction_resyncs_from_fresh_state():
    """With more carriers than slots the LRU victim restarts from the
    fresh-decoder state, exactly a decoder restart."""
    rng = np.random.default_rng(31)
    pool = DeviceSpeechPool(slots=1, device="cpu")
    streams = {7: _stream(rng, 2), 9: _stream(rng, 2)}
    for ci in (7, 9, 7, 9):
        got = pool.synthesize([(ci, streams[ci])])[0]
        np.testing.assert_array_equal(got, _c_fresh(streams[ci]))


def test_pool_carries_state_and_chunks_by_slots():
    """A carrier that keeps its slot goes on from its state (two calls
    equal one C++ stream); more items than slots run in chunks."""
    rng = np.random.default_rng(32)
    pool = DeviceSpeechPool(slots=2, device="cpu")
    a, b, c = _stream(rng, 4), _stream(rng, 2), _stream(rng, 2)
    first = pool.synthesize([(1, a[:2]), (2, b)])
    second = pool.synthesize([(1, a[2:])])
    np.testing.assert_array_equal(np.concatenate([first[0], second[0]]),
                                  _c_fresh(a))
    out = pool.synthesize([(3, b), (4, c), (5, b)])   # three items, 2 slots
    np.testing.assert_array_equal(out[1], _c_fresh(c))
    np.testing.assert_array_equal(out[2], _c_fresh(b))


def test_checkpoint_leaves_have_the_jax_layout():
    import jax
    slots = 5
    pool = DeviceSpeechPool(slots=slots, device="cpu")
    leaves, meta = pool.checkpoint_state()
    want = jax.tree_util.tree_flatten(jspeech.init_state(slots))[0]
    assert len(leaves) == len(want)
    for got, exp in zip(leaves, want):
        assert got.shape == exp.shape and got.dtype == exp.dtype
        np.testing.assert_array_equal(got, np.asarray(exp))
    assert meta == {"map": [], "free": list(range(slots - 1, -1, -1)),
                    "slots": slots}


def test_checkpoint_restore_goes_on_where_it_stopped():
    rng = np.random.default_rng(33)
    a = _stream(rng, 4)
    pool = DeviceSpeechPool(slots=3, device="cpu")
    head = pool.synthesize([(4, a[:2])])[0]
    leaves, meta = pool.checkpoint_state()
    fresh = DeviceSpeechPool(slots=3, device="cpu")
    fresh.restore_state(leaves, meta)
    assert dict(fresh._map) == dict(pool._map)
    tail = fresh.synthesize([(4, a[2:])])[0]
    np.testing.assert_array_equal(np.concatenate([head, tail]), _c_fresh(a))
    with pytest.raises(ValueError, match="voice slots"):
        DeviceSpeechPool(slots=4, device="cpu").restore_state(leaves, meta)
    with pytest.raises(ValueError, match="leaf count"):
        fresh.restore_state(leaves[:-1], meta)


# ---- the Pipeline ---------------------------------------------------------

@pytest.fixture(scope="module")
def captures():
    gv = jax_golden.golden_voice_iq
    return {
        "one": gv(golden.speech(6), fs=FS, snr_db=25, seed=5),
        "stolen": gv(golden.speech(6), fs=FS, snr_db=25, seed=5,
                     stolen_every=4),
    }


COMMON = dict(sample_rate=FS, detect_gate=False, voice=True,
              validate=False, block_len=32_000)


def _pipe(pkg: str, audio: list, frames: list):
    """The JAX Pipeline with host synthesis, or the port's with device
    synthesis on the CPU (4 decoder slots)."""
    if pkg == "jax":
        return JaxPipeline(JaxConfig(device_voice=False, **COMMON),
                           on_frame=frames.append, on_audio=audio.append)
    return Pipeline(PipelineConfig(device="cpu", device_voice=True,
                                   device_voice_slots=4, **COMMON),
                    on_frame=frames.append, on_audio=audio.append)


def _feed(pipe, iq, blocks) -> None:
    bl = pipe.block_len
    for i in blocks:
        pipe.process_block(iq[i * bl:(i + 1) * bl])


def _run(pkg: str, iq) -> tuple:
    """(audio, frames, (voice_frames, stolen_frames)) of one package over
    a whole capture, block by block through process_block."""
    audio, frames = [], []
    pipe = _pipe(pkg, audio, frames)
    _feed(pipe, iq, range(len(iq) // pipe.block_len))
    counts = (pipe.stats.voice_frames, pipe.stats.stolen_frames)
    assert (pipe._voice_device is not None) == (pkg == "port")
    pipe.close()
    return audio, frames, counts


def _same(got: tuple, want: tuple) -> None:
    assert len(got[0]) == len(want[0])
    for x, y in zip(got[0], want[0]):
        np.testing.assert_array_equal(x, y)
    assert [f.get("has_voice") for f in got[1]] == \
        [f.get("has_voice") for f in want[1]]
    assert got[2] == want[2]


@pytest.mark.parametrize("name", ["one", "stolen"])
def test_device_voice_pipeline_equals_jax_host_synthesis(captures, name):
    want = _run("jax", captures[name])
    got = _run("port", captures[name])
    assert want[2][0] >= 5
    if name == "stolen":
        assert want[2][1] >= 1
    _same(got, want)


@pytest.mark.parametrize("split", [2, 4])
def test_device_voice_checkpoint_split(captures, tmp_path, split):
    """process_block with device synthesis, stopped after ``split``
    blocks, saved, restored onto a fresh Pipeline and run to the end:
    the JAX package's host-synthesis audio, flags and counts."""
    iq = captures["stolen"]
    want = _run("jax", iq)
    audio, frames = [], []
    pipe = _pipe("port", audio, frames)
    n = len(iq) // pipe.block_len
    _feed(pipe, iq, range(split))
    path = tmp_path / "vdev.npz"
    pipe.save_checkpoint(path)
    head = (pipe.stats.voice_frames, pipe.stats.stolen_frames)
    pipe.close()
    saved = np.load(path)
    assert all(f"aux_vdev_{i}" in saved for i in range(8))
    assert head[0] >= 1, "no voice before the split"
    pipe = _pipe("port", audio, frames)
    pipe.load_checkpoint(path)
    assert dict(pipe._voice_device._map)
    _feed(pipe, iq, range(split, n))
    tail = (pipe.stats.voice_frames, pipe.stats.stolen_frames)
    pipe.close()
    _same((audio, frames, (head[0] + tail[0], head[1] + tail[1])), want)
