"""The port's one-axis shardings on a virtual CPU mesh: the key search's
payload rows (crypto/batch.py) and the device speech pool's slots
(voice/speech_pool.py, PipelineConfig.device_voice_mesh).

  * ``tea_decrypt_batch`` / ``tea_key_search`` with ``mesh=`` at sizes
    1/2/4, B = 37 (divisible by none but 1), TEA1 and TEA2: bit-equal to
    the unsharded port, to the JAX ``crypto.batch`` functions and to
    ``TEADecryptor``.
  * ``DeviceSpeechPool(mesh=)`` at sizes 1/2/4: PCM bit-equal to the
    unsharded pool (which tests/test_torch_speech*.py hold to the JAX
    package) across a state-carrying call, an LRU eviction, and a
    checkpoint restored into a fresh sharded pool that goes on; each
    shard's state is on its own mesh entry's device and holds its block
    of slots.
  * ``PipelineConfig.device_voice_mesh`` reaches the pool.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tetraear_tpu.crypto import batch as jbatch  # noqa: E402
from tetraear_tpu_torch.crypto import batch as tbatch  # noqa: E402
from tetraear_tpu_torch.crypto.tea import TEADecryptor  # noqa: E402
from tetraear_tpu_torch.runtime.sharding import Mesh  # noqa: E402
from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool  # noqa

SIZES = (1, 2, 4)
KEY_LEN = {"TEA1": 10, "TEA2": 16}


def _mesh(n: int, axis: str = "b") -> Mesh:
    return Mesh(["cpu"] * n, (axis,))


@pytest.fixture(scope="module", params=sorted(KEY_LEN))
def crypto_case(request):
    alg = request.param
    rng = np.random.default_rng(61 if alg == "TEA1" else 62)
    payloads = rng.integers(0, 256, (37, 24), dtype=np.uint8)
    payloads[3, :8] = 0                     # a degenerate block or two
    keys = [bytes(rng.integers(0, 256, KEY_LEN[alg], dtype=np.uint8))
            for _ in range(5)]
    return alg, payloads, keys


@pytest.mark.parametrize("n", SIZES)
def test_sharded_decrypt_is_bit_equal(crypto_case, n):
    alg, payloads, keys = crypto_case
    got = tbatch.tea_decrypt_batch(payloads, keys, alg, mesh=_mesh(n))
    want = tbatch.tea_decrypt_batch(payloads, keys, alg, device="cpu")
    assert got.shape == want.shape == (5, 37, 24)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jbatch.tea_decrypt_batch(payloads, keys, alg))
    for ki, key in enumerate(keys):
        dec = TEADecryptor(key, alg)
        for bi in range(len(payloads)):
            assert got[ki, bi].tobytes() == dec.decrypt(
                payloads[bi].tobytes())


@pytest.mark.parametrize("n", SIZES)
def test_sharded_key_search_is_bit_equal(crypto_case, n):
    alg, payloads, keys = crypto_case
    got = tbatch.tea_key_search(payloads, keys, alg, mesh=_mesh(n))
    want = tbatch.tea_key_search(payloads, keys, alg, device="cpu")
    ref = jbatch.tea_key_search(payloads, keys, alg)
    assert sorted(got) == sorted(want) == sorted(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got["best_key_index"],
                                  np.argmax(got["scores"], axis=0))
    for bi in range(len(payloads)):
        key = keys[int(got["best_key_index"][bi])]
        assert got["plaintexts"][bi].tobytes() == TEADecryptor(
            key, alg).decrypt(payloads[bi].tobytes())


def test_payload_padding_and_axis():
    """_pad_rows as the JAX function's; the axis picks the mesh axis."""
    v = np.zeros((37, 3), np.uint32)
    for n in (1, 2, 4, 8):
        assert tbatch._pad_rows(v, v, _mesh(n), None) == \
            jbatch._pad_rows(v, v, _mesh(n), None) == (-37) % n
    m = Mesh([["cpu"] * 2] * 3, ("x", "b"))
    assert tbatch._pad_rows(v, v, m, "b") == 1
    assert tbatch._pad_rows(v, v, m, None) == 2
    shards = tbatch._payload_shards(np.ones((37, 8), np.uint8), m, "x")
    assert [len(r) for _, r in shards] == [13, 13, 13]
    assert sum(int(r.sum()) for _, r in shards) == 37 * 8


# -- the voice pool -----------------------------------------------------------

def _items(seed: int, carriers, n_frames: int = 2):
    rng = np.random.default_rng(seed)
    out = []
    for c in carriers:
        f = np.zeros((n_frames, 138), np.int16)
        f[:, 1:] = rng.integers(0, 2, (n_frames, 137))
        f[rng.random(n_frames) < 0.2, 0] = 1          # a bad frame or two
        out.append((c, f))
    return out


CALLS = (
    _items(42, range(6)),           # fresh slots
    _items(43, [5, 2, 0, 3]),       # state carry, other order
    _items(44, range(8, 12)),       # eviction (6 + 4 > 8 slots)
)
AFTER = _items(45, [9, 1, 4, 11])   # after the restore


@pytest.fixture(scope="module")
def pool_want():
    ref = DeviceSpeechPool(slots=8, device="cpu")
    want = [ref.synthesize(items) for items in CALLS]
    leaves, meta = ref.checkpoint_state()
    return want, leaves, meta, ref.synthesize(AFTER)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_pool_pcm_bit_equal(pool_want, n):
    want, leaves, meta, after = pool_want
    mesh = _mesh(n, "voice")
    pool = DeviceSpeechPool(slots=8, mesh=mesh)
    assert len(pool.states) == n
    for st, dev in zip(pool.states, mesh.axis_devices()):
        assert st.old_t0.shape == (8 // n,) and st.old_t0.device == dev
    for items, wants in zip(CALLS, want):
        for w, g in zip(wants, pool.synthesize(items)):
            assert w.tobytes() == g.tobytes()
    # the checkpoint format is the unsharded pool's
    got_leaves, got_meta = pool.checkpoint_state()
    assert got_meta == meta
    assert [a.tobytes() for a in got_leaves] == [a.tobytes()
                                                 for a in leaves]
    # restore into a fresh sharded pool: each shard's rows on its device
    fresh = DeviceSpeechPool(slots=8, mesh=mesh)
    fresh.restore_state(got_leaves, got_meta)
    for s, (st, dev) in enumerate(zip(fresh.states, mesh.axis_devices())):
        lo, hi = 8 // n * s, 8 // n * (s + 1)
        for leaf, full in zip(st, leaves):
            assert leaf.device == dev
            np.testing.assert_array_equal(leaf.numpy(), full[lo:hi])
    for w, g in zip(after, fresh.synthesize(AFTER)):
        assert w.tobytes() == g.tobytes()


def test_sharded_pool_slots_divisibility():
    with pytest.raises(ValueError, match="divisible"):
        DeviceSpeechPool(slots=6, mesh=_mesh(4, "voice"))
    m = Mesh([["cpu"] * 2] * 3, ("a", "voice"))
    assert len(DeviceSpeechPool(slots=6, mesh=m, axis="a").states) == 3
    with pytest.raises(ValueError, match="'voice' size 2"):
        DeviceSpeechPool(slots=5, mesh=m, axis="voice")


def test_pipeline_wires_voice_mesh():
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    mesh = _mesh(4, "voice")
    cfg = PipelineConfig(sample_rate=2.4e6, voice=True, device_voice=True,
                         device_voice_slots=8, device_voice_mesh=mesh,
                         detect_gate=False, validate=False, device="cpu")
    pipe = Pipeline(cfg)
    try:
        pool = pipe._voice_device
        assert pool is not None and pool.slots == 8
        assert len(pool.states) == 4
        assert pool.devices == mesh.axis_devices()
    finally:
        pipe.close()
