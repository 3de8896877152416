"""The port's device TEA key search vs the JAX reference, on the CPU.

``crypto/batch.py``: the plain versions of the ``tea_search`` kernel
(int64 words masked to 32 bits) behind ``tea_decrypt_batch`` and
``tea_key_search`` must be bit-equal to the JAX functions and to the
host ``TEADecryptor``, the best key the first maximum as ``jnp.argmax``
gives it; ``batch_decrypt_frames`` field for field equal to JAX's and to
the host loop; the frame layer defers decryption as the JAX package's
does.  Inputs are seeded numpy arrays.  Tolerance: none (integers).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tetraear_tpu.crypto import batch as jax_cbatch  # noqa: E402
from tetraear_tpu.frame.decoder import TetraDecoder as JaxDecoder  # noqa: E402
from tetraear_tpu_torch.crypto import batch as cbatch  # noqa: E402
from tetraear_tpu_torch.crypto.tea import TEADecryptor  # noqa: E402
from tetraear_tpu_torch.dsp import cuda_kernels as ck  # noqa: E402
from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder  # noqa: E402
from tetraear_tpu_torch.frame.decoder import TetraDecoder  # noqa: E402

CPU = "cpu"
KEY_LEN = {"TEA1": 10, "TEA2": 16, "TEA3": 16, "TEA4": 16}


def rand_case(alg, k, b, length, seed):
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (b, length), dtype=np.uint8)
    keys = [bytes(rng.integers(0, 256, KEY_LEN[alg], dtype=np.uint8))
            for _ in range(k)]
    return payloads, keys


@pytest.mark.parametrize("alg", ["TEA1", "TEA2", "TEA3", "TEA4"])
def test_tea_decrypt_batch_matches_jax_and_host(alg):
    """Every (key, payload) plaintext equals JAX's and TEADecryptor's."""
    payloads, keys = rand_case(alg, 5, 6, 24, seed=5)
    got = cbatch.tea_decrypt_batch(payloads, keys, alg, device=CPU)
    want = jax_cbatch.tea_decrypt_batch(payloads, keys, alg)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    for ki, key in enumerate(keys):
        for bi in range(len(payloads)):
            assert got[ki, bi].tobytes() == TEADecryptor(key, alg).decrypt(
                payloads[bi].tobytes())


@pytest.mark.parametrize("alg", ["TEA1", "TEA2"])
def test_tea_key_search_matches_jax(alg):
    """Scores, best key, best score and best plaintexts equal JAX's (same
    dtypes); a planted plaintext is found under its key."""
    payloads, keys = rand_case(alg, 12, 7, 32, seed=9)
    payloads[2] = np.frombuffer(TEADecryptor(keys[5], alg).encrypt(
        b"\x82PLANTED SDS TEXT FOR KEY SEARCH"), np.uint8)
    got = cbatch.tea_key_search(payloads, keys, alg, device=CPU)
    want = jax_cbatch.tea_key_search(payloads, keys, alg)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["best_key_index"][2] == 5
    assert got["plaintexts"][2].tobytes().startswith(b"\x82PLANTED")


def test_tea_key_search_ties_pick_the_first_key():
    """A payload no key decodes scores the same under many keys: both
    versions pick the lowest key index (jnp.argmax).  Repeated keys tie
    exactly; short random payloads tie by chance."""
    payloads, keys = rand_case("TEA1", 24, 40, 8, seed=13)
    keys = keys[:6] * 4                       # keys 6.. repeat 0..5
    got = cbatch.tea_key_search(payloads, keys, "TEA1", device=CPU)
    want = jax_cbatch.tea_key_search(payloads, keys, "TEA1")
    np.testing.assert_array_equal(got["best_key_index"],
                                  want["best_key_index"])
    assert (got["best_key_index"] < 6).all()
    scores = got["scores"]
    first = np.argmax(scores == scores.max(axis=0), axis=0)
    np.testing.assert_array_equal(got["best_key_index"], first)


def test_payload_length_not_a_multiple_of_8_raises():
    payloads = np.zeros((2, 12), np.uint8)
    keys = [bytes(10)]
    with pytest.raises(ValueError, match="multiple of 8"):
        cbatch.tea_decrypt_batch(payloads, keys, device=CPU)
    with pytest.raises(ValueError, match="multiple of 8"):
        cbatch.tea_key_search(payloads, keys, device=CPU)
    with pytest.raises(ValueError, match="multiple of 8"):
        jax_cbatch.tea_decrypt_batch(payloads, keys)


def test_kernel_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the three wrappers are their plain versions and
    launch nothing; the search scores equal _score_bytes of the
    plaintexts and the pairs form is the diagonal of the grid."""
    payloads, keys = rand_case("TEA2", 4, 4, 16, seed=3)
    v0, v1, kw, tea1, _ = cbatch._device_words(payloads, keys, "TEA2", CPU)
    before = dict(ck.launches)
    plain = cbatch.tea_decrypt(v0, v1, kw, tea1)
    scores = cbatch.tea_search(v0, v1, kw, tea1)
    pairs = cbatch.tea_decrypt_pairs(v0, v1, kw, tea1)
    assert ck.launches == before
    assert plain.shape == (4, 4, 16) and scores.dtype == torch.int32
    assert torch.equal(scores, cbatch._score_bytes(plain))
    assert torch.equal(pairs, plain[torch.arange(4), torch.arange(4)])


def test_kernel_wrappers_check_their_arguments():
    payloads, keys = rand_case("TEA1", 2, 3, 16, seed=4)
    v0, v1, kw, _, _ = cbatch._device_words(payloads, keys, "TEA1", CPU)
    with pytest.raises(ValueError, match="key_words"):
        cbatch.tea_search(v0, v1, kw, False)          # 5 words, not 4
    with pytest.raises(ValueError, match="dtype"):
        cbatch.tea_search(v0.to(torch.int64), v1, kw, True)
    with pytest.raises(ValueError, match="key_words"):
        cbatch.tea_decrypt_pairs(v0, v1, kw, True)    # 2 keys, 3 payloads


def enc_frame(text: bytes, key_hex: str, alg: str, n: int) -> dict:
    """tests/unit/test_batch_decrypt.py's encrypted frame."""
    key = bytes.fromhex(key_hex)
    padded = text + b"\x00" * ((-len(text)) % 8)
    cipher = TEADecryptor(key, alg).encrypt(padded)
    return {"number": n, "carrier": n % 2,
            "bits": np.zeros(510, dtype=np.uint8), "encrypted": True,
            "encryption_algorithm": alg, "key_id": "0",
            "mac_pdu": {"data": cipher}}


FIELDS = ("decrypted", "key_used", "decrypt_confidence", "decrypted_bytes",
          "best_score", "best_key", "keys_tried", "sds_message",
          "decryption_error", "bypass_clear", "encrypted")


def test_batch_decrypt_frames_matches_jax_and_host():
    """The frames of tests/unit/test_batch_decrypt.py: the port's batched
    path equals the JAX package's batched path and the host loop, field
    for field."""
    frames = [
        enc_frame(b"\x82EMERGENCY AT DOCK 5 EMERGENCY",
                  "0123456789ABCDEF0123", "TEA1", 0),
        enc_frame(b"\x82MOVE TO SECTOR 9 NOW PLEASE",
                  "0123456789ABCDEF0123456789ABCDEF", "TEA2", 1),
        enc_frame(b"\x82ALL UNITS REPORT STATUS CODE",
                  "11111111111111111111", "TEA1", 2),
        {"number": 3, "carrier": 1, "bits": np.zeros(510, np.uint8),
         "encrypted": True, "encryption_algorithm": "TEA1", "key_id": "0",
         "mac_pdu": {"data": bytes(np.random.default_rng(0).integers(
             0, 256, 24, dtype=np.uint8))}},
    ]
    host_dec = [TetraDecoder(auto_decrypt=True) for _ in range(2)]
    host = [copy.deepcopy(f) for f in frames]
    for f in host:
        d = host_dec[f["carrier"]]
        d._decrypt_frame(f)
        d._post_decrypt_sds(f)

    def batched(make_decoder, fn, **kw):
        decs = [make_decoder(auto_decrypt=True) for _ in range(2)]
        for d in decs:
            d.defer_decrypt = True
        out = [dict(copy.deepcopy(f), decryption_pending=True)
               for f in frames]
        fn(decs, out, **kw)
        return out

    port = batched(TetraDecoder, cbatch.batch_decrypt_frames, device=CPU)
    ref = batched(JaxDecoder, jax_cbatch.batch_decrypt_frames)
    for h, p, r in zip(host, port, ref):
        for k in FIELDS:
            assert p.get(k) == r.get(k) == h.get(k), (h["number"], k)
        assert "decryption_pending" not in p
    assert all(p["decrypted"] for p in port[:3])
    assert "EMERGENCY AT DOCK 5" in port[0]["sds_message"]


def test_frame_layer_defers_and_searches_once_per_block(monkeypatch):
    """The frame layer sets defer_decrypt on its decoders, and a block's
    pending frames go to ONE key search per cipher family on the layer's
    device (tests/unit/test_batch_decrypt.py
    test_pipeline_uses_device_decrypt); a lone frame stays on the host."""
    calls = []
    orig = cbatch.tea_decrypt_batch

    def counting(payloads, key_list, algorithm="TEA1", device=None):
        calls.append((np.atleast_2d(payloads).shape[0], algorithm, device))
        return orig(payloads, key_list, algorithm, device=device)

    monkeypatch.setattr(cbatch, "tea_decrypt_batch", counting)
    layer = BatchedFrameDecoder(2, auto_decrypt=True, device=CPU)
    assert all(d.defer_decrypt for d in layer.decoders)
    frames = [dict(enc_frame(b"\x82EMERGENCY AT DOCK 5 EMERGENCY",
                             "0123456789ABCDEF0123", "TEA1", i),
                   decryption_pending=True, position=0) for i in range(3)]
    out = layer._attach_and_decrypt(frames, None)
    assert [c[:2] for c in calls] == [(3, "TEA1"), (3, "TEA2")]
    assert all(c[2] == CPU for c in calls)
    assert all(f["decrypted"] for f in out)
    calls.clear()
    lone = [dict(enc_frame(b"\x82ONE FRAME ALONE", "0123456789ABCDEF0123",
                           "TEA1", 0), decryption_pending=True, position=0)]
    layer._attach_and_decrypt(lone, None)
    assert calls == [] and lone[0]["decrypted"]


def test_scoring_feeds_the_scoring_decoders_parsers():
    """Scoring a candidate plaintext parses it as a MAC PDU on the scoring
    decoder's own parser (TetraDecoder._score_decrypt), in the JAX package
    as in the port.  The in-process frame layer scores on the carriers'
    decoders, which also reassemble their frames; the sharded layer
    scores on the parent's template decoders, and the carriers' decoders
    (in the workers) are left as they were.  So the two layers' parsers,
    and what they reassemble next, differ: the same way in both packages."""
    from tetraear_tpu_torch.runtime.checkpoint import parser_state
    rng = np.random.default_rng(3)
    frames = [enc_frame(b"\x82EMERGENCY AT DOCK 5 EMERGENCY",
                        "0123456789ABCDEF0123", "TEA1", 0)]
    frames += [{"number": n, "carrier": n % 2, "bits": np.zeros(510, np.uint8),
                "encrypted": True, "encryption_algorithm": alg,
                "key_id": "0", "mac_pdu": {"data": bytes(rng.integers(
                    0, 256, 24, dtype=np.uint8))}}
               for n, alg in ((1, "TEA1"), (2, "TEA2"), (3, "TEA1"))]

    def carriers_parsers(make_decoder, fn, in_process: bool, **kw):
        carriers = [make_decoder(auto_decrypt=True) for _ in range(2)]
        template = [make_decoder(auto_decrypt=True) for _ in range(2)]
        for d in carriers + template:
            d.defer_decrypt = True
        fn(carriers if in_process else template,
           [dict(copy.deepcopy(f), decryption_pending=True) for f in frames],
           **kw)
        return [parser_state(d.protocol_parser) for d in carriers]

    for in_process in (True, False):
        port = carriers_parsers(TetraDecoder, cbatch.batch_decrypt_frames,
                                in_process, device=CPU)
        ref = carriers_parsers(JaxDecoder, jax_cbatch.batch_decrypt_frames,
                               in_process)
        assert port == ref, in_process
        if in_process:
            assert any(st is not None for st in port)
        else:
            assert port == [None, None]


def _layer_frames(layer, blocks) -> list:
    valid = np.ones(blocks[0].shape, bool)
    out = []
    try:
        for b in blocks:
            out += [(f["carrier"], f["stream_symbol"],
                     bool(f.get("burst_crc")), f.get("sds_message"),
                     f.get("decrypted"), f.get("key_used"))
                    for f in layer.process(b, None, valid)]
    finally:
        if hasattr(layer, "close"):
            layer.close()
    return out


def test_sharded_layers_reassemble_noise_otherwise_in_both_packages():
    """The in-process and the worker-sharded frame layers give different
    frames on noise, in the JAX package as in the port: scoring candidate
    plaintexts feeds the MAC parser of the decoder that scores, which
    in process is the carrier's own and in the sharded layer the
    parent's template.  Three blocks of random symbols on four carriers
    (rows 28, 60, 77 and 79 of a 1024-carrier noise block, where the two
    JAX layers differ): each port layer equals its JAX counterpart frame
    for frame, and the two layers differ in both packages."""
    from tetraear_tpu.frame.batch import BatchedFrameDecoder as JaxLayer
    from tetraear_tpu.frame.parallel import ShardedFrameLayer as JaxSharded
    from tetraear_tpu_torch.frame.parallel import ShardedFrameLayer
    rng = np.random.default_rng(1)
    rows = [28, 60, 77, 79]
    blocks = [rng.integers(0, 4, (1024, 2032)).astype(np.uint8)[rows]
              for _ in range(3)]
    jax_in = _layer_frames(JaxLayer(4, auto_decrypt=True), blocks)
    jax_sh = _layer_frames(JaxSharded(4, n_workers=2, auto_decrypt=True),
                           blocks)
    port_in = _layer_frames(BatchedFrameDecoder(4, auto_decrypt=True,
                                                device=CPU), blocks)
    port_sh = _layer_frames(ShardedFrameLayer(4, n_workers=2,
                                              auto_decrypt=True,
                                              device=CPU), blocks)
    assert port_in == jax_in
    assert port_sh == jax_sh
    assert jax_in != jax_sh
    assert {f[0] for f in set(jax_in) ^ set(jax_sh)} == {0, 1, 2, 3}
