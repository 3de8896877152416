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
    pending frames go to ONE key search covering both cipher families on
    the layer's device (tests/unit/test_batch_decrypt.py
    test_pipeline_uses_device_decrypt; the JAX package makes one search a
    family); a lone frame stays on the host."""
    calls = []
    orig = cbatch.tea_decrypt_families

    def counting(payloads, tea1_keys, tea2_keys, device=None):
        calls.append((np.atleast_2d(payloads).shape[0], len(tea1_keys),
                      len(tea2_keys), device))
        return orig(payloads, tea1_keys, tea2_keys, device=device)

    monkeypatch.setattr(cbatch, "tea_decrypt_families", counting)
    layer = BatchedFrameDecoder(2, auto_decrypt=True, device=CPU)
    assert all(d.defer_decrypt for d in layer.decoders)
    frames = [dict(enc_frame(b"\x82EMERGENCY AT DOCK 5 EMERGENCY",
                             "0123456789ABCDEF0123", "TEA1", i),
                   decryption_pending=True, position=0) for i in range(3)]
    out = layer._attach_and_decrypt(frames, None)
    assert len(calls) == 1
    n_pay, k1, k2, device = calls[0]
    assert n_pay == 3 and k1 > 0 and k2 > 0 and device == CPU
    assert all(f["decrypted"] for f in out)
    calls.clear()
    lone = [dict(enc_frame(b"\x82ONE FRAME ALONE", "0123456789ABCDEF0123",
                           "TEA1", 0), decryption_pending=True, position=0)]
    layer._attach_and_decrypt(lone, None)
    assert calls == [] and lone[0]["decrypted"]


@pytest.mark.parametrize("alg2", ["TEA2", "TEA3", "TEA4"])
@pytest.mark.parametrize("length", [8, 32, 64, 72])
def test_fused_families_equal_single_family_calls_and_jax(alg2, length):
    """Both families in one launch (its plain version here): TEA1's keys
    first, then the other family's, each block equal to the
    single-family call and to the JAX tea_decrypt_batch; W = L / 8 is 1,
    4, 8 or 9 (not only a power of two)."""
    payloads, keys1 = rand_case("TEA1", 3, 5, length, seed=length)
    _, keys2 = rand_case(alg2, 4, 5, length, seed=length + 1)
    got = cbatch.tea_decrypt_families(payloads, keys1, keys2, device=CPU)
    assert got.shape == (7, 5, length) and got.dtype == np.uint8
    one = [cbatch.tea_decrypt_batch(payloads, keys1, "TEA1", device=CPU),
           cbatch.tea_decrypt_batch(payloads, keys2, alg2, device=CPU)]
    np.testing.assert_array_equal(got, np.concatenate(one))
    ref = [jax_cbatch.tea_decrypt_batch(payloads, keys1, "TEA1"),
           jax_cbatch.tea_decrypt_batch(payloads, keys2, alg2)]
    np.testing.assert_array_equal(got, np.concatenate(ref))
    assert got[3, 4].tobytes() == TEADecryptor(keys2[0], alg2).decrypt(
        payloads[4].tobytes())
    # one family pending: the other has no keys
    np.testing.assert_array_equal(
        cbatch.tea_decrypt_families(payloads, [], keys2, device=CPU), ref[1])
    np.testing.assert_array_equal(
        cbatch.tea_decrypt_families(payloads, keys1, [], device=CPU), ref[0])


def test_families_upload_once_and_reject_no_keys():
    """The payload words and both families' key words are views of one
    uploaded buffer; a launch needs at least one key."""
    payloads, keys1 = rand_case("TEA1", 2, 3, 16, seed=21)
    v0, v1, kw1, kw2 = cbatch._upload(
        [*cbatch._payload_to_words(payloads),
         cbatch._keys_to_words_tea1(cbatch._key_matrix(keys1, 10)),
         cbatch._keys_to_words_tea2(cbatch._key_matrix([], 16))], CPU)
    base = v0.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base
               for t in (v1, kw1, kw2))
    assert kw1.shape == (2, 5) and kw2.shape == (0, 4)
    with pytest.raises(ValueError, match="0 TEA1 and 0 TEA2 keys"):
        cbatch.tea_decrypt_fused(v0, v1, kw1[:0], kw2)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 8, 9, 12, 13, 1022, 1066,
                               1072, 4096, 65536, 65537, 2**31 - 1])
def test_magic_division_is_exact(d):
    """csrc/tea.cu divides an item index by B and W with host-computed
    magic numbers: exact for every 32-bit numerator (edges and random)."""
    m, s = cbatch._magic(d)
    assert 0 <= m < 2**32 and 0 <= s <= 32
    rng = np.random.default_rng(d)
    q = rng.integers(0, (2**32 - 1) // d + 1, 2048, dtype=np.uint64)
    edges = np.concatenate([q * np.uint64(d) + np.uint64(e)
                            for e in (0, 1, d - 1)])
    n = np.concatenate([np.arange(0, 1024, dtype=np.uint64),
                        edges[edges < 2**32],
                        rng.integers(0, 2**32, 4096, dtype=np.uint64),
                        np.array([2**32 - 1, 2**32 - 2, 2**31],
                                 np.uint64)])
    got = (n + ((n * np.uint64(m)) >> np.uint64(32))) >> np.uint64(s)
    np.testing.assert_array_equal(got, n // np.uint64(d))


def _replay(mode: int, k1: int, k2: int, b: int, w: int) -> dict:
    """csrc/tea.cu's thread -> (family, key, payload, block, output item)
    map in numpy, from the launch's TeaGrid: every thread of the grid,
    its CTA's family branch, the magic divisions, the output index."""
    g = cbatch.tea_grid(mode, k1, k2, b, w)
    cta = np.arange(g.ctas1 + g.ctas2, dtype=np.uint64)
    t = (cta[:, None] * cbatch.TEA_CTA
         + np.arange(cbatch.TEA_CTA, dtype=np.uint64)).reshape(-1)
    cta_of = np.repeat(cta, cbatch.TEA_CTA)
    fam1 = cta_of < g.ctas1
    i = np.where(fam1, t, t - np.uint64(g.ctas1 * cbatch.TEA_CTA))
    live = i < np.where(fam1, g.n1, g.n2)

    def div(n, m, s):
        return (n + ((n * np.uint64(m)) >> np.uint64(32))) >> np.uint64(s)
    if mode == 1:
        k = div(i, g.pay_m, g.pay_s)
        pay, blk = i - k * np.uint64(b), np.zeros_like(i)
    else:
        pair = div(i, g.words_m, g.words_s)
        blk = i - pair * np.uint64(w)
        k = pair if mode == 2 else div(pair, g.pay_m, g.pay_s)
        pay = pair if mode == 2 else pair - k * np.uint64(b)
    dst = np.where(fam1, 0, g.n1) + i
    return {"grid": g, "cta": cta_of[live], "fam1": fam1[live],
            "k": k[live].astype(np.int64), "pay": pay[live].astype(np.int64),
            "blk": blk[live].astype(np.int64),
            "dst": dst[live].astype(np.int64), "thread": t[live]}


REPLAY_CASES = [(0, 13, 12, 37, 8), (0, 1, 0, 1, 1), (0, 0, 1, 1, 9),
                (0, 3, 0, 5, 9), (0, 0, 5, 33, 3), (0, 2, 2, 7, 1),
                (1, 13, 12, 37, 8), (1, 1, 0, 1, 1), (1, 0, 7, 300, 9),
                (2, 37, 0, 37, 8), (2, 0, 5, 5, 9), (2, 1, 0, 1, 1)]


@pytest.mark.parametrize("case", REPLAY_CASES)
def test_kernel_thread_map_writes_each_output_once(case):
    """Every output item (an 8-byte block, or a pair's score) is written
    by exactly one thread, each CTA's threads are of one family, the
    item's (key, payload, block) is the one its output position names,
    and a warp's live lanes store consecutive items (contiguous bytes)."""
    mode, k1, k2, b, w = case
    r = _replay(mode, k1, k2, b, w)
    per_key = w if mode == 2 else b * (1 if mode == 1 else w)
    n_out = (k1 + k2) * per_key if mode != 2 else b * w
    np.testing.assert_array_equal(np.sort(r["dst"]), np.arange(n_out))
    for c in np.unique(r["cta"]):
        assert len(set(r["fam1"][r["cta"] == c])) == 1
    k_global = np.where(r["fam1"], r["k"], k1 + r["k"])
    if mode == 0:
        want = (k_global * b + r["pay"]) * w + r["blk"]
    elif mode == 1:
        want = k_global * b + r["pay"]
    else:
        want = r["pay"] * w + r["blk"]
        assert (r["k"] == r["pay"]).all()
    np.testing.assert_array_equal(r["dst"], want)
    assert (r["k"] < np.where(r["fam1"], k1, k2)).all()
    assert (r["pay"] < b).all() and (r["blk"] < w).all()
    warp = (r["thread"] // 32).astype(np.int64)
    for wp in np.unique(warp):
        d = r["dst"][warp == wp]
        np.testing.assert_array_equal(np.diff(d), 1)


@pytest.mark.parametrize("case", [c for c in REPLAY_CASES if c[0] != 1])
def test_kernel_thread_map_rebuilds_the_plaintexts(case):
    """The replayed map fed through the plain rounds, block by block,
    rebuilds the plain version's output byte for byte."""
    mode, k1, k2, b, w = case
    r = _replay(mode, k1, k2, b, w)
    rng = np.random.default_rng(sum(case))
    payloads = rng.integers(0, 256, (b, 8 * w), dtype=np.uint8)
    kb1 = rng.integers(0, 256, (k1, 10), dtype=np.uint8)
    kb2 = rng.integers(0, 256, (k2, 16), dtype=np.uint8)
    v0, v1, kw1, kw2 = cbatch._upload(
        [*cbatch._payload_to_words(payloads),
         cbatch._keys_to_words_tea1(kb1), cbatch._keys_to_words_tea2(kb2)],
        CPU)
    out = torch.zeros(r["dst"].max() + 1, 8, dtype=torch.uint8)
    for fam, kw, tea1 in ((True, kw1, True), (False, kw2, False)):
        sel = r["fam1"] == fam
        if not sel.any():
            continue
        k = torch.from_numpy(r["k"][sel])
        pay = torch.from_numpy(r["pay"][sel])
        blk = torch.from_numpy(r["blk"][sel])
        cols = cbatch._key_cols(kw[k], (-1,))
        p0, p1 = cbatch._rounds_plain(v0[pay, blk].long() & cbatch._M32,
                                      v1[pay, blk].long() & cbatch._M32,
                                      cols, tea1)
        out[torch.from_numpy(r["dst"][sel])] = cbatch._words_to_bytes(
            p0[:, None], p1[:, None])
    if mode == 0:
        want = cbatch.tea_decrypt_fused(v0, v1, kw1, kw2)
    else:
        kw = kw1 if k1 else kw2
        want = cbatch.tea_decrypt_pairs(v0, v1, kw, bool(k1))
    assert torch.equal(out.reshape(want.shape), want)


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
