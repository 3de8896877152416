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
    the layer's device, its plaintexts scored there (tea_decrypt_scored;
    tests/unit/test_batch_decrypt.py test_pipeline_uses_device_decrypt;
    the JAX package makes one search a family); a lone frame stays on
    the host."""
    calls = []
    orig = cbatch.tea_decrypt_scored

    def counting(payloads, lengths, tea1_keys, tea2_keys, device=None):
        calls.append((np.atleast_2d(payloads).shape[0], len(tea1_keys),
                      len(tea2_keys), device))
        return orig(payloads, lengths, tea1_keys, tea2_keys, device=device)

    monkeypatch.setattr(cbatch, "tea_decrypt_scored", counting)
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
    and what they reassemble next, differ: the same way in both packages.
    The port's batched search leaves each scoring decoder's parser state
    and stats as the host loop (each frame alone) leaves them."""
    from tetraear_tpu_torch.runtime.checkpoint import parser_state
    rng = np.random.default_rng(3)
    frames = [enc_frame(b"\x82EMERGENCY AT DOCK 5 EMERGENCY",
                        "0123456789ABCDEF0123", "TEA1", 0)]
    frames += [{"number": n, "carrier": n % 2, "bits": np.zeros(510, np.uint8),
                "encrypted": True, "encryption_algorithm": alg,
                "key_id": "0", "mac_pdu": {"data": bytes(rng.integers(
                    0, 256, 24, dtype=np.uint8))}}
               for n, alg in ((1, "TEA1"), (2, "TEA2"), (3, "TEA1"))]

    def carriers_parsers(make_decoder, fn, in_process: bool,
                         one_by_one=False, **kw):
        carriers = [make_decoder(auto_decrypt=True) for _ in range(2)]
        template = [make_decoder(auto_decrypt=True) for _ in range(2)]
        for d in carriers + template:
            d.defer_decrypt = True
        out = [dict(copy.deepcopy(f), decryption_pending=True)
               for f in frames]
        for part in [[f] for f in out] if one_by_one else [out]:
            fn(carriers if in_process else template, part, **kw)
        carriers_parsers.scoring = [
            (parser_state(d.protocol_parser), d.protocol_parser.stats)
            for d in (carriers if in_process else template)]
        return [parser_state(d.protocol_parser) for d in carriers]

    for in_process in (True, False):
        port = carriers_parsers(TetraDecoder, cbatch.batch_decrypt_frames,
                                in_process, device=CPU)
        scoring = carriers_parsers.scoring
        host = carriers_parsers(TetraDecoder, cbatch.batch_decrypt_frames,
                                in_process, one_by_one=True, device=CPU)
        assert (port, scoring) == (host, carriers_parsers.scoring)
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


# -- the plaintexts' scores on the device (crypto/keyscore.py) -------------

def _sds_term(plain: bytes) -> int:
    """The SDS term of score_plaintext alone."""
    from tetraear_tpu_torch.frame import sds
    try:
        text = sds.parse_sds_data(plain)
    except Exception:
        return 0
    if not text:
        return 0
    if text.startswith("[BIN-ENC]"):
        return -20
    return 40 if text.startswith("[BIN]") else 120


def _payload_rows(rows: list) -> tuple:
    """(B, L) zero-padded payload matrix (L a multiple of 8) and (B,)
    lengths of byte strings."""
    lengths = np.array([len(r) for r in rows], np.int64)
    width = max(8, int(lengths.max()) + (-int(lengths.max())) % 8)
    mat = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        mat[i, :len(r)] = np.frombuffer(r, np.uint8)
    return mat, lengths


def _assert_records(plains: list, rec: np.ndarray) -> int:
    """Each column of ``rec`` is score_plaintext's record of the plaintext
    of ``plains`` at its position: exactly, or where flagged, all but the
    SDS term and its data message.  Returns the flagged columns."""
    from tetraear_tpu_torch.crypto import keyscore as ks
    from tetraear_tpu_torch.frame.decoder import score_plaintext
    assert rec.shape == (3, len(plains)) and rec.dtype == np.int32
    flagged = 0
    for c, plain in enumerate(plains):
        want = ks.record_of(score_plaintext(plain))
        got = tuple(int(v) for v in rec[:, c])
        if got[1] & ks.FLAG:
            flagged += 1
            assert got[1] & ks.COUNT == 0, plain.hex()
            assert (got[0] + _sds_term(plain), got[1] & ~ks.FLAG,
                    got[2]) == (want.score, want.info & ~ks.COUNT,
                                want.network), plain.hex()
        else:
            assert got == tuple(want), plain.hex()
    return flagged


def _texty(rng, n: int) -> bytes:
    """n bytes that walk parse_sds_data's branches: text with noise, a
    leading PID or user type, UTF-8 pairs or cp1252 bytes, escapes,
    trailing zeros, one repeated byte."""
    alph = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuv"
                         b"wxyz0123456789 .,\n\r\t@", np.uint8)
    a = rng.choice(alph, n).astype(np.int64)
    mix = rng.random(n) < rng.random() * 0.5
    a[mix] = rng.integers(0, 256, int(mix.sum()))
    kind = int(rng.integers(0, 4))
    if kind == 1:
        for j in range(0, n - 1, 5):
            a[j], a[j + 1] = rng.integers(0xC2, 0xE0), rng.integers(0x80, 0xC0)
    elif kind == 2:
        a[rng.random(n) < 0.2] = rng.integers(0x80, 0xA0)
    elif kind == 3:
        a[rng.random(n) < 0.3] = 0x1B
    a[0] = rng.choice([0x05, 0x07, 0x82, 0x03, 0x83, 0x0C, 0x01, 0x00,
                       0xFF, 0x1B, int(a[0])])
    if rng.random() < 0.3 and n > 1:
        a[1] = 0
    if rng.random() < 0.3 and n > 1:
        a[-int(rng.integers(1, n)):] = 0
    if rng.random() < 0.05:
        a[:] = a[0]
    return a.astype(np.uint8).tobytes()


def _gsm_bits(*fields) -> bytes:
    """(value, width) fields MSB first, zero-padded to whole bytes."""
    bits = "".join(format(v, f"0{w}b") for v, w in fields)
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def _scorer_case(case: str) -> tuple:
    """(payload rows, TEA1 keys, TEA2 keys) of one scorer case."""
    from tetraear_tpu_torch.frame import sds
    rng = np.random.default_rng(sum(map(ord, case)))
    common = TetraDecoder().common_keys
    none = ([], [])
    if case == "common_keys":
        rows = [bytes(rng.integers(0, 256, 8 * int(rng.integers(1, 6)),
                                   dtype=np.uint8)) for _ in range(48)]
        return rows, common["TEA1"], common["TEA2"]
    if case == "secret_texts":
        rows = []
        for j, (alg, key) in enumerate(
                [("TEA1", k) for k in common["TEA1"][:3]]
                + [("TEA2", k) for k in common["TEA2"][:3]]):
            msg = b"\x82" + f"SECRET {1000 + 37 * j:04d}".encode()
            msg += b"\x00" * (-len(msg) % 8)
            rows.append(TEADecryptor(key, alg).encrypt(msg))
            rows.append(msg)
        return rows, common["TEA1"][:3], common["TEA2"][:3]
    if case == "uniform":
        return [bytes([v]) * n for v in (0, 0xFF) for n in (8, 16, 40, 64)], \
            *none
    if case == "sds_branches":
        gsm = sds.pack_gsm7("Meet at the north gate 0900 hrs")
        rows = [b"\x05\x00\x0bHELLO WORLD\x00\x00\x00\x00\x00",
                b"\x05\x00\x04\x80\x81\x82\x83\x84",            # not ASCII
                b"\x05\x00\x01\x00\x00\x00\x00\x00",            # empty text
                b"\x07\x00\x10" + gsm[:13],
                b"\x82SECRET 1234\x00\x00\x00\x00",
                b"\x82\x01\x02\x03\x04\x05\x06\x07",            # not text
                b"\x03SECRET 1234\x00\x00\x00\x00",
                b"\x03SECRET \xe9\xe9\xe9\x00\x00\x00\x00",      # not ASCII
                b"\x83" + bytes(rng.integers(0, 256, 15, dtype=np.uint8)),
                b"\x0c" + bytes(rng.integers(0, 256, 7, dtype=np.uint8)),
                b"Plain text here\x00",                          # ASCII
                b"Caf\xe9 au lait ok\x00",                        # latin-1
                b"Na\x93ve \x94text\x94 ok",                      # cp1252
                b"Na\x81ve \x94text\x94 ok",                      # no cp1252
                b"Gr\xc3\xbc\xc3\x9fe aus Berlin!",               # UTF-8
                b"AAAAAAAAAAAAAAAA",                              # one byte
                b"\t\n \r\t\n \r",                                # blanks
                gsm + b"\x00" * (-len(gsm) % 8),                  # GSM7
                bytes(range(0x90, 0xA0)),                         # BIN-ENC
                b"\x11\x22\x11\x22\x11\x22\x11\x22\x11\x22\x11\x22"
                b"\x00\x00\x00\x00"]                              # BIN
        return rows, *none
    if case == "mac_types":
        rows = []
        for t in range(4):
            for e in range(4):
                rows.append(bytes([(t << 6) | (e << 4) | 0x5])
                            + bytes(rng.integers(0, 256, 15,
                                                 dtype=np.uint8)))
        rows += [_gsm_bits((2, 2), (0, 2), (262, 10), (1, 14), (7, 6),
                           (0xABCD, 16)),                 # SYSINFO
                 _gsm_bits((2, 2), (0, 2), (199, 10), (1, 14), (7, 6)),
                 _gsm_bits((2, 2), (0, 2), (262, 10), (1000, 14), (7, 6)),
                 _gsm_bits((0, 2), (0, 3), (0xABCDE, 24), (63, 6),
                           (0, 29)),                      # too long
                 _gsm_bits((3, 2), (0, 3), (63, 6), (0, 53))]
        return [r + b"\x00" * (-len(r) % 8) for r in rows], *none
    if case == "short":
        return [bytes(rng.integers(0, 256, n, dtype=np.uint8))
                for n in range(1, 17)], *none
    assert case == "texts"
    rows = [_texty(rng, 8 * int(rng.integers(1, 9))) for _ in range(400)]
    return rows, common["TEA1"][:2], common["TEA2"][:2]


@pytest.mark.parametrize("case", ["common_keys", "secret_texts", "uniform",
                                  "sds_branches", "mac_types", "short",
                                  "texts"])
def test_key_score_plain_equals_score_plaintext(case):
    """keyscore.key_score's plain twin, through tea_decrypt_scored on the
    CPU: every (key, payload) plaintext's record and every payload's own
    (the BYPASS entry) equal score_plaintext's, the score, the data
    message, the MAC fields and the network identity, the SDS term and
    its message left to the host only where flagged.  The cases: random
    payloads of 8-40 bytes under every common key of the plan; sent
    "SECRET nnnn" texts under TEA1 and TEA2; all-0x00 and all-0xFF; each
    leading branch of parse_sds_data; the four MAC types with and
    without SYSINFO; rows too short for the MAC fields; text-like
    payloads."""
    from tetraear_tpu_torch.crypto import keyscore as ks
    rows, keys1, keys2 = _scorer_case(case)
    mat, lengths = _payload_rows(rows)
    rec, plains = cbatch.tea_decrypt_scored(mat, lengths, keys1, keys2,
                                            device=CPU)
    want = [TEADecryptor(key, alg).decrypt(mat[b].tobytes())[:lengths[b]]
            for key, alg in [(k, "TEA1") for k in keys1]
            + [(k, "TEA2") for k in keys2] for b in range(len(rows))]
    assert plains.shape == (len(keys1) + len(keys2), *mat.shape)
    flagged = _assert_records(want + rows, rec)
    info = rec[ks.INFO, -len(rows):]
    if case == "sds_branches":
        # the GSM-7 user type and the UTF-8 text are the host's alone
        assert flagged == 2 and info[3] & ks.FLAG and info[14] & ks.FLAG
        assert info[[0, 4, 6, 10, 11, 12, 17]].tolist() == [
            ks.COUNT | (i & ~ks.COUNT) for i in info[[0, 4, 6, 10, 11, 12,
                                                      17]].tolist()]
    if case == "mac_types":
        assert info[16] & ks.SYSINFO and rec[ks.NETWORK, -len(rows) + 16] \
            == 262 | (1 << 10) | (7 << 24)
        assert not info[17] & ks.MAC_OK and not info[18] & ks.MAC_OK
        assert not info[19] & ks.MAC_OK and not info[20] & ks.MAC_OK
    if case == "secret_texts":
        assert (rec[ks.SCORE] >= 150).sum() >= 12


def _host_kernel(tmp_path_factory):
    """dsp/csrc/keyscore.cu built with g++ against a shim of the CUDA names
    it uses (a CTA's threads as threads, __syncthreads a barrier, the
    launch a loop over CTAs): the kernel's own code on the CPU."""
    import ctypes
    import shutil
    import subprocess
    from pathlib import Path
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    src = (Path(cbatch.__file__).resolve().parents[1] / "dsp" / "csrc"
           / "keyscore.cu").read_text()
    launch = "key_score_kernel<<<grid, kCta, 0, (cudaStream_t)stream>>>(a);"
    assert src.count(launch) == 1
    src = src.replace(launch,
                      "tt_launch(grid, kCta, [&] { key_score_kernel(a); });")
    src = src.replace('#include "common.cuh"', '#include "shim.h"')
    d = tmp_path_factory.mktemp("keyscore_host")
    (d / "shim.h").write_text(_KEYSCORE_SHIM)
    (d / "keyscore.cpp").write_text(src)
    so = d / "libkeyscore.so"
    r = subprocess.run(["g++", "-O1", "-std=c++17", "-fPIC", "-shared",
                        "-pthread", "-I", str(d), "-o", str(so),
                        str(d / "keyscore.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    vp, cu = ctypes.c_void_p, ctypes.c_uint
    lib.tt_key_score.argtypes = [vp] * 5 + [cu] * 3 + [vp, vp]
    lib.tt_key_score.restype = ctypes.c_int
    return lib


_KEYSCORE_SHIM = r"""
#pragma once
#include <algorithm>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(x)
struct tt_dim3 { unsigned x; };
static thread_local tt_dim3 blockIdx, threadIdx;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
using std::max;
using std::min;
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
template <class T> inline T __ldg(const T* p) { return *p; }
struct tt_barrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0;
  long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lk(m);
    const long g = gen;
    if (++count == n) { count = 0; gen++; cv.notify_all(); }
    else cv.wait(lk, [&] { return gen != g; });
  }
};
static tt_barrier tt_block_bar;
inline void __syncthreads() { tt_block_bar.wait(); }
template <class F>
inline void tt_launch(unsigned grid, unsigned block, F body) {
  tt_block_bar.n = (int)block;
  for (unsigned b = 0; b < grid; b++) {
    std::vector<std::thread> th;
    for (unsigned t = 0; t < block; t++)
      th.emplace_back([&, b, t] { blockIdx.x = b; threadIdx.x = t; body(); });
    for (auto& x : th) x.join();
  }
}
"""


def test_key_score_kernel_source_on_the_host_equals_plain(tmp_path_factory):
    """The kernel's own code, built on the host, writes the plain twin's
    records bit for bit: text-like and random payloads (8 to 64 bytes)
    under 3 TEA1 and 2 TEA2 keys, one key's plaintexts replaced by the
    payloads' own texts."""
    from tetraear_tpu_torch.crypto import keyscore as ks
    lib = _host_kernel(tmp_path_factory)
    rng = np.random.default_rng(23)
    rows = [_texty(rng, 8 * int(rng.integers(1, 9))) if i % 2 else
            bytes(rng.integers(0, 256, 8 * int(rng.integers(1, 9)),
                               dtype=np.uint8)) for i in range(300)]
    mat, lengths = _payload_rows(rows)
    keys1 = [bytes(rng.integers(0, 256, 10, dtype=np.uint8))
             for _ in range(3)]
    keys2 = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
             for _ in range(2)]
    v0, v1, kw1, kw2, lens = cbatch._upload(
        [*cbatch._payload_to_words(mat),
         cbatch._keys_to_words_tea1(cbatch._key_matrix(keys1, 10)),
         cbatch._keys_to_words_tea2(cbatch._key_matrix(keys2, 16)),
         lengths.astype(np.uint32)], CPU)
    plains = cbatch.tea_decrypt_fused(v0, v1, kw1, kw2).clone()
    plains[0] = torch.from_numpy(mat)
    want = ks.key_score(plains, v0, v1, lens).numpy()
    assert (want[ks.INFO] & ks.FLAG).any() and (want[ks.INFO]
                                                & ks.COUNT).any()
    for k in (5, 0):
        got = np.zeros((3, (k + 1) * len(rows)), np.int32)
        table = ks.table_on(torch.device(CPU))
        assert lib.tt_key_score(
            plains.numpy().ctypes.data, v0.numpy().ctypes.data,
            v1.numpy().ctypes.data, lens.numpy().ctypes.data,
            table.numpy().ctypes.data, k, len(rows), mat.shape[1] // 8,
            got.ctypes.data, None) == 0
        ref = want if k else ks.key_score(plains[:0], v0, v1, lens).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("start", ["fresh", "encrypted_chain",
                                   "clear_chain", "restored"])
def test_replay_score_effects_equals_scoring_on_the_parser(start):
    """replay_score_effects from the twin's records (MacParser's
    buffer_keeps and replay_mac_fields) leaves a parser (its
    parser_state, network identity and stats) as applying each
    plaintext's score_plaintext effects in turn does, over 300 random
    runs of 1 to 20 plaintexts of every MAC type, fetching the bytes of
    only the plaintexts whose data the fragment buffer keeps."""
    from tetraear_tpu_torch.crypto import keyscore as ks
    from tetraear_tpu_torch.frame.burst import bytes_to_bits
    from tetraear_tpu_torch.frame.decoder import (apply_score_effects,
                                                  replay_score_effects,
                                                  score_plaintext)
    from tetraear_tpu_torch.frame.mac import MacParser, extract_mac_fields
    from tetraear_tpu_torch.runtime.checkpoint import (parser_state,
                                                       restore_parser)
    rng = np.random.default_rng(len(start))
    sysinfo = _gsm_bits((2, 2), (0, 2), (262, 10), (1, 14), (7, 6))
    pool = [bytes([(t << 6) | (int(rng.integers(0, 4)) << 4)])
            + bytes(rng.integers(0, 256, 8 * int(rng.integers(1, 5)) - 1,
                                 dtype=np.uint8))
            for t in rng.integers(0, 4, 400)]
    pool += [sysinfo + b"\x00" * (-len(sysinfo) % 8), b"\x82SECRET 1234\x00"
             b"\x00\x00\x00"] + [_texty(rng, 16) for _ in range(40)]
    mat, lengths = _payload_rows(pool)
    v0, v1, lens = cbatch._upload([*cbatch._payload_to_words(mat),
                                   lengths.astype(np.uint32)], CPU)
    rec = ks.key_score(torch.empty((0, *mat.shape), dtype=torch.uint8),
                       v0, v1, lens).numpy().copy()
    # the route's records: the host's where the kernel flagged
    for c in np.flatnonzero(rec[ks.INFO] & ks.FLAG):
        rec[:, c] = ks.record_of(score_plaintext(pool[c]))
    assert (rec[ks.INFO] & ks.COUNT).any()

    def parser():
        p = MacParser()
        if start == "encrypted_chain":
            p.apply_mac_fields(extract_mac_fields(bytes_to_bits(
                bytes([0x10]) + bytes(15))))
        elif start == "clear_chain":
            p.apply_mac_fields(extract_mac_fields(bytes_to_bits(
                bytes([0x00, 0x12, 0x34]) + bytes(13))))
        elif start == "restored":
            restore_parser(p, {"mcc": 1, "mnc": 2, "la": None,
                               "colour_code": 3, "fragment": "abcd",
                               "fragment_metadata": {}})
        return p

    for _ in range(300):
        idx = rng.integers(0, len(pool), int(rng.integers(1, 21)))
        host, dev = parser(), parser()
        for i in idx:
            apply_score_effects(host, score_plaintext(pool[i]))
        asked = []

        def fields_at(j, _idx=idx):
            asked.append(j)
            return extract_mac_fields(bytes_to_bits(pool[_idx[j]]))

        info, network = rec[ks.INFO, idx], rec[ks.NETWORK, idx]
        kept, (last,) = MacParser.buffer_keeps(ks.pdu_types(info)[None])
        replay_score_effects(dev, int(np.count_nonzero(info & ks.COUNT)),
                             ks.pdus_of(info, network), int(last),
                             fields_at)
        assert (parser_state(dev), dev.stats) == (parser_state(host),
                                                  host.stats)
        assert (dev.mcc, dev.mnc, dev.colour_code) == (
            host.mcc, host.mnc, host.colour_code)
        assert asked == np.flatnonzero(kept[0]).tolist()


def _route_frames(case: str) -> tuple:
    """(frames, decoders' set-up) of a route case: key frames on
    carriers, with noise payloads of 8 to 64 bytes among SDS texts sent
    under common keys (an early exit at 150 or more), readable clear
    payloads (BYPASS wins) and unknown keys."""
    rng = np.random.default_rng(sum(map(ord, case)))
    n_car = {"many_carriers": 16}.get(case, 4)
    common = TetraDecoder().common_keys
    frames = []
    for n in range(120 if case == "many_carriers" else 60):
        alg = ("TEA1", "TEA2", "TEA3")[n % 3]
        if case == "best_below_80":
            data = bytes(rng.integers(0, 3 if n % 4 else 1,
                                      8 * int(rng.integers(1, 3)),
                                      dtype=np.uint8))
        else:
            data = bytes(rng.integers(0, 256, 8 * int(rng.integers(1, 9)),
                                      dtype=np.uint8))
        frames.append({"number": n, "carrier": int(rng.integers(0, n_car)),
                       "bits": np.zeros(510, np.uint8), "encrypted": True,
                       "encryption_algorithm": alg, "key_id": "0",
                       "mac_pdu": {"data": data}})
    real = [enc_frame(b"\x82RELOCATE NOW TO GATE SEVEN",
                      common["TEA1"][0].hex(), "TEA1", 0),
            enc_frame(b"\x82SECRET 1234", common["TEA2"][1].hex(), "TEA2", 0),
            enc_frame(b"\x82ALL UNITS REPORT STATUS CODE",
                      "11111111111111111111", "TEA1", 0),
            {"number": 0, "carrier": 0, "bits": np.zeros(510, np.uint8),
             "encrypted": True, "encryption_algorithm": "TEA1",
             "key_id": "0",
             "mac_pdu": {"data": b"\x82READABLE CLEAR TEXT HERE\x00"}}]
    for j, at in enumerate(rng.choice(len(frames), 12, replace=False)):
        frames.insert(int(at), dict(real[j % len(real)],
                                    number=1000 + j,
                                    carrier=int(rng.integers(0, n_car))))
    return frames, n_car


@pytest.mark.parametrize("case", ["many_carriers", "early_exit",
                                  "best_below_80", "invalid_keys",
                                  "template"])
def test_batched_route_equals_host_loop_after_every_frame(case,
                                                          monkeypatch):
    """batch_decrypt_frames on the CPU (the scores from key_score's plain
    twin, the effects replayed) against the host loop (each frame
    alone: _select_decrypt and _post_decrypt_sds in turn): every frame
    field for field, and after every frame the scoring decoder's
    parser_state and stats; the same plan entries scored and frames
    decrypted.  Cases: 16 carriers; SDS texts under common keys (the
    loop stops at 150 or more); frames whose best stays under 80 (no
    common keys, low payloads); keys of the wrong length for their
    family (the loop skips them); the sharded layer's template
    decoders."""
    import copy
    from tetraear_tpu_torch.frame import decoder as decoder_mod
    from tetraear_tpu_torch.frame.parallel import _LazyDecoders
    from tetraear_tpu_torch.runtime import profiling as prof
    from tetraear_tpu_torch.runtime.checkpoint import parser_state
    frames, n_car = _route_frames(case)

    def decoders():
        if case == "template":
            lazy = _LazyDecoders(None, True, ())
            decs = [lazy[i] for i in range(n_car)]
        else:
            decs = [TetraDecoder(auto_decrypt=True) for _ in range(n_car)]
            for d in decs:
                d.defer_decrypt = True
        if case == "invalid_keys":
            decs[1].user_keys += [("TEA1", bytes(range(16))),
                                  ("TEA2", bytes(range(10))),
                                  ("TEA4", bytes(range(16)))]
            decs[2].user_keys += [("TEA2", bytes(range(10)))]
        if case == "best_below_80":
            for d in decs:
                d.common_keys = {}
        return decs

    snaps = []
    real_replay = decoder_mod.replay_score_effects

    def snapping(parser, *a):
        real_replay(parser, *a)
        snaps[-1].append((parser_state(parser), dict(parser.stats)))

    monkeypatch.setattr(decoder_mod, "replay_score_effects", snapping)

    def run(one_by_one: bool):
        decs = decoders()
        out = [dict(copy.deepcopy(f), decryption_pending=True)
               for f in frames]
        snaps.append([])
        before = dict(prof.tracer().counter_totals)
        for f in out:
            if one_by_one:
                cbatch.batch_decrypt_frames(decs, [f], device=CPU)
                p = decs[f["carrier"]].protocol_parser
                snaps[-1].append((parser_state(p), dict(p.stats)))
        if not one_by_one:
            cbatch.batch_decrypt_frames(decs, out, device=CPU)
        after = prof.tracer().counter_totals
        return out, {k: after[k] - before.get(k, 0) for k in after}

    host, host_counts = run(True)
    port, port_counts = run(False)
    assert len(snaps[0]) == len(snaps[1]) == len(frames)
    for i, (h, p) in enumerate(zip(host, port)):
        assert {k: v for k, v in p.items() if k != "bits"} == {
            k: v for k, v in h.items() if k != "bits"}, i
        assert snaps[1][i] == snaps[0][i], (i, h["carrier"])
    for k in ("keys_scored", "decrypted"):
        assert port_counts[k] == host_counts[k], k
    assert 0 <= port_counts["key_fallback"] <= port_counts["keys_scored"]
    assert any(st is not None for st, _ in snaps[1])
    if case == "early_exit":
        assert sum("RELOCATE NOW" in (f.get("sds_message") or "")
                   or "SECRET 1234" in (f.get("sds_message") or "")
                   for f in port) >= 4
        assert any(f.get("bypass_clear") for f in port)
    if case == "best_below_80":
        assert any(not f["decrypted"] and 0 < f["best_score"] < 80
                   for f in port)
        assert any(f["best_key"] is None for f in port)
