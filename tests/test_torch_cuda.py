"""Card-only tests of tetraear_tpu_torch: the CUDA kernels have no CPU
mode, so these skip on a machine without an NVIDIA GPU.

They need no JAX.  On the card, where JAX may be absent, run them
without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_kernels_match_plain_on_card(smoke):
    """Each CUDA kernel vs its plain version at the fleet geometry
    (C=1024, 36.864 MHz); phase_kernels fails on any excess error."""
    res = smoke.phase_kernels(smoke.FS_FLEET, 1024, seed=1, reps=2)
    for r in res.values():
        assert r["max_abs_err"] <= r["tol"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["band_synth_y", "band_synth_ph",
                                  "frame_scan_even", "band_extract_rows",
                                  "band_extract"])
def test_classic_chain_kernels_match_plain_on_card(smoke, name):
    """The classic chain's kernels at a small fused-eligible geometry
    (C=8, 2.304 MHz): scan planes and extracted bands bit-identical to
    the plain versions, synthesis within its tolerance."""
    res = smoke.phase_kernels(smoke.FS_SMALL, 8, seed=3, reps=2)
    assert res[name]["max_abs_err"] <= res[name]["tol"]
    assert res[name]["bound_ms"] > 0


@pytest.mark.cuda
def test_redesigned_kernels_at_the_other_geometries(smoke):
    """fft2p (and its pass-1 probe) at nfft 2^14 and 2^18 with and
    without splice and wrap rows, fused_backhalf at C=8 / 2.304 MHz with
    0, half and all symbols valid, band_synth's three forms at n_band
    128 to 16384 and frame_scan_even at its edge lengths:
    phase_kernels_extra exits on any excess error."""
    smoke.phase_kernels_extra(seed=6)


@pytest.mark.cuda
def test_band_synth_forms_at_every_band_length(smoke):
    """n_band 128 (y only), 512, 2048 and 16384 with row_start and
    d_shift at their extremes, drop 0 and 2 P: within 1e-5 of y's RMS and
    2e-5 of the band power of the plain version, the forms bit-equal."""
    import numpy as np
    smoke.check_band_synth_sizes(np.random.default_rng(41))


@pytest.mark.cuda
def test_extraction_shapes_and_grids_on_card(smoke):
    """Both extraction kernels bit-equal to their plain versions at the
    edge shapes (C = 1 and 2, odd starts and n_band, duplicates, wrap
    rows) and on the fleet-aligned, decode element and 61.44 MHz element
    grids, a call without a host synchronisation."""
    import numpy as np
    smoke.check_extract_shapes(np.random.default_rng(44))
    res = smoke.phase_extract_grids(seed=7)
    assert [len(res[k]) for k in ("band_extract_rows", "band_extract")] \
        == [1, 2]
    assert all(r["bound_by"] == "bytes" for rs in res.values() for r in rs)


@pytest.mark.cuda
def test_frame_scan_edge_lengths_on_card(smoke):
    """n = 22, 23, 229 to 233, 1426, 5266, 5267 on 37 rows (zeros, ones,
    a frame at the first and the last position, random): bit-identical."""
    import numpy as np
    smoke.check_frame_scan_edges(np.random.default_rng(43))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 133])
def test_frame_scan_row_counts_and_long_rows_on_card(smoke, c):
    """Row counts that fill no whole wave of blocks, and a row long
    enough for several segments of positions (n = 20001)."""
    import numpy as np
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    rng = np.random.default_rng(c)
    for n in (5266, 20001):
        rows = torch.from_numpy(
            rng.integers(0, 2, (c, n)).astype(np.uint8)).cuda()
        got = ck.frame_scan_even(rows)
        want = ck.frame_scan_even_plain(rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_frame_scan_rejects_misaligned_storage(smoke):
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    rows = torch.zeros(4 * 100 + 1, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        ck.frame_scan_even(rows[1:].view(4, 100))


@pytest.mark.cuda
def test_integer_rates_on_card(smoke):
    """The register-only loop equals its plain version and reads rates
    of the order the bounds assume (within a factor of two)."""
    r = smoke.phase_int_rate()
    assert 0.5 < r["logic_per_s"] / r["bound_logic_per_s"] < 2.0
    assert 0.5 < r["add_per_s"] / r["bound_logic_per_s"] < 2.0
    assert 0.5 < r["popc_per_s"] / r["bound_quarter_per_s"] < 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fft2p", "fft2p_pass1", "fused_backhalf"])
def test_redesigned_kernels_match_plain_at_c8(smoke, name):
    """The small fused geometry (C=8, 2.304 MHz, nfft 2^18)."""
    res = smoke.phase_kernels(smoke.FS_SMALL, 8, seed=3, reps=2)
    assert res[name]["max_abs_err"] <= res[name]["tol"]
    assert res[name]["bound_ms"] > 0


@pytest.mark.cuda
def test_pass1_probe_agrees_with_the_whole_kernel(smoke):
    counts = smoke.phase_pass1_probe(smoke.FS_FLEET, 1024, None)
    assert counts["fft2p_pass1"] == 1 and counts["fft2p"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bit_place", "ops_probe", "iir_recursion"])
def test_probe_kernels_match_plain_at_c8(smoke, name):
    """The three measurement instruments of csrc/probes.cu at the small
    fused geometry: placement and recursion bit for bit, the elementwise
    operations within their limits."""
    res = smoke.phase_kernels(smoke.FS_SMALL, 8, seed=3, reps=2)
    assert res[name]["max_abs_err"] <= res[name]["tol"]
    assert res[name]["bound_ms"] > 0


@pytest.mark.cuda
def test_placement_probe_rebuilds_the_fused_steps_tail(smoke):
    assert smoke.phase_place_probe(smoke.FS_FLEET, 1024, None)[
        "bit_place"] == 1


@pytest.mark.cuda
def test_elementwise_and_recursion_probes_on_card(smoke):
    assert smoke.phase_ops_probe()["ops_probe"] == 12
    assert smoke.phase_iir_probe(4096)["iir_recursion"] == 1


@pytest.mark.cuda
def test_classic_decode_on_card_equals_cpu(smoke):
    """The off-air fixture through the defaults (conv, AFC) and the fft
    frontend on the card: frames equal to the CPU run, crc_pass >= 16."""
    counts = smoke.phase_decode_rtl()
    assert counts["conv"]["frame_scan_even"] > 0
    assert counts["fft"]["band_synth_y"] > 0


@pytest.mark.cuda
def test_element_extraction_run_on_card(smoke):
    assert smoke.phase_decode_element()["band_extract"] > 0


@pytest.mark.cuda
def test_card_decode_equals_cpu_decode(smoke):
    """Pipeline.run_offline on the card gives the CPU run's frames and
    every carrier's SDS text (golden 8-carrier capture, 2.304 MHz)."""
    smoke.phase_decode_small()


@pytest.mark.cuda
def test_cuda_wrapper_rejects_cpu_mixed_inputs(smoke):
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    tail = torch.zeros(2, 8, 128, device="cuda")
    x = torch.zeros(2, 120, 128)
    with pytest.raises(ValueError):
        ck.fft2p_planes_spliced(tail, x, 128, 128, 2)


@pytest.mark.cuda
def test_tea_search_matches_plain_on_card(smoke):
    """tea_search at the deferred-decryption size (16 keys x 4096
    payloads) and the bruteforce size (65536 keys x 256 payloads), TEA1
    and TEA2: scores, plaintexts and best-key pairs bit-equal to the
    plain version, spot pairs equal to TEADecryptor (phase_tea exits on
    any difference)."""
    rates = {"logic_per_s": 1e13, "add_per_s": 1e13}
    res = smoke.phase_tea(seed=8, reps=2, int_rates=rates)
    assert set(res) == {"deferred_TEA1", "deferred_TEA2",
                        "bruteforce_TEA1", "bruteforce_TEA2"}
    assert all(r["max_abs_err"] == 0.0 for r in res.values())


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["TEA1", "TEA2", "TEA3"])
def test_tea_key_search_on_card_equals_cpu(smoke, alg):
    """The public functions on the card equal their CPU runs, and launch
    the kernel (one search and one best-key launch; one decrypt)."""
    import numpy as np
    from tetraear_tpu_torch.crypto import batch as cbatch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    rng = np.random.default_rng(7)
    payloads = rng.integers(0, 256, (33, 24), dtype=np.uint8)
    klen = 10 if alg == "TEA1" else 16
    keys = [bytes(rng.integers(0, 256, klen, dtype=np.uint8))
            for _ in range(19)]
    ck.reset_launches()
    got = cbatch.tea_key_search(payloads, keys, alg, device="cuda")
    plain = cbatch.tea_decrypt_batch(payloads, keys, alg, device="cuda")
    assert ck.launches["tea_search"] == 3
    want = cbatch.tea_key_search(payloads, keys, alg, device="cpu")
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(
        plain, cbatch.tea_decrypt_batch(payloads, keys, alg, device="cpu"))


@pytest.mark.cuda
def test_tea_wrapper_raises_on_mixed_devices(smoke):
    from tetraear_tpu_torch.crypto import batch as cbatch
    v = torch.zeros(2, 2, dtype=torch.int32, device="cuda")
    kw = torch.zeros(3, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        cbatch.tea_search(v, v, kw, False)


@pytest.mark.cuda
def test_viterbi_decode_matches_plain_and_cpp_on_card(smoke):
    """viterbi_decode at B = 8192 and 81920 (encoded blocks under noise,
    pure-noise and all-zero blocks): ordered bits and BFI bit-equal to
    the plain version, the first 256 blocks to the C++ decoder;
    phase_viterbi exits on any difference."""
    res = smoke.phase_viterbi(seed=9, reps=2)
    assert sorted(res) == list(smoke.V1_SIZES)
    assert all(r["bound_ms"] > 0 for r in res.values())


@pytest.mark.cuda
def test_tea_search_corners_on_card(smoke):
    """tea_search at K = 1, B = 1, W 1 and 9, odd B, one family pending
    and the live path's largest shape (K 13 + 12, B 1072, W 8): the fused
    decrypt and each family's search and pairs modes bit-equal to the
    plain versions (check_tea_corners exits on any difference)."""
    assert smoke.check_tea_corners(seed=12) >= len(smoke.TEA_CORNERS)


@pytest.mark.cuda
def test_tea_fused_search_at_the_path_shape_on_card(smoke):
    """A deferred search of the live path's shape (13 TEA1 + 12 TEA2 keys
    x 1072 payloads of 64 bytes) in one launch: bit-equal to the plain
    version and TEADecryptor, no synchronisation in the call
    (phase_tea_path exits otherwise); the floor's launch at K = B = W = 1."""
    import numpy as np
    rng = np.random.default_rng(17)
    pay = rng.integers(0, 256, (1072, 64), dtype=np.uint8)
    keys1 = [bytes(rng.integers(0, 256, 10, dtype=np.uint8))
             for _ in range(13)]
    keys2 = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
             for _ in range(12)]
    res = smoke.phase_tea_path([(pay, keys1, keys2)], reps=2)
    assert res[0]["items"] == 25 * 1072 * 8 and res[0]["bound_ms"] > 0
    assert smoke.tea_floor(reps=2)["launch_ms"] > 0


@pytest.mark.cuda
def test_frame_layer_makes_one_tea_launch_a_block_on_card(smoke):
    """A block with TEA1 and TEA2 keys pending goes to the card in one
    tea_search launch, with the same frames as the CPU layer."""
    import copy
    import numpy as np
    from tetraear_tpu_torch.crypto.tea import TEADecryptor
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder

    def frame(i):
        key = bytes.fromhex("0123456789ABCDEF0123")
        return {"number": i, "carrier": i % 2,
                "bits": np.zeros(510, np.uint8), "encrypted": True,
                "encryption_algorithm": "TEA1", "key_id": "0",
                "decryption_pending": True, "position": 0,
                "mac_pdu": {"data": TEADecryptor(key, "TEA1").encrypt(
                    b"\x82EMERGENCY AT DOCK 5 EMERGENCY\x00\x00")}}
    frames = [frame(i) for i in range(3)]
    out = {}
    for device in ("cuda", "cpu"):
        layer = BatchedFrameDecoder(2, auto_decrypt=True, device=device)
        ck.reset_launches()
        out[device] = layer._attach_and_decrypt(copy.deepcopy(frames), None)
        if device == "cuda":
            assert ck.launches["tea_search"] == 1
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a["decrypted"] and a.get("sds_message") == b.get(
            "sds_message") and a.get("key_used") == b.get("key_used")


@pytest.mark.cuda
def test_viterbi_corners_on_card(smoke):
    """viterbi_decode at B 1, 2, 3, 17, 171 and the CTA sizes' edges (528,
    529, 1057) bit-equal to its plain version."""
    assert smoke.check_viterbi_corners(seed=13) == len(smoke.V1_CORNERS)


@pytest.mark.cuda
def test_viterbi_path_shapes_and_floor_on_card(smoke):
    """The voice fleet's batch sizes (162, 171, 180): bit-equal, no
    synchronisation in the call, the launch alone timed; the floor's
    launches at B = 1 and 2."""
    from tetraear_tpu_torch.voice import viterbi
    calls = []
    for b in (162, 171, 180):
        t = torch.from_numpy(smoke.viterbi_inputs(b, seed=b)).to("cuda")
        calls.append((t, *viterbi.decode(t)))
    res = smoke.phase_viterbi_path(calls, reps=2)
    assert [r["blocks"] for r in res] == [162, 171, 180]
    floor = smoke.viterbi_floor(seed=9, reps=2)
    assert sorted(floor) == [1, 2]


@pytest.mark.cuda
def test_viterbi_decode_keeps_its_table_on_the_card(smoke):
    """The table goes up once a device; a call then neither copies from
    the host nor synchronises."""
    from tetraear_tpu_torch.voice import viterbi
    t = torch.from_numpy(smoke.viterbi_inputs(5, seed=5)).to("cuda")
    viterbi.decode(t)
    table = viterbi.table_on(t.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ordered, bfi = viterbi.decode(t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert viterbi.table_on(t.device) is table
    o_p, b_p = viterbi.decode_plain(t)
    assert torch.equal(ordered, o_p) and torch.equal(bfi, b_p)


# -- acelp_decode (V2): the wrapper's checks run anywhere, the kernel on
# the card ---------------------------------------------------------------

def _speech_args(s: int = 4, n: int = 2, device: str = "cpu") -> dict:
    from tetraear_tpu_torch.voice import speech
    return {"state": speech.init_state(s, device),
            "frames": torch.zeros((s, n, 138), dtype=torch.int32,
                                  device=device),
            "valid": torch.ones((s, n), dtype=torch.bool, device=device)}


@pytest.mark.parametrize("case", [
    "frames_dtype", "frames_shape", "valid_dtype", "valid_shape",
    "state_dtype", "state_shape", "rows_dtype", "rows_range",
    "rows_repeated", "rows_length", "rows_on_device", "not_contiguous"])
def test_acelp_wrapper_rejects_bad_arguments(case):
    """decode_block checks dtype, shape, contiguity and the host-held
    slot list before it routes, on the CPU as on the card."""
    from tetraear_tpu_torch.voice import speech
    a = _speech_args()
    rows = None
    st = a["state"]
    if case == "frames_dtype":
        a["frames"] = a["frames"].long()
    elif case == "frames_shape":
        a["frames"] = a["frames"][..., :137].contiguous()
    elif case == "valid_dtype":
        a["valid"] = a["valid"].to(torch.uint8)
    elif case == "valid_shape":
        a["valid"] = a["valid"][:, :1].contiguous()
    elif case == "state_dtype":
        a["state"] = st._replace(old_exc=st.old_exc.long())
    elif case == "state_shape":
        a["state"] = st._replace(mem_syn=st.mem_syn[:, :9].contiguous())
    elif case == "rows_dtype":
        rows = torch.arange(4)
    elif case == "rows_range":
        rows = torch.tensor([0, 1, 2, 4], dtype=torch.int32)
    elif case == "rows_repeated":
        rows = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    elif case == "rows_length":
        rows = torch.tensor([0, 1, 2], dtype=torch.int32)
    elif case == "rows_on_device":
        # the slot list is held on the host whatever the device
        rows = torch.arange(4, dtype=torch.int32, device="meta")
    elif case == "not_contiguous":
        a["frames"] = torch.zeros((2, 4, 138), dtype=torch.int32).transpose(
            0, 1)
    with pytest.raises((ValueError, TypeError)):
        speech.decode_block(a["state"], a["frames"], a["valid"], rows)


def test_acelp_wrapper_shapes_on_the_cpu():
    """The plain route: (A, F, 240) int32 PCM, a new state of the input's
    shapes and dtypes, and no launch counted."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.voice import speech
    a = _speech_args(s=5, n=1)
    before = ck.launches["acelp_decode"]
    rows = torch.tensor([4, 0], dtype=torch.int32)
    new, pcm = speech.decode_block(a["state"], a["frames"][:2],
                                   a["valid"][:2], rows)
    assert pcm.shape == (2, 1, 240) and pcm.dtype == torch.int32
    for x, y in zip(new, a["state"]):
        assert x.shape == y.shape and x.dtype == torch.int32
    assert ck.launches["acelp_decode"] == before


@pytest.mark.cuda
def test_acelp_raises_on_the_card_without_a_build(smoke, monkeypatch):
    """No fallback: with the kernel library failing to build, the wrapper
    on CUDA tensors and a device pool on the card raise."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.voice import speech
    from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool

    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(ck, "_lib", None)
    monkeypatch.setattr(ck, "build", broken)
    a = _speech_args(device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        speech.decode_block(a["state"], a["frames"], a["valid"])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        DeviceSpeechPool(slots=4, device="cuda")


@pytest.mark.cuda
def test_acelp_decode_matches_plain_and_cpp_on_card(smoke):
    """acelp_decode at S = 256 and 2048 x F = 4 over two calls: PCM and
    state bit-equal to the plain version, every slot to the C++ decoder;
    phase_speech exits on any difference."""
    res = smoke.phase_speech(seed=10, reps=2)
    sizes = sorted(s for s in res if isinstance(s, int))
    assert sizes == list(smoke.V2_SIZES)
    assert all(res[s]["bound_ms"] > 0 for s in sizes)


@pytest.mark.cuda
def test_key_score_matches_plain_on_card(smoke):
    """A block's worth of the deferred key search (13 TEA1 + 12 TEA2 keys
    x 1,800 payloads of 8 to 64 bytes, noise with text-like rows among
    them: 46,800 records): the key_score launch writes its plain twin's
    records bit for bit, and the decrypt launch before it (tea_search)
    its plain version's plaintexts; one launch each."""
    import numpy as np
    from tetraear_tpu_torch.crypto import batch as cbatch
    from tetraear_tpu_torch.crypto import keyscore as ks
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    rng = np.random.default_rng(31)
    b = 1800
    lengths = 8 * rng.integers(1, 9, b)
    pay = np.zeros((b, 64), np.uint8)
    alph = np.frombuffer(b"ABCDEFGHIJ klmnopqrst 0123456789.,\n", np.uint8)
    for i, n in enumerate(lengths):
        row = rng.integers(0, 256, n) if i % 3 else rng.choice(alph, n)
        if i % 7 == 0:
            row[0] = rng.choice([0x05, 0x07, 0x82, 0x03, 0x83, 0x0C])
        pay[i, :n] = row
    keys1 = [bytes(rng.integers(0, 256, 10, dtype=np.uint8))
             for _ in range(13)]
    keys2 = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
             for _ in range(12)]
    ck.reset_launches()
    rec, plains = cbatch.tea_decrypt_scored(pay, lengths, keys1, keys2,
                                            device="cuda")
    torch.cuda.synchronize()
    assert ck.launches["tea_search"] == 1 and ck.launches["key_score"] == 1
    want_rec, want_plains = cbatch.tea_decrypt_scored(pay, lengths, keys1,
                                                      keys2, device="cpu")
    assert rec.shape == (3, 26 * b)
    np.testing.assert_array_equal(rec, want_rec)
    assert torch.equal(plains.cpu(), want_plains)
    assert (rec[ks.INFO] & ks.COUNT).any() and (rec[ks.INFO]
                                                & ks.MAC_OK).any()


@pytest.mark.cuda
def test_key_search_route_equals_host_loop_on_a_busy_block(smoke,
                                                           monkeypatch):
    """One live block of the benchmark cell fleet1024.allslots.busy's
    traffic (after its warm-up blocks): the block's deferred key search
    through the card's route (tea_decrypt_scored, the selection, the
    replayed effects) gives the frames, and leaves every scoring
    decoder's parser state and stats, that the host loop (each frame
    alone, on copies of the decoders) gives; the records of the block's
    search equal the plain twin's."""
    import copy
    import sys
    import numpy as np
    from tetraear_tpu_torch.crypto import batch as cbatch
    from tetraear_tpu_torch.runtime.checkpoint import parser_state
    sys.path.insert(0, str(REPO / "benchmark"))
    from tebench import cells, harness
    cell = cells.load("fleet1024.allslots.busy", REPO / "BENCHMARK.json")
    cfg, tr = cell.config, cell.traffic
    host_iq, _ = harness.make_capture(cfg, tr, 2718281828, "cuda")
    pipe = harness.build_pipeline(cfg, "cuda")
    warm = int(cfg["warmup_blocks"])
    for i in range(warm):
        pipe.process_block(host_iq[i])
    route = cbatch.batch_decrypt_frames
    scored = cbatch.tea_decrypt_scored
    seen = {"searches": [], "frames": 0}

    def recording(payloads, lengths, keys1, keys2, device=None):
        got = scored(payloads, lengths, keys1, keys2, device=device)
        seen["searches"].append((got.records, scored(
            payloads, lengths, keys1, keys2, device="cpu").records))
        return got

    def checked(decoders, frames, device=None):
        pend = [f for f in frames if f.get("decryption_pending")]
        cars = sorted({f.get("carrier", 0) for f in pend})
        twins = {c: copy.deepcopy(decoders[c]) for c in cars}
        host = copy.deepcopy(pend)
        for f in host:
            route(twins, [f], device=device)
        route(decoders, frames, device=device)
        strip = ("bits", "soft_symbols")
        for h, p in zip(host, pend):
            assert {k: v for k, v in p.items() if k not in strip} == {
                k: v for k, v in h.items() if k not in strip}
        for c in cars:
            a, b = decoders[c].protocol_parser, twins[c].protocol_parser
            assert (parser_state(a), a.stats) == (parser_state(b), b.stats)
        seen["frames"] += len(pend)

    monkeypatch.setattr(cbatch, "batch_decrypt_frames", checked)
    monkeypatch.setattr(cbatch, "tea_decrypt_scored", recording)
    try:
        pipe.process_block(host_iq[warm])
    finally:
        pipe.close()
    assert seen["frames"] > 1000 and len(seen["searches"]) == 1
    for card, cpu in seen["searches"]:
        np.testing.assert_array_equal(card, cpu)
