"""The port's frame scan, sync module and standalone frame layer vs JAX.

Same numpy-seeded bit rows (random bits with planted training sequences
and whole CRC-valid slots of the golden transmitter) through the JAX
functions and the port's.  ``frame_scan_packed_even`` of the JAX package
runs its Pallas kernel in interpret mode on the CPU; the port's wrapper
runs its kernel's plain version there (the CUDA kernel is held against
that plain version on the card, tests/test_torch_cuda.py and
chip_smoke.py).  Every plane must be EXACTLY equal, corr included: the
port keeps the reference kernel's n_agree * float32(1/22).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tetraear_tpu.dsp import framescan as jax_fs  # noqa: E402
from tetraear_tpu.dsp import pallas_kernels as pk  # noqa: E402
from tetraear_tpu.dsp import sync as jax_sync  # noqa: E402
from tetraear_tpu.dsp.pipeline import CarrierBankDemod as JaxBank  # noqa: E402
from tetraear_tpu.frame import batch as jax_batch  # noqa: E402
from tetraear_tpu.ref import golden  # noqa: E402
from tetraear_tpu_torch.dsp import cuda_kernels as ck  # noqa: E402
from tetraear_tpu_torch.dsp import framescan  # noqa: E402
from tetraear_tpu_torch.dsp import sync  # noqa: E402
from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder  # noqa: E402


def bit_rows(c: int, n: int, seed: int) -> np.ndarray:
    """(c, n) uint8 rows: row 0 all zeros, row 1 all ones (degenerate
    CRC views), rows 2-3 CRC-valid golden slots at an even offset, the
    others slots at an odd offset with the two training sequences
    planted over them at random positions."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2, (c, n)).astype(np.uint8)
    rows[0] = 0
    if c > 1:
        rows[1] = 1
    stream = golden.build_stream(
        [golden.sds_text_payload("SCAN ME")] * (n // 510 + 2), seed=seed)
    for r in range(2, c):
        off = 2 * int(rng.integers(0, 200)) + (1 if r > 3 else 0)
        seg = stream[:n - off]
        rows[r, off:off + len(seg)] = seg
        for pat in jax_fs._PATTERNS.astype(np.uint8)[:2 * (r > 3)]:
            p = int(rng.integers(0, n - 22))
            rows[r, p:p + 22] = pat
    return rows


# rows of 1200 + 2 k_max bits: k_max 113 (2.304 MHz test bank), 241, and
# the fleet geometry's 2033
ROW_BITS = [1426, 1682, 5266]


@pytest.mark.parametrize("n", ROW_BITS)
def test_frame_scan_packed_even_equals_jax_pallas(n):
    bits = bit_rows(6, n, seed=n)
    want = jax_fs.frame_scan_packed_even(jnp.asarray(bits))
    got = framescan.frame_scan_packed_even(torch.from_numpy(bits))
    pe_n, pc_n = framescan.plane_dims(n)
    assert got["corr"].shape == (6, pe_n) and got["crc_err"].shape == (6, pc_n)
    assert got["crc_err"].dtype == torch.int32
    np.testing.assert_array_equal(got["corr"].numpy(),
                                  np.asarray(want["corr"]))
    np.testing.assert_array_equal(got["crc_err"].numpy(),
                                  np.asarray(want["crc_err"]))
    # the planted slots are found: full agreement, and a CRC inside the
    # soft gate's two bit errors (the golden slots' solved CRC tails)
    assert float(got["corr"][2:4].amax(dim=1).min()) == 1.0
    assert int(got["crc_err"][2:4].amin(dim=1).max()) <= 2
    assert (got["crc_err"][:2] == 99).all()


@pytest.mark.parametrize("name,jax_name", [
    ("frame_scan", "frame_scan"),
    ("frame_scan_packed", "frame_scan_packed"),
    ("frame_scan_packed_mm", "frame_scan_packed_mm"),
    ("frame_scan_packed_even_conv", "frame_scan_packed_even_xla")])
def test_dense_formulations_equal_jax(name, jax_name):
    bits = bit_rows(5, 1500, seed=3)
    want = getattr(jax_fs, jax_name)(jnp.asarray(bits))
    got = getattr(framescan, name)(torch.from_numpy(bits))
    for key in ("corr", "crc_err"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)


def test_kernel_scan_switch_takes_the_conv_formulation():
    bits = torch.from_numpy(bit_rows(4, 1426, seed=5))
    conv = framescan.frame_scan_packed_even(bits, kernel_scan=False)
    ref = framescan.frame_scan_packed_even_conv(bits)
    kern = framescan.frame_scan_packed_even(bits)
    assert torch.equal(conv["corr"], ref["corr"])
    assert torch.equal(conv["crc_err"], kern["crc_err"])
    # the two corr conventions differ in the last bit at most, and
    # sparse_hits' round(corr * 22) cannot tell them apart
    assert float((conv["corr"] - kern["corr"]).abs().max()) <= 1.2e-7
    assert torch.equal(torch.round(conv["corr"] * 22),
                       torch.round(kern["corr"] * 22))
    k1, c1 = framescan.sparse_hits(conv["corr"], conv["crc_err"])
    k2, c2 = framescan.sparse_hits(kern["corr"], kern["crc_err"])
    assert torch.equal(k1, k2) and torch.equal(c1, c2)


def test_plain_scan_is_reciprocal_of_22_times_the_host_count():
    """corr of the plain version (and so of the CUDA kernel, which must
    equal it bit for bit) is n_agree * float32(1/22); the numpy host
    scan divides by float32(22).  CRC verdicts are equal."""
    bits = bit_rows(5, 1682, seed=9)
    corr, err = ck.frame_scan_even(torch.from_numpy(bits))
    co, ce = framescan.host_scan_rows_even(bits)
    np.testing.assert_array_equal(err.numpy(), ce)
    n_agree = np.rint(co * 22).astype(np.float32)
    np.testing.assert_array_equal(corr.numpy(),
                                  n_agree * np.float32(1.0 / 22))
    assert not np.array_equal(corr.numpy(), co)    # the last bit differs


@pytest.mark.parametrize("kw", [{"even_only": True}, {"even_only": False},
                                {"packed": False}])
def test_frame_scan_kernel_class_equals_jax(kw):
    """The class dispatch against the JAX class, which jits its scan.
    The even-position planes are exactly equal.  In the every-position
    formulations XLA under jit turns corr's division by 22 (44) into a
    multiplication by the reciprocal, while the eager JAX functions,
    which the port equals exactly (test_dense_formulations_equal_jax),
    divide: corr then agrees to 1.2e-7 and in its agreement count."""
    bits = bit_rows(4, 1426, seed=13)
    want = jax_fs.FrameScanKernel(**kw).scan(bits)
    port = framescan.FrameScanKernel(device="cpu", **kw)
    got = port.scan(bits)
    assert port.stride == (2 if kw.get("even_only") else 1)
    np.testing.assert_array_equal(got["crc_err"], want["crc_err"])
    if kw.get("even_only"):
        np.testing.assert_array_equal(got["corr"], want["corr"])
    else:
        np.testing.assert_allclose(got["corr"], want["corr"], rtol=0,
                                   atol=1.2e-7)
        np.testing.assert_array_equal(np.rint(got["corr"] * 22),
                                      np.rint(want["corr"] * 22))


def test_unpack_hits_to_planes_equals_jax_and_flat_form():
    bits = bit_rows(8, 1426, seed=17)
    scan = framescan.frame_scan_packed_even(torch.from_numpy(bits))
    keys, counts = framescan.sparse_hits(scan["corr"], scan["crc_err"], 2)
    jk, jc = jax_fs.sparse_hits(jnp.asarray(scan["corr"].numpy()),
                                jnp.asarray(scan["crc_err"].numpy()), 2)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert int((counts > 2).sum()) > 0         # the overflow path runs
    pe_n, pc_n = framescan.plane_dims(1426)

    def rows_fn(r):
        return bits[r]

    want = jax_fs.unpack_hits_to_planes(np.asarray(jk), np.asarray(jc),
                                        pe_n, pc_n, rows_fn)
    got = framescan.unpack_hits_to_planes(keys.numpy(), counts.numpy(),
                                          pe_n, pc_n, rows_fn)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    flat_w = jax_fs.hits_from_keys(np.asarray(jk), np.asarray(jc), pe_n,
                                   pc_n, rows_fn)
    flat_g = framescan.hits_from_keys(keys.numpy(), counts.numpy(), pe_n,
                                      pc_n, rows_fn)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w)


def test_sync_module_equals_jax():
    bits = bit_rows(5, 800, seed=21)
    np.testing.assert_array_equal(
        sync.sync_correlate(torch.from_numpy(bits)).numpy(),
        np.asarray(jax_sync.sync_correlate(jnp.asarray(bits))))
    views = np.concatenate([bits[:, 40:148], bits[:, 162:270]], axis=1)
    np.testing.assert_array_equal(
        sync.crc16_batch_device(torch.from_numpy(views[:, :200])).numpy(),
        np.asarray(jax_sync.crc16_batch_device(jnp.asarray(views[:, :200]))))
    np.testing.assert_array_equal(
        sync.crc_error_counts(torch.from_numpy(views)).numpy(),
        np.asarray(jax_sync.crc_error_counts(jnp.asarray(views))))


def test_standalone_process_path_equals_jax():
    """BatchedFrameDecoder.process (its own FrameScanKernel dispatch per
    block): the same demodulated blocks through the JAX frame layer and
    the port's give the same frames."""
    fs = 2.4e6
    payloads = [golden.sds_text_payload("STANDALONE SCAN")] * 10
    iq = golden.golden_iq(payloads, fs=fs, freq_offset_hz=12_500.0,
                          snr_db=25, seed=31)
    bank = JaxBank(fs=fs, freqs_hz=[12_500.0], block_len=400 * 80)
    jb = jax_batch.BatchedFrameDecoder(1, auto_decrypt=False)
    pb = BatchedFrameDecoder(1, auto_decrypt=False, device="cpu")
    state = bank.init_state()
    want, got = [], []
    for b in range(len(iq) // bank.block_len):
        x = iq[b * bank.block_len:(b + 1) * bank.block_len]
        out, state = bank.step(x, state)
        hard, soft, valid = (np.asarray(out[k])
                             for k in ("hard", "soft", "valid"))
        want += jb.process(hard, soft, valid)
        got += pb.process(hard, soft, valid)

    def key(frames):
        return [(f["carrier"], f["stream_symbol"], f["position"],
                 f["burst_crc"], f.get("sds_message")) for f in frames]

    assert key(got) == key(want)
    assert sum(f["burst_crc"] for f in got) >= 6
    assert any(f.get("sds_message") == "[TXT] STANDALONE SCAN" for f in got)


@pytest.mark.parametrize("rows,pairs", [("aligned", False), ("wrap", False),
                                        ("even", True), ("odd", True),
                                        ("odd_band", True)])
def test_band_extract_equals_jax_pallas(rows, pairs):
    """band_extract_rows / band_extract (plain versions on the CPU)
    against the Pallas kernels in interpret mode and the gather
    reference: bit-identical, wrap rows and odd starts included."""
    rng = np.random.default_rng(41)
    if not pairs:
        r_rows, p = 40, 8
        planes = rng.standard_normal((2, r_rows, 128)).astype(np.float32)
        starts = (np.array([0, 3, 17, 32], np.int32) if rows == "aligned"
                  else np.array([32, 31, 0, 30], np.int32))
        want = np.asarray(pk.band_extract_rows(
            jnp.asarray(planes), jnp.asarray(starts), p, interpret=True))
        got = ck.band_extract_rows(torch.from_numpy(planes),
                                   torch.from_numpy(starts), p)
        assert got.shape == (4, 2, p, 128)
        np.testing.assert_array_equal(got.numpy(), want)
        return
    n_band = 63 if rows == "odd_band" else 64
    x = rng.standard_normal((1024 + n_band, 2)).astype(np.float32)
    starts = {"even": [0, 2, 512, 1024], "odd": [1, 3, 511, 1023],
              "odd_band": [0, 1, 512, 1023]}[rows]
    starts = np.array(starts, np.int32)
    want = np.asarray(pk.band_extract(jnp.asarray(x), jnp.asarray(starts),
                                      n_band, interpret=True))
    ref = np.asarray(pk.band_extract_reference(
        jnp.asarray(x), jnp.asarray(starts), n_band))
    got = ck.band_extract(torch.from_numpy(x), torch.from_numpy(starts),
                          n_band)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("call", ["rows_high", "rows_negative", "pairs_high",
                                  "rows_dtype", "pairs_shape"])
def test_band_extract_validates_starts(call):
    planes = torch.zeros((2, 16, 128))
    x = torch.zeros((256, 2))

    def i32(*v):
        return torch.tensor(v, dtype=torch.int32)

    calls = {
        "rows_high": lambda: ck.band_extract_rows(planes, i32(0, 9), 8),
        "rows_negative": lambda: ck.band_extract_rows(planes, i32(-1), 8),
        "pairs_high": lambda: ck.band_extract(x, i32(0, 193), 64),
        "rows_dtype": lambda: ck.band_extract_rows(
            planes, torch.tensor([0]), 8),
        "pairs_shape": lambda: ck.band_extract(x.reshape(2, 256), i32(0),
                                               64),
    }
    with pytest.raises(ValueError):
        calls[call]()
