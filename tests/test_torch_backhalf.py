"""The port's fused block step and sparse hit transfer vs JAX.

``FusedRx.step`` of tetraear_tpu_torch (plain versions on the CPU) and
of the JAX package run the golden 8-carrier capture at 2.304 MHz.  The
JAX run warms the carried state up on block 0; the port starts from
that state (convert.state_from_jax) and both run blocks 1-3.  The first
block is left out of the comparison: its first symbols interpolate the
filter's warm-up from the zero initial tail, samples a few ulps above
zero whose decisions follow the FFT's rounding, and the two packages
use different float32 FFTs.

Tolerances are those of tests/unit/test_backhalf.py
(test_fused_matches_classic_chain): verdict planes, valid counts and
bit tails exact; corr 1e-6; timing state to rounding; soft bits 2e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tetraear_tpu.dsp import backhalf as jax_backhalf  # noqa: E402
from tetraear_tpu.dsp import framescan as jax_fs  # noqa: E402
from tetraear_tpu.dsp import kernels as jax_kernels  # noqa: E402
from tetraear_tpu.dsp.pipeline import CarrierBankDemod as JaxBank  # noqa: E402
from tetraear_tpu.runtime import stream as jax_stream  # noqa: E402
from tetraear_tpu_torch import convert  # noqa: E402
from tetraear_tpu_torch.dsp import framescan  # noqa: E402
from tetraear_tpu_torch.dsp.backhalf import FusedRx  # noqa: E402
from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod  # noqa: E402
from tetraear_tpu_torch.runtime import stream  # noqa: E402

from test_torch_kernels import FS, OFFSETS, golden_capture  # noqa: E402

N_BLOCKS = 4


@pytest.fixture(scope="module")
def runs():
    jbank = JaxBank(fs=FS, freqs_hz=OFFSETS, frontend="fft")
    iq = golden_capture(jbank.block_len, N_BLOCKS)
    blocks = [jax_kernels.c2p_np(iq[b * jbank.block_len:
                                    (b + 1) * jbank.block_len])
              for b in range(N_BLOCKS)]
    jf = jax_backhalf.FusedRx(jbank)
    state = jf.init_state()
    jax_out, jax_states = [], []
    for x in blocks:
        out, state = jf.step(jnp.asarray(x), state)
        out = {k: np.asarray(v) for k, v in out.items()}
        out["soft"] = np.asarray(jf.soft_symbols(
            jnp.asarray(out["soft_planes"])))
        jax_out.append(out)
        jax_states.append(jax.tree_util.tree_map(np.asarray, state))

    pf = FusedRx(CarrierBankDemod(fs=FS, freqs_hz=OFFSETS, frontend="fft"),
                 device="cpu")
    pstate = convert.state_from_jax(jax_states[0], device="cpu")
    port_out, port_states = [None], [None]
    for x in blocks[1:]:
        out, pstate = pf.step(torch.from_numpy(x), pstate)
        out = {k: v.numpy() for k, v in out.items()}
        out["soft"] = pf.soft_symbols(
            torch.from_numpy(out["soft_planes"])).numpy()
        port_out.append(out)
        port_states.append(convert.state_to_numpy(pstate))
    return {"jax": jax_out, "jax_states": jax_states, "port": port_out,
            "port_states": port_states, "jf": jf, "pf": pf}


BLOCKS = list(range(1, N_BLOCKS))


@pytest.mark.parametrize("blk", BLOCKS)
def test_step_verdicts_equal(runs, blk):
    want, got = runs["jax"][blk], runs["port"][blk]
    assert got["corr"].shape == want["corr"].shape
    assert got["crc_err"].shape == want["crc_err"].shape
    np.testing.assert_array_equal(got["crc_err"], want["crc_err"])
    np.testing.assert_allclose(got["corr"], want["corr"], atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got["n_valid"], want["n_valid"])


@pytest.mark.parametrize("blk", BLOCKS)
def test_step_carried_state(runs, blk):
    want, got = runs["jax_states"][blk], runs["port_states"][blk]
    np.testing.assert_array_equal(got["bit_tail"], want["bit_tail"])
    tw, tg = want["bank"]["timing"], got["bank"]["timing"]
    np.testing.assert_allclose(tg["next_t"], tw["next_t"], atol=1e-3)
    np.testing.assert_allclose(tg["tail"], tw["tail"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tg["acc"], tw["acc"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["bank"]["prev_sym"],
                               want["bank"]["prev_sym"], atol=1e-4,
                               rtol=1e-4)
    cw, cg = want["bank"]["channelizer"], got["bank"]["channelizer"]
    np.testing.assert_array_equal(cg["tail"], cw["tail"])
    np.testing.assert_array_equal(cg["cycles"], cw["cycles"])


@pytest.mark.parametrize("blk", BLOCKS)
def test_step_soft_bits(runs, blk):
    want, got = runs["jax"][blk], runs["port"][blk]
    k = runs["pf"].k_max
    valid = np.arange(k)[None, :] < want["n_valid"][:, None]
    assert got["soft"].shape == want["soft"].shape == (len(OFFSETS), k, 2)
    np.testing.assert_allclose(got["soft"][valid], want["soft"][valid],
                               atol=2e-4)


def test_step_finds_frames(runs):
    """Not vacuous: the compared blocks hold sync hits and CRC passes."""
    out = runs["port"][N_BLOCKS - 1]
    assert (out["corr"] >= 0.9).sum() > 0
    assert (out["crc_err"] <= 2).sum() > 0


@pytest.mark.parametrize("blk", BLOCKS)
@pytest.mark.parametrize("kh", [framescan.SPARSE_K, 2])
def test_sparse_hits_equal(runs, blk, kh):
    """Exact keys and counts, also with a budget small enough that rows
    overflow."""
    out = runs["jax"][blk]
    jk, jc = jax_fs.sparse_hits(jnp.asarray(out["corr"]),
                                jnp.asarray(out["crc_err"]), kh)
    pk, pc = framescan.sparse_hits(torch.tensor(out["corr"]),
                                   torch.tensor(out["crc_err"]), kh)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert pk.dtype == torch.int32 and pc.dtype == torch.int32
    if kh == 2:
        assert (pc.numpy() > kh).any()


def test_hits_from_keys_equal_with_overflow():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (6, 3200)).astype(np.uint8)
    bits[:, 100:100 + 22] = 1          # a sync-like run on every row
    pe_n, pc_n = framescan.plane_dims(bits.shape[1])
    corr, crc = framescan.host_scan_rows_even(bits)
    keys, counts = framescan.sparse_hits(torch.from_numpy(corr),
                                         torch.from_numpy(crc), 4)

    def rows(r):
        return bits[r]

    got = framescan.hits_from_keys(keys.numpy(), counts.numpy(), pe_n,
                                   pc_n, rows)
    want = jax_fs.hits_from_keys(keys.numpy(), counts.numpy(), pe_n,
                                 pc_n, rows)
    assert (counts.numpy() > 4).any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_host_scan_rows_even_equal():
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (5, 1500)).astype(np.uint8)
    bits[2] = 0                        # a degenerate row
    for g, w in zip(framescan.host_scan_rows_even(bits),
                    jax_fs.host_scan_rows_even(bits)):
        np.testing.assert_array_equal(g, w)
    assert framescan.plane_dims(3200) == jax_fs.plane_dims(3200)


def test_pack_syms_equal():
    rng = np.random.default_rng(7)
    h = rng.integers(0, 4, (5, 2033)).astype(np.uint8)
    nv = np.array([2033, 2032, 2031, 0, 17])
    valid = np.arange(2033)[None, :] < nv[:, None]
    got = stream.masked_pack(torch.from_numpy(h), torch.from_numpy(valid))
    want = jax_stream.masked_pack(jnp.asarray(h), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hard, val = stream.unpack_block(got.numpy(), nv, 2033)
    np.testing.assert_array_equal(hard, np.where(valid, h, 0))
    np.testing.assert_array_equal(val, valid)
