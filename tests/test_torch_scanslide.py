"""The sliding form of the frame scan (csrc/scan.cuh) on the CPU.

The CUDA kernels evaluate the first even position of a run in full and
every next one from the last: the 16-bit parity word goes through a
fixed step matrix, the four bits that leave the data view's two runs are
taken out and the four that enter are put in.  The constants of that
step are derived in ``framescan.scan_slide`` from the tap table; here
they are checked, and ``framescan.host_scan_rows_even_sliding`` (the
kernel's own order of steps in numpy integers) is held bit for bit
against the plain version of the kernel, the exact host scan and the JAX
Pallas kernel in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tetraear_tpu.dsp import framescan as jax_fs  # noqa: E402
from tetraear_tpu_torch.dsp import cuda_kernels as ck  # noqa: E402
from tetraear_tpu_torch.dsp import framescan  # noqa: E402
from tetraear_tpu_torch.ref import golden  # noqa: E402

# 22: one sync position and no CRC position; 229-233: around the first
# CRC position; odd lengths; 1426 and 5266: the small and the fleet rows
EDGE_LENGTHS = [22, 23, 229, 230, 231, 233, 1426, 5266, 5267]


def edge_rows(n: int, c: int, seed: int) -> np.ndarray:
    """(c, n) rows: all zeros, all ones, a golden frame at the first and
    at the last CRC position, random bits."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2, (c, n)).astype(np.uint8)
    rows[0], rows[1] = 0, 1
    _, pc_n = framescan.plane_dims(n)
    if pc_n > 0:
        frame = golden.build_stream(
            [golden.sds_text_payload("EDGE")] * (n // 510 + 2), seed=9)
        last = 2 * (pc_n - 1)
        rows[2, :min(n, len(frame))] = frame[:n]
        rows[3, last:] = frame[:n - last]
    return rows


def assert_equals_plain(bits: np.ndarray, run: int = framescan.SLIDE_RUN):
    corr, err = framescan.host_scan_rows_even_sliding(bits, run=run)
    corr_p, err_p = ck.frame_scan_even_plain(torch.from_numpy(bits))
    np.testing.assert_array_equal(corr, corr_p.numpy())
    np.testing.assert_array_equal(err, err_p.numpy())
    return corr, err


def test_step_constants_follow_from_the_tap_table():
    s = framescan.scan_slide()
    t = (framescan._CRC_KERNEL[:16, 0, :][:, framescan._DATA_OFFSETS]
         != 0).astype(np.int64)
    a = s["a"].astype(np.int64)
    np.testing.assert_array_equal((a @ t[:, 2:]) % 2, t[:, :-2])
    # a shift by two places plus one constant for each bit shifted out
    for x in (0x0001, 0x0002, 0x8000, 0xBEEF, 0xFFFF):
        vec = (x >> np.arange(16)) & 1
        want = int((((a @ vec) % 2) << np.arange(16)).sum())
        got = (x >> 2) ^ ((x & 1) * s["g"][0]) ^ (((x >> 1) & 1) * s["g"][1])
        assert got == want
    # the columns: leaving bits already stepped, entering bits as they are
    where = {int(o): i for i, o in enumerate(framescan._DATA_OFFSETS)}
    for off, col in zip(framescan.SLIDE_LEAVE, s["leave"]):
        vec = (a @ t[:, where[off]]) % 2
        assert col == int((vec << np.arange(16)).sum())
    for off, col in zip(framescan.SLIDE_ENTER, s["enter"]):
        assert col == int((t[:, where[off - 2]] << np.arange(16)).sum())


def test_scan_words_carry_the_step_constants():
    words = framescan.scan_words()
    assert words.shape == (149,) and words.dtype == np.uint32
    np.testing.assert_array_equal(words[139:], framescan.scan_slide_words())
    assert (words[139:] < (1 << 16)).all()


@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_sliding_scan_equals_plain_and_host_at_edge_lengths(n):
    bits = edge_rows(n, 7, seed=n)
    corr, err = assert_equals_plain(bits)
    pe_n, pc_n = framescan.plane_dims(n)
    assert corr.shape == (7, pe_n) and err.shape == (7, max(pc_n, 0))
    corr_h, err_h = framescan.host_scan_rows_even(bits) if pc_n > 0 else (
        None, None)
    if pc_n > 0:
        np.testing.assert_array_equal(err, err_h)
        np.testing.assert_array_equal(np.rint(corr * 22),
                                      np.rint(corr_h * 22))
        assert (err[:2] == 99).all()
    if n >= 510:
        assert err[2, 0] <= 2 and err[3, pc_n - 1] <= 2


@pytest.mark.parametrize("run", [1, 2, 8, 16])
def test_sliding_scan_any_run_length(run):
    bits = edge_rows(1000, 9, seed=run)
    assert_equals_plain(bits, run=run)


def test_sliding_scan_many_random_rows():
    rng = np.random.default_rng(77)
    assert_equals_plain(rng.integers(0, 2, (300, 700)).astype(np.uint8))


@pytest.mark.parametrize("off", list(framescan.SLIDE_LEAVE)
                         + list(framescan.SLIDE_ENTER))
def test_each_leaving_and_entering_bit_alone(off):
    """A step from position o to o + 2 with exactly one of the eight bits
    set (and with exactly one cleared in a row of ones elsewhere)."""
    n, o = 900, 2 * 16 * 5 + 6          # inside a run, not its first
    rows = np.zeros((4, n), np.uint8)
    rows[0, o + off] = 1
    rows[1, 300:800] = 1
    rows[1, o + off] ^= 1
    rng = np.random.default_rng(off)
    rows[2:] = rng.integers(0, 2, (2, n))
    rows[3] = rows[2]
    rows[3, o + off] ^= 1
    _, err = assert_equals_plain(rows)
    # the lone bit is seen where it lies in the data view: before the step
    # for a leaving bit, after it for an entering one
    pe = o // 2 + (1 if off in framescan.SLIDE_ENTER else 0)
    assert err[0, pe] != 99


@pytest.mark.parametrize("n", [1426, 1682])
def test_sliding_scan_equals_jax_pallas(n):
    bits = edge_rows(n, 6, seed=3 * n)
    want = jax_fs.frame_scan_packed_even(jnp.asarray(bits))
    corr, err = framescan.host_scan_rows_even_sliding(bits)
    np.testing.assert_array_equal(corr, np.asarray(want["corr"]))
    np.testing.assert_array_equal(err, np.asarray(want["crc_err"]))


def test_wrapper_on_cpu_rows_of_every_alignment():
    """Rows that start at every byte alignment (n odd): the wrapper's CPU
    route is the plain version, equal to the sliding form."""
    bits = edge_rows(1001, 17, seed=5)
    corr, err = ck.frame_scan_even(torch.from_numpy(bits))
    got = framescan.host_scan_rows_even_sliding(bits)
    np.testing.assert_array_equal(corr.numpy(), got[0])
    np.testing.assert_array_equal(err.numpy(), got[1])
