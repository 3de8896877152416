"""The port's band extraction plan and kernel schedule vs JAX, on the CPU.

``cuda_kernels.ExtractPlan`` checks the carriers' starts once on the host
and makes the table that csrc/band_extract.cu reads: for the rows form,
source chunks loaded once into a ring of shared-memory stages and the
bulk stores each chunk feeds; for the pairs form, the starts of a thread
copy a band.  The kernels run only on the card (chip_smoke.py holds them
against the plain versions there); here ``replay`` runs the table in
numpy as the kernels step through it (loads, stores, the 16-byte rule of
each bulk copy and vector access), and its output must equal
``band_extract_plain`` / ``band_extract_rows_plain`` and the JAX Pallas
kernels in interpret mode bit for bit.  Then the channelizer's
row-extraction and element branches, built with their plans, against
the JAX channelizer at a small size.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_extract.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as hst  # noqa: E402

from tetraear_tpu.dsp import channelizer as jax_chan  # noqa: E402
from tetraear_tpu.dsp import pallas_kernels as pk  # noqa: E402
from tetraear_tpu_torch.dsp import channelizer as port_chan  # noqa: E402
from tetraear_tpu_torch.dsp import cuda_kernels as ck  # noqa: E402


def source(form: str, n_rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (2, n_rows, 128) if form == "rows" else (n_rows, 2)
    return rng.standard_normal(shape).astype(np.float32)


def plain(form: str, src: np.ndarray, starts: np.ndarray,
          span: int) -> np.ndarray:
    fn = ck.band_extract_rows_plain if form == "rows" else \
        ck.band_extract_plain
    return fn(torch.from_numpy(src), torch.from_numpy(starts), span).numpy()


def pallas(form: str, src: np.ndarray, starts: np.ndarray,
           span: int) -> np.ndarray:
    fn = pk.band_extract_rows if form == "rows" else pk.band_extract
    return np.asarray(fn(jnp.asarray(src), jnp.asarray(starts), span,
                         interpret=True))


def replay(plan, src: np.ndarray) -> np.ndarray:
    """csrc/band_extract.cu's steps in numpy on the plan's table.  Rows:
    each CTA's chunks in turn through a ring of EXTRACT_STAGES stages
    (filled with 0xFF before each load, so that a store reading past its
    chunk's bytes shows), loads and bulk stores held to the 16-byte rule
    and the stage size.  Pairs: each band as extract_pairs_kernel copies
    it (16-byte stores from 16-byte loads, or from two 8-byte loads where
    the start is odd; 8-byte copies for an odd n_band).  Every source byte
    a stage holds is loaded once, every output byte written once.
    Returns the output, ``plan.out_shape`` float32."""
    raw = np.ascontiguousarray(src, np.float32).view(np.uint8).reshape(-1)
    out = np.full(plan.out_bytes, 0xEE, np.uint8)
    hits = np.zeros(plan.out_bytes, np.int32)
    loaded = np.zeros(len(raw), np.int32)
    tab = plan.table

    def put(dst, data, align):
        assert dst % align == 0 and len(data) % align == 0, (dst, align)
        out[dst:dst + len(data)] = data
        hits[dst:dst + len(data)] += 1

    if plan.form == "pairs":
        length = plan.span * 8
        for c, s in enumerate(tab):
            dst, at = c * length, 8 * int(s)
            if plan.span % 2:
                for i in range(0, length, 8):
                    put(dst + i, raw[at + i:at + i + 8], 8)
                continue
            for i in range(0, length, 16):
                if s % 2 == 0:
                    assert (at + i) % 16 == 0
                    put(dst + i, raw[at + i:at + i + 16], 16)
                else:
                    put(dst + i, np.concatenate(
                        [raw[at + i:at + i + 8], raw[at + i + 8:at + i + 16]]),
                        16)
    else:
        g, nch = plan.n_ctas, plan.n_chunks
        chunks = tab[g + 1:g + 1 + 2 * (nch + 1)].reshape(-1, 2)
        stores = tab[g + 1 + 2 * (nch + 1):].reshape(-1, 2)
        ring = np.empty((ck.EXTRACT_STAGES, ck.EXTRACT_STAGE_BYTES), np.uint8)
        for cta in range(g):
            for i, k in enumerate(range(tab[cta], tab[cta + 1])):
                stage = ring[i % ck.EXTRACT_STAGES]
                lo, nb = chunks[k, 0], chunks[k, 1] & 0xFFFFFFFF
                assert (lo % 16 == 0 and nb % 16 == 0
                        and 0 < nb <= ck.EXTRACT_STAGE_BYTES
                        and lo + nb <= len(raw)), (lo, nb)
                stage[:] = 0xFF
                stage[:nb] = raw[lo:lo + nb]
                loaded[lo:lo + nb] += 1
                for t in range(chunks[k, 1] >> 32, chunks[k + 1, 1] >> 32):
                    dst, sm = stores[t, 0], stores[t, 1] & 0xFFFFFFFF
                    nbytes = stores[t, 1] >> 32
                    assert sm % 16 == 0 and nbytes > 0, (sm, nbytes)
                    put(dst, stage[sm:sm + nbytes], 16)
    assert (hits == 1).all(), (hits.min(), hits.max())
    assert loaded.max(initial=0) <= 1
    return out.view(np.float32).reshape(plan.out_shape)


# -- the host plan's checks ---------------------------------------------------

BAD = {
    "negative": ("rows", np.array([0, -1], np.int32), 8, 40),
    "past_the_end": ("rows", np.array([0, 33], np.int32), 8, 40),
    "pairs_past_the_end": ("pairs", np.array([193], np.int32), 64, 256),
    "int64": ("pairs", np.array([0], np.int64), 64, 256),
    "int64_tensor": ("rows", torch.tensor([0]), 8, 40),
    "float": ("pairs", np.array([0.0], np.float32), 64, 256),
    "two_dims": ("rows", np.zeros((2, 2), np.int32), 8, 40),
    "span_zero": ("pairs", np.array([0], np.int32), 0, 256),
    "form": ("lanes", np.array([0], np.int32), 8, 40),
}


@pytest.mark.parametrize("name", list(BAD))
def test_plan_rejects_bad_starts(name):
    form, starts, span, n_rows = BAD[name]
    with pytest.raises(ValueError):
        ck.ExtractPlan(form, starts, span, n_rows)


def test_wrappers_reject_a_plan_of_another_shape():
    plan = ck.ExtractPlan("rows", np.array([0, 3], np.int32), 8, 40)
    planes = torch.zeros((2, 41, 128))
    with pytest.raises(ValueError):
        ck.band_extract_rows(planes, plan, 8)           # 41 rows, not 40
    with pytest.raises(ValueError):
        ck.band_extract_rows(torch.zeros((2, 40, 128)), plan, 4)
    with pytest.raises(ValueError):
        ck.band_extract(torch.zeros((40, 2)), plan, 8)  # a rows plan


def test_wrappers_take_plans_and_host_starts_alike():
    """A plan, a numpy array and a CPU tensor of the same starts give the
    plain version's slices; on the CPU nothing launches."""
    planes = torch.from_numpy(source("rows", 40, 1))
    x = torch.from_numpy(source("pairs", 1088, 2))
    rs = np.array([32, 0, 17], np.int32)
    st = np.array([1, 1024, 511], np.int32)
    ck.reset_launches()
    rows = [ck.band_extract_rows(planes, s, 8) for s in
            (ck.ExtractPlan("rows", rs, 8, 40), rs, torch.from_numpy(rs))]
    pairs = [ck.band_extract(x, s, 64) for s in
             (ck.ExtractPlan("pairs", st, 64, 1088), st,
              torch.from_numpy(st))]
    for got in rows:
        np.testing.assert_array_equal(got.numpy(),
                                      plain("rows", planes.numpy(), rs, 8))
    for got in pairs:
        np.testing.assert_array_equal(got.numpy(),
                                      plain("pairs", x.numpy(), st, 64))
    assert not any(ck.launches.values())


def test_card_route_takes_only_plans():
    """On the card a wrapper takes a plan made once: host starts there
    would be checked and uploaded at every call."""
    rs = np.array([0, 3], np.int32)
    plan = ck.ExtractPlan("rows", rs, 8, 40)
    assert ck._plan_for(plan, "rows", 8, 40, cpu=False) is plan
    for starts in (rs, torch.from_numpy(rs)):
        with pytest.raises(ValueError):
            ck._plan_for(starts, "rows", 8, 40, cpu=False)
        np.testing.assert_array_equal(
            ck._plan_for(starts, "rows", 8, 40, cpu=True), rs)


# -- the table, replayed ------------------------------------------------------

def grid_starts(fs: float, c: int, nfft: int) -> tuple:
    """(band_start, n_band) of the 25 kHz grid of c carriers at fs."""
    ch = port_chan.FFTChannelizer(
        fs, [(i - c // 2) * 25_000 + 12_500.0 for i in range(c)], nfft=nfft)
    return ch.band_start, ch.n_band


_GRID, _GRID_NB = grid_starts(2.4e6, 96, 1024)

# (form, span, source rows, starts): starts sorted, unsorted, duplicate,
# disjoint, heavily overlapping (the full 25 kHz grid at 2.4 MHz, 10.7
# bins apart with n_band 64), in the wrap rows, odd, an odd n_band, C = 1
# and C = 2
CASES = {
    "rows_sorted": ("rows", 8, 40, [0, 3, 17, 32]),
    "rows_unsorted_wrap": ("rows", 8, 40, [32, 31, 0, 30]),
    "rows_duplicate": ("rows", 8, 40, [5, 5, 32, 5]),
    "rows_disjoint": ("rows", 8, 40, [0, 16, 32]),
    "rows_overlapping": ("rows", 64, 400, list(range(0, 320, 3))),
    "rows_c1": ("rows", 8, 40, [32]),
    "rows_long": ("rows", 128, 600, [0, 100, 472, 99]),
    "pairs_even": ("pairs", 64, 1088, [0, 2, 512, 1024]),
    "pairs_odd": ("pairs", 64, 1088, [1, 3, 511, 1023]),
    "pairs_unsorted_mixed": ("pairs", 64, 1088, [1023, 2, 5, 0, 1]),
    "pairs_duplicate": ("pairs", 64, 1088, [7, 7, 6, 7]),
    "pairs_wrap": ("pairs", 64, 1088, [1024, 1023, 961]),
    "pairs_grid_overlapping": ("pairs", _GRID_NB, 1024 + _GRID_NB,
                               list(_GRID)),
    "pairs_odd_band": ("pairs", 63, 1087, [0, 1, 512, 1023]),
    "pairs_c1_odd": ("pairs", 64, 1088, [5]),
    "pairs_c2": ("pairs", 64, 1088, [0, 1]),
    "pairs_long": ("pairs", 8192, 20000, [1, 11807, 4096, 4097, 6000]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_replayed_table_equals_plain_and_pallas(name):
    form, span, n_rows, starts = CASES[name]
    starts = np.asarray(starts, np.int32)
    src = source(form, n_rows, 3)
    plan = ck.ExtractPlan(form, starts, span, n_rows)
    got = replay(plan, src)
    want = plain(form, src, starts, span)
    assert got.shape == want.shape == plan.out_shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas(form, src, starts, span))


def test_schedule_reads_the_union_once_and_spreads_it():
    """At the C=1024 fleet geometry's random starts: loads of whole
    16-byte units that cover the bands' union and no byte twice, stages
    of at most 16 KB, 264 CTAs of about equal bytes."""
    rng = np.random.default_rng(5)
    r_rows, p = (2 ** 22 + 8192) // 128, 64
    rs = rng.integers(0, r_rows - p + 1, 1024).astype(np.int32)
    plan = ck.ExtractPlan("rows", rs, p, r_rows)
    tab = plan.table
    g = plan.n_ctas
    all_chunks = tab[g + 1:g + 1 + 2 * (plan.n_chunks + 1)].reshape(-1, 2)
    chunks = all_chunks[:-1]
    nb = chunks[:, 1] & 0xFFFFFFFF
    assert g == ck.EXTRACT_CTAS
    assert nb.max() <= ck.EXTRACT_STAGE_BYTES
    assert nb.sum() == plan.source_bytes        # rows: 512-byte units
    order = np.argsort(chunks[:, 0])
    lo, hi = chunks[order, 0], (chunks[:, 0] + nb)[order]
    assert (lo[1:] >= hi[:-1]).all()
    stores = tab[g + 1 + 2 * (plan.n_chunks + 1):].reshape(-1, 2)
    assert not ((stores[:, 0] | stores[:, 1]) & 15).any()
    stored = np.add.reduceat(stores[:, 1] >> 32, all_chunks[:-1, 1] >> 32)
    per_cta = np.add.reduceat(nb + stored, tab[:g])
    assert per_cta.max() < 1.2 * per_cta.mean()
    assert plan.out_bytes == 1024 * 2 * p * 512


@settings(max_examples=60, deadline=None, database=None)
@given(data=hst.data())
def test_replay_equals_plain_on_random_starts(data):
    form = data.draw(hst.sampled_from(["rows", "pairs"]))
    span = data.draw(hst.integers(1, 40 if form == "rows" else 3000))
    n_rows = span + data.draw(hst.integers(0, 300 if form == "rows"
                                           else 6000))
    c = data.draw(hst.integers(1, 40))
    starts = np.asarray(data.draw(hst.lists(
        hst.integers(0, n_rows - span), min_size=c, max_size=c)), np.int32)
    src = source(form, n_rows, int(starts.sum()))
    plan = ck.ExtractPlan(form, starts, span, n_rows)
    np.testing.assert_array_equal(replay(plan, src),
                                  plain(form, src, starts, span))


# -- the channelizer's branches ----------------------------------------------

# aligned rows with the extraction switch; the element branch on the full
# 25 kHz grid at 2.4 MHz with nfft 1024 (n_band 64, bands overlapping)
BRANCHES = {
    "rows": (1.28e6, [40_000.0, -60_000.0, 150_000.0, 40_000.0], 2 ** 14,
             {"TETRAEAR_NO_PALLAS_SYNTH": "1",
              "TETRAEAR_PALLAS_EXTRACT": "1"},
             {"kernel_synth": False, "kernel_extract": True}),
    "element": (2.4e6, [(i - 48) * 25_000 + 12_500.0 for i in range(96)],
                2 ** 10, {}, {}),
}


@pytest.mark.parametrize("name", list(BRANCHES))
def test_channelizer_branch_with_its_plan_equals_jax(name):
    fs, offs, nfft, env, kw = BRANCHES[name]
    with pytest.MonkeyPatch.context() as mp:
        for key, val in env.items():
            mp.setenv(key, val)
        jch = jax_chan.FFTChannelizer(fs, np.asarray(offs), nfft=nfft)
    pch = port_chan.FFTChannelizer(fs, np.asarray(offs), nfft=nfft, **kw)
    plan = pch.extract_plan
    assert plan.form == ("rows" if name == "rows" else "pairs")
    assert pch.use_extract_rows == jch.use_pallas == (name == "rows")
    np.testing.assert_array_equal(
        plan.starts, pch.row_start if name == "rows" else jch.band_start)
    # the step: the port's branch (the plain version on the CPU) against
    # the JAX step, which runs its Pallas kernel in interpret mode for rows
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(jch.block_len)
         + 1j * rng.standard_normal(jch.block_len)).astype(np.complex64)
    want, _ = jch.step(jnp.asarray(x), jch.init_state())
    got, _ = pch.step(torch.from_numpy(x), pch.init_state("cpu"))
    want = np.asarray(want)
    # the band transform's float32 summation order differs (as in
    # tests/test_torch_classic.py)
    err = np.abs(got.numpy() - want).max()
    assert err <= 3e-5 * np.abs(want).max()
    # the extraction itself, on the step's wrap-extended spectrum: the
    # plan's table replayed equals the JAX Pallas kernel bit for bit
    xx = np.concatenate([np.zeros(pch.overlap, np.complex64), x])
    big = np.fft.fft(xx).astype(np.complex64)
    x_ext = np.concatenate([big, big[:pch.n_band]])
    if name == "rows":
        src = np.stack([x_ext.real, x_ext.imag]).astype(
            np.float32).reshape(2, -1, 128)
    else:
        src = np.stack([x_ext.real, x_ext.imag], axis=1).astype(np.float32)
    np.testing.assert_array_equal(
        replay(plan, src),
        pallas(plan.form, src, plan.starts, plan.span))
