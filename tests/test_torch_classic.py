"""The port's classic receive chain vs the JAX reference, on the CPU.

Same numpy-seeded inputs through the JAX function and its counterpart
in tetraear_tpu_torch, module by module (kernels, timing, channelizer,
bank step, block step with scan) and for the slice as a whole
(``ScanRunner``, ``DecodeRunner``, ``Pipeline.run_offline`` on a golden
2.4 Msps capture and on the off-air fixture).  Where the JAX function
reaches a Pallas kernel it runs it in interpret mode, as the JAX
package's own tests do; the port's wrappers run their plain versions on
CPU tensors.

Tolerances: hard symbols, valid masks, scan planes, bit tails and frame
lists identical; floats to 1e-5 of the array's largest magnitude unless
a case says otherwise.  Block steps are compared from a WARMED state:
block 0 is run by JAX from the zero state and its state carried across
with ``convert.state_from_jax``, because the first block's warm-up
symbols interpolate samples a few ulps above zero whose decisions
follow the FFT's rounding (ROADMAP "Faults"), and with AFC on the loop
feeds that difference back into every later block.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tetraear_tpu import api as jax_api  # noqa: E402
from tetraear_tpu.dsp import backhalf as jax_backhalf  # noqa: E402
from tetraear_tpu.dsp import channelizer as jax_chan  # noqa: E402
from tetraear_tpu.dsp import design as jax_design  # noqa: E402
from tetraear_tpu.dsp import kernels as jax_kernels  # noqa: E402
from tetraear_tpu.dsp import timing as jax_timing  # noqa: E402
from tetraear_tpu.dsp.pipeline import CarrierBankDemod as JaxBank  # noqa: E402
from tetraear_tpu.frame import batch as jax_batch  # noqa: E402
from tetraear_tpu.runtime import sources as jax_sources  # noqa: E402
from tetraear_tpu.runtime import stream as jax_stream  # noqa: E402
from tetraear_tpu_torch import convert  # noqa: E402
from tetraear_tpu_torch.api import Pipeline, PipelineConfig  # noqa: E402
from tetraear_tpu_torch.dsp import backhalf  # noqa: E402
from tetraear_tpu_torch.dsp import channelizer as port_chan  # noqa: E402
from tetraear_tpu_torch.dsp import cuda_kernels as ck  # noqa: E402
from tetraear_tpu_torch.dsp import kernels, timing  # noqa: E402
from tetraear_tpu_torch.dsp.pipeline import (CarrierBankDemod,  # noqa: E402
                                             symbols_to_bits)
from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder  # noqa: E402
from tetraear_tpu_torch.golden import fleet_capture  # noqa: E402
from tetraear_tpu_torch.runtime import stream  # noqa: E402
from tetraear_tpu_torch.runtime.sources import FileIQSource  # noqa: E402
from torch_jax_repaired import repaired_timing  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "offair_2carrier.cs16"
FIX_OFFSETS = (12_500.0, -287_500.0)
CPU = "cpu"


def close(got, want, tol=1e-5, msg=""):
    """|got - want| <= tol * max|want| (complex or real arrays)."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(scale, 1e-30), (msg, err, scale)


def cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- dsp/kernels --------------------------------------------------------------

def test_nco_mix_equals_jax():
    rng = np.random.default_rng(0)
    fs, n = 2.4e6, 4000
    freqs = np.array([12_500.0, -287_500.0, 0.0, 612_500.0])
    tabs = jax_kernels.nco_tables(freqs, fs, n)
    mine = kernels.nco_tables(freqs, fs, n)
    for key in ("coarse", "fine", "block_step"):
        np.testing.assert_array_equal(mine[key], tabs[key])
    x = cplx(rng, 4, n)
    cycles = np.array([0.0, 1234.0, 7.0, 2_399_999.0], np.float32)
    want, wc = jax_kernels.nco_mix(
        jnp.asarray(x), jnp.asarray(cycles), jnp.asarray(tabs["coarse"]),
        jnp.asarray(tabs["fine"]), jnp.asarray(tabs["block_step"]),
        tabs["fs"])
    got, gc = kernels.nco_mix(
        torch.from_numpy(x), torch.from_numpy(cycles),
        torch.from_numpy(mine["coarse"]), torch.from_numpy(mine["fine"]),
        torch.from_numpy(mine["block_step"]), mine["fs"])
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    close(got.numpy(), want, msg="nco_mix")


def _plans():
    conv = jax_design.build_resample_plan(2.4e6, 72_000.0)
    fft = jax_design.build_resample_plan(150_000.0, 72_000.0)
    return {"conv0": conv.stages[0], "conv1": conv.stages[1],
            "fft0": fft.stages[0]}


@pytest.mark.parametrize("which", ["conv0", "conv1", "fft0"])
def test_stage_apply_equals_jax(which):
    """L == 1 decimator (1/4), L > 1 polyphase stages (3/25, 12/25)."""
    st = _plans()[which]
    rng = np.random.default_rng(1)
    n = st.down * st.up * 8
    hl = jax_kernels.stage_history_len(st)
    assert kernels.stage_history_len(st) == hl
    x, hist = cplx(rng, 3, n), cplx(rng, 3, hl)
    want, wh = jax_kernels.stage_apply(st, jnp.asarray(x), jnp.asarray(hist))
    got, gh = kernels.stage_apply(st, torch.from_numpy(x),
                                  torch.from_numpy(hist))
    close(got.numpy(), want, msg=which)
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))


def test_plan_apply_and_fir_apply_equal_jax():
    rng = np.random.default_rng(2)
    plan = jax_design.build_resample_plan(2.4e6, 72_000.0)
    x = cplx(rng, 2, 4000)
    jh = jax_kernels.init_plan_histories(plan, 2)
    ph = kernels.init_plan_histories(plan, 2, device=CPU)
    assert [tuple(h.shape) for h in ph] == [h.shape for h in jh]
    want, wh = jax_kernels.plan_apply(plan, jnp.asarray(x), jh)
    got, gh = kernels.plan_apply(plan, torch.from_numpy(x), ph)
    close(got.numpy(), want, msg="plan_apply")
    for g, w in zip(gh, wh):
        close(g.numpy(), w, msg="plan history")
    rrc = jax_design.rrc_taps().astype(np.float32)
    y, hist = cplx(rng, 2, 480), cplx(rng, 2, len(rrc) - 1)
    want, _ = jax_kernels.fir_apply(rrc, jnp.asarray(y), jnp.asarray(hist))
    got, _ = kernels.fir_apply(rrc, torch.from_numpy(y),
                               torch.from_numpy(hist))
    close(got.numpy(), want, msg="fir_apply")


# -- dsp/timing ---------------------------------------------------------------

@pytest.fixture(scope="module")
def matched():
    """(C, N) matched-filtered 4-sps samples of real slots (the JAX conv
    bank's baseband on a golden capture) and its timing state."""
    offs = [12_500.0, -12_500.0, 37_500.0]
    bank = JaxBank(fs=2.4e6, freqs_hz=offs, block_len=400 * 40)
    iq = fleet_capture(2.4e6, offs, range(3), 2 * bank.block_len, seed=5)
    state = bank.init_state()
    out, state = bank.step(iq[:bank.block_len], state)
    out, state2 = bank.step(iq[bank.block_len:], state)
    y = np.array(jax_kernels.r2c(out["baseband"]))
    return y, np_tree(state["timing"])


def test_timing_recover_equals_jax(matched):
    y, tst = matched
    jstate = {"tail": jax_kernels.r2c(jnp.asarray(tst["tail"])),
              "next_t": jnp.asarray(tst["next_t"]),
              "acc": jax_kernels.r2c(jnp.asarray(tst["acc"]))}
    pstate = {"tail": kernels.r2c(torch.from_numpy(tst["tail"].copy())),
              "next_t": torch.from_numpy(tst["next_t"].copy()),
              "acc": kernels.r2c(torch.from_numpy(tst["acc"].copy()))}
    ws, wv, wst = jax_timing.timing_recover(jnp.asarray(y), jstate)
    gs, gv, gst = timing.timing_recover(torch.from_numpy(y), pstate)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    close(gs.numpy(), ws, msg="symbols")
    np.testing.assert_array_equal(gst["next_t"].numpy(),
                                  np.asarray(wst["next_t"]))
    close(gst["acc"].numpy(), wst["acc"], msg="acc")
    np.testing.assert_array_equal(gst["tail"].numpy(), np.asarray(wst["tail"]))
    # the plain gather interpolator of the module agrees too
    t = (tst["next_t"][:, None] + 4.0 * np.arange(8)[None]).astype(np.float32)
    z = np.concatenate([np.asarray(jstate["tail"]), y], axis=1)
    close(timing._catmull_rom_rows(torch.from_numpy(z),
                                   torch.from_numpy(t)).numpy(),
          jax_timing._catmull_rom_rows(jnp.asarray(z), jnp.asarray(t)),
          msg="catmull_rom")
    i0 = jax_timing.init_timing_state(3)
    p0 = timing.init_timing_state(3, device=CPU)
    for key in i0:
        np.testing.assert_array_equal(p0[key].numpy(), np.asarray(i0[key]))


def test_timing_recover_keeps_a_symbol_snapped_below_one(matched):
    """A symbol clock that snaps from just above 1.0 to just below it
    keeps its symbol.  The JAX reference wraps such an instant a whole
    symbol on and drops that symbol, a one-way slip of the carrier's
    count that repeats while its timing sits there (a carrier of the
    benchmark's rtl80.busy lost 5 symbols a 16-block cycle).  The port
    reads it with the tap base clamped, as it reads an instant above
    SPS + 1, and gives the reference's instants from its second symbol
    on, and the same clock for the next block."""
    y, tst = matched
    c, n = y.shape
    mu = 0.95
    # an accumulator that outweighs the block's phasor fixes mu; the
    # clock sits at 1.05, so the snap moves it to 0.95
    acc = 1e12 * np.exp(-2j * np.pi * mu / timing.SPS)
    acc = np.stack([np.full(c, acc.real), np.full(c, acc.imag)],
                   axis=1).astype(np.float32)
    next_t = np.full(c, 1.05, np.float32)
    jstate = {"tail": jax_kernels.r2c(jnp.asarray(tst["tail"])),
              "next_t": jnp.asarray(next_t),
              "acc": jax_kernels.r2c(jnp.asarray(acc))}
    pstate = {"tail": kernels.r2c(torch.from_numpy(tst["tail"].copy())),
              "next_t": torch.from_numpy(next_t.copy()),
              "acc": kernels.r2c(torch.from_numpy(acc.copy()))}
    ws, wv, wst = jax_timing.timing_recover(jnp.asarray(y), jstate)
    gs, gv, gst = timing.timing_recover(torch.from_numpy(y), pstate)
    k = n // timing.SPS + 1
    assert (np.asarray(wv).sum(axis=1) == k - 1).all()     # one dropped
    assert (gv.numpy().sum(axis=1) == k).all()             # kept
    # the same instants, read on the next cubic segment (a fraction of
    # -0.05 there against 0.95 here): they differ by the interpolator's
    # own error, about 4e-4 of the largest symbol
    close(gs.numpy()[:, 1:], np.asarray(ws)[:, :-1], tol=2e-3,
          msg="later symbols")
    np.testing.assert_allclose(gst["next_t"].numpy(),
                               np.asarray(wst["next_t"]), atol=1e-3)
    # the kept symbol: the cubic on the block's first four samples
    z = np.concatenate([np.asarray(jstate["tail"]), y], axis=1)
    f = np.float32(gst["next_t"].numpy()[0] - 4.0 - 1.0)
    p0, p1, p2, p3 = (z[:, j] for j in range(4))
    first = 0.5 * (2 * p1 + (p2 - p0) * f
                   + (2 * p0 - 5 * p1 + 4 * p2 - p3) * f * f
                   + (3 * (p1 - p2) + p3 - p0) * f ** 3)
    close(gs.numpy()[:, 0], first, tol=1e-4, msg="kept symbol")


def test_timing_recover_kept_symbol_error_is_bounded(matched):
    """A clock snapped into [0, 1) is read with the tap base clamped: the
    cubic of the segment above each instant, at a fraction in [-1, 0),
    for every symbol of the block (the fraction is the carrier's).  Held
    against the interpolation of the same instants on their own
    segments, over the same samples with a longer tail, that read errs
    as the reference's own read of a clock above SPS + 1 errs at the
    mirror distance (i0 clamped there too): 5e-4 of the symbols' RMS
    for a snap to 0.95, about a sixth of it for one to 0.1."""
    y, tst = matched
    z = np.concatenate(
        [kernels.r2c(torch.from_numpy(tst["tail"].copy())).numpy(), y],
        axis=1)
    c, sps, shift = z.shape[0], timing.SPS, 2
    m = (z.shape[1] - shift - 8) // sps * sps

    def read(next_t, mu):
        """The block `shift` samples into z with its clock at next_t
        and an accumulator that snaps it to mu: (first instant in the
        block, kept count, RMS error against z's own segments / RMS)."""
        acc = 1e12 * np.exp(-2j * np.pi * np.full(c, mu) / sps)
        state = {"tail": torch.from_numpy(z[:, shift:shift + 4].copy()),
                 "next_t": torch.full((c,), next_t),
                 "acc": torch.from_numpy(acc.astype(np.complex64))}
        gs, gv, gst = timing.timing_recover(
            torch.from_numpy(z[:, shift + 4:shift + 4 + m].copy()), state)
        v = gv.numpy()
        first = gst["next_t"].numpy() - sps * v.sum(axis=1) + m
        t = (first[:, None] + shift
             + sps * np.arange(v.shape[1])[None]).astype(np.float32)
        want = timing._catmull_rom_rows(torch.from_numpy(z),
                                        torch.from_numpy(t)).numpy()[v]
        err = np.abs(gs.numpy()[v] - want)
        rms = np.sqrt(np.mean(np.abs(want) ** 2))
        return first, v.sum(axis=1), np.sqrt(np.mean(err ** 2)) / rms

    for d in (0.05, 0.25, 0.5, 0.9):
        first, kept, below = read(1.05, 1.0 - d)
        np.testing.assert_allclose(first, 1.0 - d, atol=1e-4)
        assert (kept == m // sps + 1).all()           # no symbol dropped
        first, _, above = read(4.95, 1.0 + d)
        np.testing.assert_allclose(first, 5.0 + d, atol=1e-4)
        assert below <= 1.25 * above + 1e-5, (d, below, above)
        if d == 0.05:
            assert below < 1e-3, below
        assert below < 0.25, (d, below)


def test_afc_and_demod_equal_jax(matched):
    y, tst = matched
    rng = np.random.default_rng(3)
    jstate = {"tail": jax_kernels.r2c(jnp.asarray(tst["tail"])),
              "next_t": jnp.asarray(tst["next_t"]),
              "acc": jax_kernels.r2c(jnp.asarray(tst["acc"]))}
    syms, valid, _ = jax_timing.timing_recover(jnp.asarray(y), jstate)
    syms, valid = np.array(syms), np.array(valid)
    omega = np.array([0.01, -0.02, 0.0], np.float32)
    phase = np.array([0.5, 6.0, 0.0], np.float32)
    n_valid = valid.sum(axis=1)
    wc, wp = jax_timing.apply_freq_correction(
        jnp.asarray(syms), jnp.asarray(omega), jnp.asarray(phase),
        n_valid=jnp.asarray(n_valid))
    gc, gp = timing.apply_freq_correction(
        torch.from_numpy(syms), torch.from_numpy(omega),
        torch.from_numpy(phase), n_valid=torch.from_numpy(n_valid))
    close(gc.numpy(), wc, msg="apply_freq_correction")
    close(gp.numpy(), wp, msg="phase")
    wc2, wp2 = jax_timing.apply_freq_correction(
        jnp.asarray(syms), jnp.asarray(omega), jnp.asarray(phase))
    gc2, gp2 = timing.apply_freq_correction(
        torch.from_numpy(syms), torch.from_numpy(omega),
        torch.from_numpy(phase))
    close(gp2.numpy(), wp2, msg="phase, padded count")
    # the d^4 detector: 1e-4 rad/symbol absolute (an angle of a sum of
    # ~120 unit phasors)
    we = np.asarray(jax_timing.afc_error(wc, jnp.asarray(valid)))
    ge = timing.afc_error(gc, torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(ge, we, rtol=0, atol=1e-4)
    prev = cplx(rng, 3)
    wh, wsoft, wprev = jax_timing.dqpsk_demod(
        jnp.asarray(syms), jnp.asarray(valid), jnp.asarray(prev))
    gh, gsoft, gprev = timing.dqpsk_demod(
        torch.from_numpy(syms), torch.from_numpy(valid),
        torch.from_numpy(prev))
    assert gh.dtype == torch.uint8
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    close(gsoft.numpy(), wsoft, msg="soft")
    np.testing.assert_array_equal(gprev.numpy(), np.asarray(wprev))


# -- dsp/channelizer ----------------------------------------------------------

# name -> (fs, offsets, nfft, jax env, port keywords); geometries of the
# three extraction branches and their formulation switches
CHAN = {
    "quantized_synth": (2.304e6, [12_500.0, -37_500.0, 62_500.0], 2 ** 14,
                        {}, {}),
    "quantized_gather": (2.304e6, [12_500.0, -37_500.0, 62_500.0], 2 ** 14,
                         {"TETRAEAR_NO_PALLAS_SYNTH": "1"},
                         {"kernel_synth": False}),
    "aligned_synth": (1.28e6, [40_000.0, -60_000.0, 150_000.0], 2 ** 14,
                      {}, {}),
    "aligned_extract_rows": (1.28e6, [40_000.0, -60_000.0, 150_000.0],
                             2 ** 14,
                             {"TETRAEAR_NO_PALLAS_SYNTH": "1",
                              "TETRAEAR_PALLAS_EXTRACT": "1"},
                             {"kernel_synth": False,
                              "kernel_extract": True}),
    "aligned_gather": (1.28e6, [40_000.0, -60_000.0, 150_000.0], 2 ** 14,
                       {"TETRAEAR_NO_PALLAS_SYNTH": "1"},
                       {"kernel_synth": False}),
    "element_gather": (2.4e6, [12_500.0, -287_500.0], 2 ** 10, {}, {}),
}


@pytest.mark.parametrize("name", list(CHAN))
def test_channelizer_step_equals_jax(name):
    fs, offs, nfft, env, kw = CHAN[name]
    with pytest.MonkeyPatch.context() as mp:
        for key, val in env.items():
            mp.setenv(key, val)
        jch = jax_chan.FFTChannelizer(fs, np.asarray(offs), nfft=nfft)
    pch = port_chan.FFTChannelizer(fs, np.asarray(offs), nfft=nfft, **kw)
    assert (pch.aligned, pch.quantized, pch.block_len, pch.overlap) == \
        (jch.aligned, jch.quantized, jch.block_len, jch.overlap)
    assert pch.synth_ok == jch.use_pallas_synth
    assert pch.use_extract_rows == jch.use_pallas
    assert name.split("_")[0] == ("aligned" if pch.aligned else "quantized"
                                  if pch.quantized else "element")
    for tab in ("band_start", "row_idx", "h1_band", "sign", "_m1", "_tw",
                "_m2"):
        if hasattr(jch, tab):
            np.testing.assert_array_equal(getattr(pch, tab),
                                          getattr(jch, tab), err_msg=tab)
    rng = np.random.default_rng(7)
    jstate = jch.init_state()
    pstate = pch.init_state(CPU)
    ck.reset_launches()
    for b in range(3):
        x = cplx(rng, jch.block_len)
        want, jstate = jch.step(jnp.asarray(x), jstate)
        got, pstate = pch.step(torch.from_numpy(x), pstate)
        # 3e-5 of the largest sample: the band inverse transform's
        # float32 summation order differs between the two packages
        close(got.numpy(), want, tol=3e-5, msg=f"{name} block {b}")
        np.testing.assert_array_equal(pstate["tail"].numpy(),
                                      np.asarray(jstate["tail"]))
        np.testing.assert_array_equal(pstate["cycles"].numpy(),
                                      np.asarray(jstate["cycles"]))
    assert not any(ck.launches.values())       # plain versions on the CPU


def test_tables_from_jax_carry_the_classic_tables():
    fs, offs, nfft, _, _ = CHAN["quantized_synth"]
    jch = jax_chan.FFTChannelizer(fs, np.asarray(offs), nfft=nfft)
    pch = port_chan.FFTChannelizer(fs, np.asarray(offs), nfft=nfft)
    tabs = convert.tables_from_jax(jch, device=CPU)
    assert {"row_idx", "band_start", "h1_roll", "ramp", "_m1", "_tw",
            "_m2", "h1_planes"} <= set(tabs)
    for name, t in tabs.items():
        assert torch.equal(t, torch.from_numpy(
            np.ascontiguousarray(getattr(pch, name)))), name


# -- dsp/pipeline: the bank's block step --------------------------------------

# name -> bank keywords (fs, offsets, frontend, afc, nfft / block_len)
BANKS = {
    "conv_afc": dict(fs=2.4e6, freqs_hz=list(FIX_OFFSETS), frontend="conv",
                     afc=True, block_len=400 * 40),
    "conv": dict(fs=2.4e6, freqs_hz=list(FIX_OFFSETS), frontend="conv",
                 block_len=400 * 40),
    "fft_stages_afc": dict(fs=2.4e6, freqs_hz=list(FIX_OFFSETS),
                           frontend="fft", afc=True, nfft=2 ** 15),
    "fft_afc": dict(fs=2.304e6, freqs_hz=[12_500.0, -12_500.0, 37_500.0],
                    frontend="fft", afc=True, nfft=2 ** 14),
    "fft_aligned_stages": dict(fs=1.28e6,
                               freqs_hz=[40_000.0, -60_000.0, 150_000.0],
                               frontend="fft", afc=True, nfft=2 ** 14),
}
N_BLOCKS = 4


@pytest.fixture(scope="module", params=list(BANKS))
def bank_runs(request):
    """JAX and port block steps with scan over blocks 1-3, the port
    starting from JAX's state after block 0."""
    kw = BANKS[request.param]
    jb, pb = JaxBank(**kw), CarrierBankDemod(**kw)
    assert (pb.block_len, pb.k_max, pb.granularity, pb.n_out72) == \
        (jb.block_len, jb.k_max, jb.granularity, jb.n_out72)
    assert [(s.up, s.down, s.taps) for s in pb.plan.stages] == \
        [(s.up, s.down, s.taps) for s in jb.plan.stages]
    offs = kw["freqs_hz"]
    iq = fleet_capture(kw["fs"], offs, range(len(offs)),
                       N_BLOCKS * jb.block_len, seed=9)
    blocks = [jax_kernels.c2r_np(iq[b * jb.block_len:(b + 1) * jb.block_len])
              for b in range(N_BLOCKS)]
    state = jb.init_state()
    tail = jnp.zeros((len(offs), 1200), jnp.uint8)
    jax_runs, pstate, ptail = [], None, None
    for b, x in enumerate(blocks):
        scan, state, tail, n_c, out = jax_backhalf.block_step_scan(
            jb, jnp.asarray(x), state, tail)
        jax_runs.append(np_tree({"scan": scan, "state": state, "tail": tail,
                                 "n_c": n_c, "out": out}))
        if b == 0:
            pstate = convert.state_from_jax(np_tree(state), device=CPU)
            ptail = convert.tail_bits_from_jax(np.asarray(tail), device=CPU)
    port_runs = [None]
    for x in blocks[1:]:
        scan, pstate, ptail, n_c, out = backhalf.block_step_scan(
            pb, torch.from_numpy(x), pstate, ptail)
        port_runs.append({"scan": convert.state_to_numpy(scan),
                          "state": convert.state_to_numpy(pstate),
                          "tail": ptail.numpy(), "n_c": n_c.numpy(),
                          "out": convert.state_to_numpy(out)})
    return request.param, jb, pb, jax_runs, port_runs


def test_init_state_equals_jax(bank_runs):
    _, jb, pb, _, _ = bank_runs
    want = np_tree(jb.init_state())
    got = convert.state_to_numpy(pb.init_state(CPU))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("blk", range(1, N_BLOCKS))
def test_step_decisions_equal(bank_runs, blk):
    name, _, _, jax_runs, port_runs = bank_runs
    want, got = jax_runs[blk], port_runs[blk]
    np.testing.assert_array_equal(got["out"]["valid"], want["out"]["valid"])
    np.testing.assert_array_equal(got["n_c"], want["n_c"])
    v = want["out"]["valid"]
    np.testing.assert_array_equal(got["out"]["hard"][v],
                                  want["out"]["hard"][v])
    # 3e-5: the channelizer's synthesis (see the channelizer case); the
    # conv banks stay inside 1e-5
    tol = 1e-5 if name.startswith("conv") else 3e-5
    close(got["out"]["baseband"], want["out"]["baseband"], tol=tol,
          msg="baseband")
    # soft bits are unit-normalised: 2e-4 absolute as in
    # tests/unit/test_backhalf.py (a small |d| amplifies rounding)
    np.testing.assert_allclose(got["out"]["soft"][v], want["out"]["soft"][v],
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("blk", range(1, N_BLOCKS))
def test_step_scan_planes_and_tails_equal(bank_runs, blk):
    _, _, _, jax_runs, port_runs = bank_runs
    want, got = jax_runs[blk], port_runs[blk]
    np.testing.assert_array_equal(got["scan"]["crc_err"],
                                  want["scan"]["crc_err"])
    np.testing.assert_array_equal(got["scan"]["corr"], want["scan"]["corr"])
    np.testing.assert_array_equal(got["tail"], want["tail"])
    assert got["tail"].dtype == np.uint8
    assert float(want["scan"]["corr"].max()) == 1.0       # slots are found


def test_step_state_close(bank_runs):
    _, _, _, jax_runs, port_runs = bank_runs
    want, got = jax_runs[-1]["state"], port_runs[-1]["state"]
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    np.testing.assert_array_equal(got["nco_cycles"], want["nco_cycles"])
    np.testing.assert_array_equal(got["timing"]["next_t"],
                                  want["timing"]["next_t"])
    if "channelizer" in want:
        for key in ("tail", "cycles"):
            np.testing.assert_array_equal(got["channelizer"][key],
                                          want["channelizer"][key])
    for g, w in zip(got["stage_hist"], want["stage_hist"]):
        close(g, w, tol=3e-5, msg="stage_hist")
    close(got["timing"]["tail"], want["timing"]["tail"], tol=3e-5)
    close(got["timing"]["acc"], want["timing"]["acc"], tol=3e-5)
    close(got["prev_sym"], want["prev_sym"], tol=1e-4)
    # the AFC registers integrate the detector's error over the blocks:
    # 1e-4 rad (omega, per symbol) and 1e-2 rad (phase, over ~500 symbols)
    np.testing.assert_allclose(got["afc_omega"], want["afc_omega"], rtol=0,
                               atol=1e-4)
    d = np.abs(got["afc_phase"] - want["afc_phase"])
    assert float(np.minimum(d, 2 * np.pi - d).max()) <= 1e-2


def test_classic_step_scan_and_bank_step(bank_runs):
    """classic_step_scan is block_step_scan without the demod outputs,
    and CarrierBankDemod.step takes a complex host block."""
    name, jb, pb, jax_runs, port_runs = bank_runs
    state = convert.state_from_jax(jax_runs[0]["state"], device=CPU)
    tail = convert.tail_bits_from_jax(jax_runs[0]["tail"], device=CPU)
    offs = BANKS[name]["freqs_hz"]
    iq = fleet_capture(BANKS[name]["fs"], offs, range(len(offs)),
                       2 * jb.block_len, seed=9)
    x = iq[jb.block_len:2 * jb.block_len]
    scan, st2, tl2, n_c = backhalf.classic_step_scan(
        pb, torch.from_numpy(jax_kernels.c2r_np(x)), state, tail)
    np.testing.assert_array_equal(scan["crc_err"].numpy(),
                                  port_runs[1]["scan"]["crc_err"])
    np.testing.assert_array_equal(tl2.numpy(), port_runs[1]["tail"])
    out, _ = pb.step(x, state)
    np.testing.assert_array_equal(out["hard"].numpy(),
                                  port_runs[1]["out"]["hard"])


# -- the slice as a whole -----------------------------------------------------

def frame_keys(frames):
    return [(f["carrier"], f["stream_symbol"], f["position"],
             bool(f["burst_crc"]), f.get("type_name"),
             bool(f.get("encrypted")), bool(f.get("decrypted")),
             f.get("sds_message")) for f in frames]


def golden_24():
    """A golden 2-carrier capture at 2.4 Msps on the fixture's offsets."""
    return fleet_capture(2.4e6, list(FIX_OFFSETS), range(2), 400 * 80 * 6,
                         seed=13, text="CLASSIC")


def fixture_iq():
    with jax_sources.FileIQSource(FIXTURE, sample_rate=2.4e6) as src:
        return np.asarray(src.read_samples(10 ** 7), np.complex64)


def test_scan_runner_equals_jax(repaired_timing):
    iq = golden_24()
    kw = dict(fs=2.4e6, freqs_hz=list(FIX_OFFSETS), block_len=400 * 80,
              afc=True)
    want = jax_stream.ScanRunner(JaxBank(**kw), blocks_per_dispatch=4).run(iq)
    got = stream.ScanRunner(CarrierBankDemod(**kw), blocks_per_dispatch=4,
                            device=CPU).run(iq)
    for ci in range(2):
        np.testing.assert_array_equal(got["symbols"][ci],
                                      want["symbols"][ci])
        assert len(got["symbols"][ci]) > 1000
        np.testing.assert_allclose(got["soft_bits"][ci],
                                   want["soft_bits"][ci], rtol=0, atol=2e-4)
    bits = symbols_to_bits(got["symbols"][0])
    assert bits.dtype == np.uint8 and len(bits) == 2 * len(got["symbols"][0])
    whole = CarrierBankDemod(**kw).run(iq, device=CPU)
    np.testing.assert_array_equal(whole["symbols"][1], got["symbols"][1])


@pytest.mark.parametrize("capture,frontend,sparse", [
    ("golden", "conv", True), ("golden", "conv", False),
    ("golden", "fft", True), ("fixture", "conv", True),
    ("fixture", "fft", False)])
def test_decode_runner_classic_equals_jax(capture, frontend, sparse,
                                          repaired_timing):
    """DecodeRunner on the classic chain (the JAX runner takes it on the
    CPU backend; 2.4 Msps is not fused-eligible anyway): identical frame
    lists, dense and sparse, against the JAX package with the port's
    repaired clock wrap (``repaired_timing``: on the off-air fixture the
    reference drops a symbol of the conv chain)."""
    iq = golden_24() if capture == "golden" else fixture_iq()
    kw = dict(fs=2.4e6, freqs_hz=list(FIX_OFFSETS), frontend=frontend,
              afc=True)
    if frontend == "conv":
        kw["block_len"] = 400 * 80
    else:
        kw["nfft"] = 2 ** 16
    jb, pb = JaxBank(**kw), CarrierBankDemod(**kw)
    n = len(iq) // jb.block_len * jb.block_len
    jr = jax_stream.DecodeRunner(
        jb, jax_batch.BatchedFrameDecoder(2, auto_decrypt=True),
        blocks_per_dispatch=3, fetch_soft=False, sparse=sparse)
    assert jr.fused is None
    want = jr.run(iq[:n])
    pr = stream.DecodeRunner(
        pb, BatchedFrameDecoder(2, auto_decrypt=True, device=CPU),
        blocks_per_dispatch=3, device=CPU, sparse=sparse)
    assert pr.fused is None and "72 kHz" in pr._backhalf_reason
    got = pr.run(iq[:n])
    assert frame_keys(got["frames"]) == frame_keys(want["frames"])
    assert pr.dispatches == jr.dispatches
    np.testing.assert_array_equal(pr._tail_bits.numpy(),
                                  np.asarray(jr._tail_bits))
    passes = [f for f in got["frames"] if f["burst_crc"]]
    assert len(passes) >= 8
    text = "[TXT] CLASSIC 0" if capture == "golden" \
        else "[TXT] FIXTURE CAPTURE OK"
    assert sum(f.get("sds_message") == text for f in passes) >= 4


def test_decode_runner_fixture_keeps_the_symbol_jax_drops():
    """On the off-air fixture the unmodified JAX package's conv chain
    drops one symbol on each carrier, where the clock snaps below 1.0;
    the port keeps it.  The exact difference: every frame of the
    reference's, each after the kept symbol one stream symbol later, and
    one frame more per carrier (the burst the dropped symbol broke),
    CRC-passing and carrying that carrier's SDS text."""
    iq = fixture_iq()
    kw = dict(fs=2.4e6, freqs_hz=list(FIX_OFFSETS), block_len=400 * 80,
              afc=True)
    n = len(iq) // kw["block_len"] * kw["block_len"]
    want = frame_keys(jax_stream.DecodeRunner(
        JaxBank(**kw), jax_batch.BatchedFrameDecoder(2, auto_decrypt=True),
        blocks_per_dispatch=3, fetch_soft=False, sparse=True).run(
            iq[:n])["frames"])
    got = frame_keys(stream.DecodeRunner(
        CarrierBankDemod(**kw),
        BatchedFrameDecoder(2, auto_decrypt=True, device=CPU),
        blocks_per_dispatch=3, device=CPU, sparse=True).run(
            iq[:n])["frames"])
    texts = {0: "[TXT] FIXTURE CAPTURE OK", 1: "[TXT] SECRET FIX MSG"}
    for ci in range(2):
        w = [k for k in want if k[0] == ci]
        g = [k for k in got if k[0] == ci]
        assert len(g) == len(w) + 1
        # the one extra frame: the first where the two lists part
        x = next(i for i in range(len(w) + 1) if i == len(w) or g[i] != w[i])
        assert 0 < x < len(w)
        extra = g[x]
        assert extra[3] and extra[7] == texts[ci]
        assert g[:x] == w[:x]
        assert g[x + 1:] == [(k[0], k[1] + 1, *k[2:]) for k in w[x:]]
        assert w[x - 1][1] < extra[1] < w[x][1] + 1


def test_decode_runner_switches_and_reset():
    """fused=False forces the classic chain on an eligible bank, and
    kernel_scan=False takes the conv scan: same frames as the fused
    run."""
    fs, offs = 2.304e6, [12_500.0, -12_500.0]
    kw = dict(fs=fs, freqs_hz=offs, frontend="fft", nfft=2 ** 15)
    bl = CarrierBankDemod(**kw).block_len
    iq = fleet_capture(fs, offs, range(2), 5 * bl, seed=17)

    def run(**opts):
        r = stream.DecodeRunner(
            CarrierBankDemod(**kw),
            BatchedFrameDecoder(2, auto_decrypt=False, device=CPU),
            blocks_per_dispatch=2, device=CPU, **opts)
        return r, frame_keys(r.run(iq)["frames"])

    fr, fused = run()
    cr, classic = run(fused=False)
    _, conv_scan = run(fused=False, kernel_scan=False)
    assert fr.fused is not None and cr.fused is None
    assert cr._backhalf_reason == "fused=False"
    crc = [k for k in fused if k[3]]
    assert len(crc) >= 6
    assert [k for k in classic if k[3]] == crc
    assert conv_scan == classic
    cr.reset_stream(BatchedFrameDecoder(2, auto_decrypt=False, device=CPU))
    assert frame_keys(cr.run(iq)["frames"]) == classic


@pytest.mark.parametrize("frontend", ["conv", "fft"])
def test_pipeline_run_offline_fixture_equals_jax(frontend, repaired_timing):
    """The README's flow on the off-air fixture through the entry point,
    with the defaults (conv frontend, AFC on, auto-decrypt): the port's
    frames equal the JAX package's (with the port's repaired clock wrap,
    ``repaired_timing``), crc_pass >= 16, both SDS texts."""
    want = []
    jcfg = jax_api.PipelineConfig(
        sample_rate=2.4e6, carrier_offsets_hz=FIX_OFFSETS, voice=False,
        frontend=frontend)
    jpipe = jax_api.Pipeline(jcfg, on_frame=want.append)
    jstats = jpipe.run_offline(
        jax_sources.FileIQSource(FIXTURE, sample_rate=2.4e6))
    got = []
    cfg = PipelineConfig(carrier_offsets_hz=FIX_OFFSETS, frontend=frontend,
                         device=CPU)
    assert (cfg.sample_rate, cfg.carrier_afc, cfg.auto_decrypt,
            cfg.block_len) == (jcfg.sample_rate, jcfg.carrier_afc,
                               jcfg.auto_decrypt, jcfg.block_len)
    pipe = Pipeline(cfg, on_frame=got.append)
    assert pipe.block_len == jpipe.block_len
    stats = pipe.run_offline(FileIQSource(FIXTURE, sample_rate=2.4e6))
    assert frame_keys(got) == frame_keys(want)
    assert [f.get("tdma") for f in got] == [f.get("tdma") for f in want]
    assert [f.get("valid") for f in got] == [f.get("valid") for f in want]
    assert stats.crc_pass == jstats.crc_pass >= 16
    assert (stats.blocks, stats.frames, stats.decrypted) == \
        (jstats.blocks, jstats.frames, jstats.decrypted)
    assert pipe.dispatches == jpipe.dispatches
    texts = [(f["carrier"], f.get("sds_message")) for f in got]
    assert texts.count((0, "[TXT] FIXTURE CAPTURE OK")) >= 8
    assert texts.count((1, "[TXT] SECRET FIX MSG")) >= 8


def test_pipeline_block_len_rounding_and_records(tmp_path):
    """The conv frontend rounds the requested block length down to the
    granularity (131072 -> 130800 at 2.4 Msps, as the JAX Pipeline), and
    the JSONL log holds one line per frame."""
    cfg = PipelineConfig(carrier_offsets_hz=FIX_OFFSETS, device=CPU,
                         records_dir=str(tmp_path))
    pipe = Pipeline(cfg)
    assert pipe.bank.granularity == 400 and pipe.block_len == 130_800
    stats = pipe.run_offline(FileIQSource(FIXTURE, sample_rate=2.4e6),
                             max_blocks=2)
    assert stats.blocks == 2
    lines = next(tmp_path.glob("frames_*.jsonl")).read_text().splitlines()
    assert len(lines) == stats.frames >= 8
