"""The port's bench (tetraear_tpu_torch/bench.py) vs the JAX package's.

The root ``bench.py`` is the JAX package's benchmark; it is loaded here
by path (the port never imports it).  Its bank geometry, its JSON line
and its four chain bodies are the reference:

  * ``make_bank`` against ``_make_bank`` (bench.py:62): fs, offsets,
    nfft with and without the BENCH_NFFT_CAP override, block_len, k_max,
    n_band, at C = 8 and 1024; ``choose_nfft`` and the cap alone at the
    geometries a card runs (C = 10240, 20480, 40960);
  * the chain bodies at C = 8 (9.216 MHz, nfft 2^20, blocks of
    1,040,384): the reference's bodies are closures inside ``run_bench``,
    so this file keeps a copy of each (bench.py:139-144, 184-204,
    206-242, 264-307), built from the JAX package's public functions.
    Both packages run two chained steps on the same seeded inputs, the
    bench's noise block and a capture whose eight carriers transmit
    throughout: equal nhit / nok from the fused and the classic e2e
    chains, equal hard symbols from the demod chain, equal pacc (and
    the last step's PCM) from the voice chain, and non-zero counts on
    the modulated capture.  The voice chain's speech stage on the JAX
    side is the C++ decoder the JAX package loads (voice/codec.py), a
    decoder a carrier carried across steps: tests/codec/test_jspeech.py
    holds jspeech.decode_block bit-equal to it on any frame stream with
    its state carried, and compiling jspeech alone takes longer here
    than this whole file may;
  * ``bench_line`` against the line the reference's ``main`` prints for
    the same result, in each mode;
  * ``main``: a failed chain ends in the zero line with ``degraded``
    "fatal: ..." and a non-zero exit; without a card and without
    ``--device cpu`` it raises; ``python -m tetraear_tpu_torch bench
    --device cpu`` runs;
  * the nfft cap's decode equivalence (the port's counterpart of
    tests/unit/test_channelizer.py::test_nfft_cap_decode_equivalent):
    the bank at half the default nfft decodes a 2.4 Msps capture
    error-free on the interior, as the full bank does, with the JAX
    bank's symbols.
"""

import ctypes
import importlib.util
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tetraear_tpu.dsp import backhalf as jax_backhalf  # noqa: E402
from tetraear_tpu.dsp import channelizer as jax_chan  # noqa: E402
from tetraear_tpu.dsp import framescan as jax_fs  # noqa: E402
from tetraear_tpu.dsp import kernels as jax_kernels  # noqa: E402
from tetraear_tpu.dsp.pipeline import CarrierBankDemod as JaxBank  # noqa: E402
from tetraear_tpu.voice import codec as jax_codec  # noqa: E402
from tetraear_tpu.voice import jviterbi  # noqa: E402
from tetraear_tpu.voice.etsi_tables import TAB0, TAB1, TAB2  # noqa: E402
from tetraear_tpu_torch import bench, golden  # noqa: E402
from tetraear_tpu_torch.dsp import channelizer as chan  # noqa: E402
from tetraear_tpu_torch.dsp.backhalf import FusedRx, TAILBITS  # noqa: E402
from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod  # noqa: E402
from tetraear_tpu_torch.ref import modulator  # noqa: E402
from tetraear_tpu_torch.voice import speech  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
C8 = 8
STEPS = 2


def _root_bench():
    spec = importlib.util.spec_from_file_location("_jax_root_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RB = _root_bench()


# -- geometry -----------------------------------------------------------------

@pytest.mark.parametrize("c, cap", [(8, None), (8, 2 ** 19), (8, 0),
                                    (1024, None)])
def test_make_bank_geometry_equals_reference(c, cap, monkeypatch):
    if cap is not None:
        monkeypatch.setenv("BENCH_NFFT_CAP", str(cap))
    jb, jfs = RB._make_bank(c, None, "fft")
    pb, pfs = bench.make_bank(c, device="cpu")
    assert pfs == jfs
    np.testing.assert_array_equal(pb.freqs_hz,
                                  np.asarray(jb.freqs_hz, np.float64))
    assert pb.freqs_hz.tolist() == [float(f) for f in
                                    bench.bench_offsets(c)]
    pc, jc = pb.channelizer, jb.channelizer
    assert pc.nfft == jc.nfft == (cap if cap else 2 ** (20 if c == 8
                                                        else 22))
    assert (pb.block_len, pb.k_max) == (jb.block_len, jb.k_max)
    assert (pc.n_band, pc.decim, pc.overlap) == (jc.n_band, jc.decim,
                                                 jc.overlap)


@pytest.mark.parametrize("c, fs, nfft", [(10240, 294.912e6, 2 ** 25),
                                         (20480, 589.824e6, 2 ** 26),
                                         (40960, 1179.648e6, 2 ** 27)])
def test_choose_nfft_and_cap(c, fs, nfft, monkeypatch):
    assert bench.bench_fs(c) == fs
    assert chan.choose_nfft(fs) == jax_chan.choose_nfft(fs) == nfft
    assert chan.choose_decim(fs) == jax_chan.choose_decim(fs) == fs / 72e3
    want = 2 ** 26 if nfft > 2 ** 26 else None
    assert bench.capped_nfft(fs) == want
    assert bench.capped_nfft(fs, "conv") is None
    monkeypatch.setenv("BENCH_NFFT_CAP", "0")
    assert bench.capped_nfft(fs) is None


# -- the chain bodies at C=8 -------------------------------------------------
#
# Copies of the reference's closures (bench.py run_bench), with the bank
# and the fused receiver passed in where the reference closes over them.
# The reference jits a whole chain, steps in a lax.scan; here scan_loop
# runs the same body from a Python loop and the block steps inside it
# (FusedRx.step, CarrierBankDemod._step_impl, the channel decoder) are
# jitted once and shared by the chains, so that this file compiles each
# step once (and the scan and the sparse hit keys are jitted, not run op
# by op).


def scan_loop(body, init, n):
    """jax.lax.scan(body, init, None, length=n) as a Python loop."""
    carry, ys = init, []
    for _ in range(n):
        carry, y = body(carry, None)
        ys.append(y)
    return carry, None if ys[0] is None else jnp.stack(ys)


class JitBank:
    """The JAX bank with its block step jitted."""

    def __init__(self, bank):
        self.k_max = bank.k_max
        self._step_impl = jax.jit(bank._step_impl)


class JitFused:
    """The JAX fused receiver with its block step jitted."""

    def __init__(self, fused):
        self.step = jax.jit(fused.step)
        self.soft_symbols = jax.jit(fused.soft_symbols)


def jax_chain_demod(bank, x_r, state, n):
    """bench.py:139-144."""
    def body(st, _):
        out, st2 = bank._step_impl(x_r, st)
        return st2, out["hard"][:, 0]
    st, tails = scan_loop(body, state, n)
    return st, tails


def jax_chain_e2e_fused(fused, x_r, state, n):
    """bench.py:184-204."""
    off = jax_fs.TS_OFFSET_BITS // 2

    def body(carry, _):
        st, nhit, nok = carry
        out, st2 = fused.step(x_r, st)
        hits = out["corr"] >= 0.90
        span = min(hits.shape[1] - off, out["crc_err"].shape[1])
        sync_al = jax.lax.slice_in_dim(hits, off, off + span, 1, axis=1)
        crc_al = jax.lax.slice_in_dim(out["crc_err"], 0, span, 1, axis=1)
        nhit = nhit + jnp.sum(hits.astype(jnp.int32))
        nok = nok + jnp.sum((sync_al & (crc_al <= 2)).astype(jnp.int32))
        return (st2, nhit, nok), None

    init = (state, jnp.int32(0), jnp.int32(0))
    (st, nhit, nok), _ = scan_loop(body, init, n)
    return st, nhit, nok


def jax_chain_e2e(bank, x_r, state, tail, n):
    """bench.py:206-242 (t2 = 1200 carried tail bits)."""
    k = bank.k_max
    k2 = 2 * k
    t2 = 1200

    def body(carry, _):
        st, tl, nhit, nok = carry
        out, st2 = bank._step_impl(x_r, st)
        hard = out["hard"]
        valid = out["valid"]
        n_c = jnp.sum(valid, axis=1)
        h = jnp.where(valid, hard, 0).astype(jnp.uint8)
        bits = jnp.repeat(h, 2, axis=1)
        bits = bits.at[:, 0::2].set(h >> 1)
        bits = bits.at[:, 1::2].set(h & 1)
        z = jnp.concatenate([tl, bits], axis=1)
        scan = _SCAN(z)
        hits = scan["corr"] >= 0.90
        off = jax_fs.TS_OFFSET_BITS // 2
        span = min(hits.shape[1] - off, scan["crc_err"].shape[1])
        sync_al = jax.lax.slice_in_dim(hits, off, off + span, 1, axis=1)
        crc_al = jax.lax.slice_in_dim(scan["crc_err"], 0, span, 1, axis=1)
        nhit = nhit + jnp.sum(hits.astype(jnp.int32))
        nok = nok + jnp.sum((sync_al & (crc_al <= 2)).astype(jnp.int32))
        tl2 = jax.lax.slice_in_dim(z, k2 - 4, k2 - 4 + t2, 1, axis=1)
        for d in (1, 2):
            cand = jax.lax.slice_in_dim(
                z, k2 - 4 + 2 * d, k2 - 4 + 2 * d + t2, 1, axis=1)
            tl2 = jnp.where((n_c == k - 2 + d)[:, None], cand, tl2)
        return (st2, tl2, nhit, nok), None

    init = (state, tail, jnp.int32(0), jnp.int32(0))
    (st, tl, nhit, nok), _ = scan_loop(body, init, n)
    return st, nhit, nok


_POS = np.concatenate([TAB0, TAB1, TAB2]) - 1
_INV = np.argsort(_POS).astype(np.int32)
O1, O2 = 100, 500
_DECODE = jax.jit(jviterbi.channel_decode_batch_traced)
_SCAN = jax.jit(jax_fs.frame_scan_packed_even)
_SPARSE = jax.jit(jax_fs.sparse_hits, static_argnums=2)


def jax_unbuild(ordered, bfi):
    """bench.py:264-271."""
    fa = ordered[:, 2 * jnp.asarray(_INV)]
    fb = ordered[:, 2 * jnp.asarray(_INV) + 1]
    fr = jnp.stack([fa, fb], axis=1).astype(jnp.int32)
    b = jnp.broadcast_to(bfi[:, None, None].astype(jnp.int32),
                         (fr.shape[0], 2, 1))
    return jnp.concatenate([b, fr], axis=2)


def cpp_decode(decoders, frames):
    """(C, F, 138) frames, every frame valid -> (C, F, 240) int16 PCM,
    one C++ decoder a carrier (the JAX package's codec library)."""
    lib = jax_codec._LIB
    pcm = np.empty(frames.shape[:2] + (240,), np.int16)
    for ci, dec in enumerate(decoders):
        for f in range(frames.shape[1]):
            fr = np.ascontiguousarray(frames[ci, f], np.int16)
            out = np.empty(240, np.int16)
            rc = lib.tetra_speech_decode(
                dec, fr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
            assert rc == 0
            pcm[ci, f] = out
    return pcm


def jax_chain_voice(fused, x_r, state, n, n_carriers):
    """bench.py:273-313, the speech stage (:303-305) on the C++ decoder:
    a decoder a carrier (jspeech.init_state), every frame valid.  Returns
    (nhit, nok, pacc, the last step's PCM)."""
    off = jax_fs.TS_OFFSET_BITS // 2
    lib = jax_codec._LIB

    def body(carry, _):
        st, sst, nhit, nok, pacc = carry
        out, st2 = fused.step(x_r, st)
        hits = out["corr"] >= 0.90
        span = min(hits.shape[1] - off, out["crc_err"].shape[1])
        sync_al = jax.lax.slice_in_dim(hits, off, off + span, 1, axis=1)
        crc_al = jax.lax.slice_in_dim(out["crc_err"], 0, span, 1, axis=1)
        nhit = nhit + jnp.sum(hits.astype(jnp.int32))
        nok = nok + jnp.sum((sync_al & (crc_al <= 2)).astype(jnp.int32))
        keys, counts = _SPARSE(out["corr"], out["crc_err"],
                               jax_fs.SPARSE_K)
        soft = fused.soft_symbols(out["soft_planes"])
        s1 = jax.lax.slice_in_dim(soft, O1, O1 + 216, 1, axis=1)
        s2 = jax.lax.slice_in_dim(soft, O2, O2 + 216, 1, axis=1)
        sb = jnp.concatenate([s1, s2], axis=0)
        sb = jnp.round(sb.reshape(sb.shape[0], 432) * 127.0).astype(
            jnp.int32)
        ordered, bfi = _DECODE(sb)
        fr1 = jax_unbuild(ordered[:n_carriers], bfi[:n_carriers])
        fr2 = jax_unbuild(ordered[n_carriers:], bfi[n_carriers:])
        frames = jnp.concatenate([fr1, fr2], axis=1)   # (C, 4, 138)
        pcm = cpp_decode(sst, np.asarray(frames))
        pacc = pacc + jnp.sum(jnp.asarray(pcm)[:, :, 0].astype(jnp.int32))
        pacc = pacc + keys[0, 0] + counts[0]
        return (st2, sst, nhit, nok, pacc), pcm

    decoders = [lib.tetra_speech_decoder_new() for _ in range(n_carriers)]
    try:
        init = (state, decoders, jnp.int32(0), jnp.int32(0), jnp.int32(0))
        (st, _, nhit, nok, pacc), pcms = scan_loop(body, init, n)
    finally:
        for dec in decoders:
            lib.tetra_speech_decoder_free(dec)
    return int(nhit), int(nok), int(pacc), np.asarray(pcms[-1])


INPUTS = ("noise", "modulated")


@pytest.fixture(scope="module")
def c8():
    if jax_codec._LIB is None:
        pytest.fail("the JAX package's codec library is not built "
                    "(make -C tetraear_tpu/voice/csrc)")
    jbank, fs = RB._make_bank(C8, None, "fft")
    pbank, _ = bench.make_bank(C8, device="cpu")
    block = jbank.block_len
    rng = np.random.default_rng(0)                  # bench.py:118-120
    noise = (rng.standard_normal(block)
             + 1j * rng.standard_normal(block)).astype(np.complex64)
    mod = golden.fleet_capture(fs, bench.bench_offsets(C8), range(C8),
                               block, seed=3)
    jfused = jax_backhalf.FusedRx(jbank)
    jf, jb = JitFused(jfused), JitBank(jbank)
    pfused = FusedRx(pbank, "cpu")
    runs = {}
    for name, x in (("noise", noise), ("modulated", mod)):
        xd = jnp.asarray(jax_kernels.c2r_np(x))
        xp = jnp.asarray(jax_kernels.c2p_np(x))
        if name == "noise":
            x_r, x_p = bench.noise_block(block, "cpu")
            np.testing.assert_array_equal(x_r.numpy(), np.asarray(xd))
            np.testing.assert_array_equal(x_p.numpy(), np.asarray(xp))
        else:
            x_r = torch.from_numpy(jax_kernels.c2r_np(x))
            x_p = torch.from_numpy(jax_kernels.c2p_np(x))
        j = {}
        _, nhit, nok = jax_chain_e2e_fused(jf, xp, jfused.init_state(),
                                           STEPS)
        j["fused"] = (int(nhit), int(nok))
        _, nhit, nok = jax_chain_e2e(jb, xd, jbank.init_state(),
                                     jnp.zeros((C8, 1200), jnp.uint8),
                                     STEPS)
        j["classic"] = (int(nhit), int(nok))
        _, tails = jax_chain_demod(jb, xd, jbank.init_state(), STEPS)
        j["demod"] = np.asarray(tails)
        j["voice"] = jax_chain_voice(jf, xp, jfused.init_state(), STEPS, C8)
        p = {}
        o = bench.chain_e2e_fused(pfused, x_p, pfused.init_state(), STEPS)
        p["fused"] = (int(o["nhit"]), int(o["nok"]))
        o = bench.chain_e2e(pbank, x_r, pbank.init_state("cpu"),
                            torch.zeros((C8, TAILBITS), dtype=torch.uint8),
                            STEPS)
        p["classic"] = (int(o["nhit"]), int(o["nok"]))
        p["demod"] = bench.chain_demod(pbank, x_r, pbank.init_state("cpu"),
                                       STEPS)["tails"].numpy()
        o = bench.chain_voice(pfused, x_p, pfused.init_state(),
                              speech.init_state(C8, "cpu"), STEPS)
        p["voice"] = (int(o["nhit"]), int(o["nok"]), int(o["pacc"]),
                      o["pcm"].numpy())
        runs[name] = {"jax": j, "port": p}
    return runs


@pytest.mark.parametrize("inp", INPUTS)
@pytest.mark.parametrize("chain", ["fused", "classic"])
def test_e2e_counters_equal(c8, inp, chain):
    want, got = c8[inp]["jax"][chain], c8[inp]["port"][chain]
    assert got == want
    if inp == "modulated":
        assert want[0] > 0 and want[1] > 0, want


@pytest.mark.parametrize("inp", INPUTS)
def test_demod_hard_symbols_equal(c8, inp):
    want, got = c8[inp]["jax"]["demod"], c8[inp]["port"]["demod"]
    assert got.shape == want.shape == (STEPS, C8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("inp", INPUTS)
def test_voice_pacc_equal(c8, inp):
    want, got = c8[inp]["jax"]["voice"], c8[inp]["port"]["voice"]
    assert got[:3] == want[:3]
    assert got[3].shape == (C8, 4, 240)
    np.testing.assert_array_equal(got[3], want[3].astype(np.int32))
    # the voice chain's counters are the fused chain's
    assert got[:2] == c8[inp]["port"]["fused"]


# -- the result line ---------------------------------------------------------

ROOF = {"roofline_pct": 12.3456, "roofline_measured_pct": 13.5791,
        "measured_gbs": 3093.1, "measured_gbs_source": "env:X",
        "bound": "memory", "achieved_tflops": 1.5, "achieved_gbs": 400.0}
VMODEL = {"model_voice_carriers_rt": 123456.78, "voice_model_pct": 4.56}


def _result(mode: str, rt: float) -> dict:
    r = {"n_carriers": 1024, "backend": "card", "steps": 20,
         "rt_factor": rt, "carriers_rt": rt * 1024, "elapsed_s": 0.5,
         "input_msps": 1234.5, "roofline": dict(ROOF)}
    if mode in ("both", "e2e"):
        r["e2e_variant"] = "fused"
    if mode in ("both", "demod"):
        r["demod_carriers_rt"] = 4567.891
    if mode in ("both", "voice"):
        r["voice_carriers_rt"] = 2345.678
        r["voice_model"] = dict(VMODEL)
    return r


@pytest.mark.parametrize("rt", [0.75, 31.4159])
@pytest.mark.parametrize("mode", bench.MODES)
def test_bench_line_equals_reference_line(mode, rt, monkeypatch, capsys):
    r = _result(mode, rt)
    monkeypatch.setattr(RB, "run_bench", lambda **kw: dict(r))
    monkeypatch.setenv("BENCH_MODE", mode)
    monkeypatch.delenv("BENCH_STEPS", raising=False)
    old = signal.getsignal(signal.SIGALRM)
    try:
        RB.main()
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    cap = capsys.readouterr()
    want = json.loads(cap.out.strip().splitlines()[-1])
    assert "degraded" not in want
    got = bench.bench_line(r, mode)
    assert got == want
    assert list(got) == list(want)
    assert bench.summary(r) == cap.err.strip().splitlines()[-1]


# -- main ---------------------------------------------------------------------

def test_main_failed_chain_is_fatal(monkeypatch, capsys):
    def boom(**kw):
        raise RuntimeError("fused_backhalf: CUDA error 700")
    monkeypatch.setattr(bench, "run_bench", boom)
    monkeypatch.setenv("BENCH_CARRIERS", "8")
    handler = signal.getsignal(signal.SIGALRM)
    rc = bench.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc != 0
    first, last = json.loads(out[0]), json.loads(out[-1])
    assert first["degraded"].startswith("bootstrap")
    assert last["degraded"].startswith("fatal: RuntimeError: fused_backhalf")
    assert last["value"] == 0.0 and last["metric"] == bench.METRIC
    assert signal.getsignal(signal.SIGALRM) == handler   # restored
    assert signal.alarm(0) == 0                          # and disarmed


def test_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs")
    from tetraear_tpu_torch.cli import main
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        main(["bench"])
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        bench.run_bench(8)


def test_cli_bench_on_the_cpu(tmp_path):
    # both mode; the voice chain (its plain speech decoder is the CPU's
    # slowest part) runs in test_run_bench_result_on_the_cpu
    env = {**os.environ, "BENCH_CARRIERS": "8", "BENCH_STEPS": "2",
           "BENCH_VOICE": "0", "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path)}
    for k in ("BENCH_MODE", "BENCH_NO_FUSED", "BENCH_NFFT_CAP",
              "BENCH_FRONTEND"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-m", "tetraear_tpu_torch", "bench",
                        "--device", "cpu"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 2
    line = json.loads(lines[-1])
    assert "degraded" not in line
    assert line["e2e_variant"] == "fused"
    assert line["rt_factor"] > 0 and line["concurrent_carriers"] in (0, 8)
    assert "demod_only_carriers" in line
    assert not {"voice_carriers_rt", "voice_model_carriers_rt"} & set(line)
    assert "# backend=cpu n_carriers=8" in r.stderr


def test_run_bench_result_on_the_cpu(monkeypatch):
    monkeypatch.delenv("BENCH_NO_FUSED", raising=False)
    r = bench.run_bench(C8, steps=1, mode="e2e", device="cpu")
    assert r["e2e_variant"] == "fused" and r["nfft"] == 2 ** 20
    assert "roofline" not in r                      # the card's only
    # the timed run's counters: those of one fused step on the noise block
    pbank, _ = bench.make_bank(C8, device="cpu")
    fused = FusedRx(pbank, "cpu")
    _, x_p = bench.noise_block(pbank.block_len, "cpu")
    o = bench.chain_e2e_fused(fused, x_p, fused.init_state(), 1)
    e2e = r["counters"]["e2e"]
    assert (e2e["nhit"], e2e["nok"]) == (int(o["nhit"]), int(o["nok"]))
    assert e2e["next_t0"] == o["state"]["bank"]["timing"]["next_t"][0].item()
    r = bench.run_bench(C8, steps=1, mode="voice", device="cpu")
    assert r["rt_factor"] == r["voice_rt_factor"] > 0
    assert set(r["counters"]) == {"voice"}
    voice = r["counters"]["voice"]
    assert (voice["nhit"], voice["nok"]) == (e2e["nhit"], e2e["nok"])
    # the voice model's ceiling is the card's integer issue rate, so that
    # its share stays a share
    vm = r["voice_model"]
    assert vm["eff_basicops_per_s"] == vm["theoretical_int_issue_per_s"]
    assert 0 < vm["voice_model_pct"] < 100
    assert "e2e_variant" not in r
    monkeypatch.setenv("BENCH_NO_FUSED", "1")
    r = bench.run_bench(C8, steps=1, mode="e2e", device="cpu")
    assert r["e2e_variant"] == "classic"
    assert r["fused_reason"] == "BENCH_NO_FUSED=1"
    with pytest.raises(RuntimeError, match="needs the fused path"):
        bench.run_bench(C8, steps=1, mode="voice", device="cpu")
    with pytest.raises(ValueError, match="BENCH_MODE"):
        bench.run_bench(C8, steps=1, mode="fast", device="cpu")


# -- the nfft cap: half-size blocks decode the same --------------------------

def _best(rx, tx):
    best = 0.0
    for s in range(len(rx) - len(tx) + 1):
        best = max(best, float(np.mean(rx[s:s + len(tx)] == tx)))
        if best == 1.0:
            break
    return best


def test_nfft_cap_decode_equivalent():
    """tests/unit/test_channelizer.py::test_nfft_cap_decode_equivalent on
    the port's bank; the capped bank's symbols held equal to the JAX
    bank's at the same nfft (the full banks are compared in
    test_torch_classic.py)."""
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, 9000).astype(np.uint8)
    iq = modulator.generate_carrier(bits, fs=2.4e6, freq_offset_hz=50_000,
                                    snr_db=25, rng=np.random.default_rng(4))
    full = CarrierBankDemod(fs=2.4e6, freqs_hz=[50_000.0], frontend="fft")
    half = CarrierBankDemod(fs=2.4e6, freqs_hz=[50_000.0], frontend="fft",
                            nfft=full.channelizer.nfft // 2)
    assert half.channelizer.nfft * 2 == full.channelizer.nfft
    tx = modulator.bits_to_symbols(bits)
    covered = min((len(iq) // half.block_len) * half.block_len,
                  (len(iq) // full.block_len) * full.block_len)
    n_sym = int(covered / 2.4e6 * 18_000)
    want = tx[100:n_sym - 100]
    assert _best(full.run(iq, device="cpu")["symbols"][0], want) == 1.0
    got = half.run(iq, device="cpu")["symbols"][0]
    assert _best(got, want) == 1.0
    jhalf = JaxBank(fs=2.4e6, freqs_hz=[50_000.0], frontend="fft",
                    nfft=half.channelizer.nfft)
    np.testing.assert_array_equal(got, jhalf.run(iq)["symbols"][0])
