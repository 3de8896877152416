"""Plain versions of the port's three kernels vs the JAX Pallas kernels.

On the CPU every wrapper of tetraear_tpu_torch.dsp.cuda_kernels runs
its kernel's plain PyTorch version; the JAX side runs its Pallas kernel
in interpret mode.  Inputs are the JAX block step's own: the golden
8-carrier capture at 2.304 MHz (tests/unit/test_backhalf.py geometry),
one block to warm the carried state up, then the recorded arguments of
the Pallas calls on the second block.

Tolerances: fft2p 1e-4 of the spectrum RMS (the JAX transform runs in
bf16x3, error 2.8e-5 of RMS); band_synth y 1e-5 of RMS and the phasor
1e-5 of its magnitude (same float32 Cooley-Tukey matmuls, other
summation order); fused_backhalf verdicts and bit tails exact, corr
1e-6, soft bits 2e-4, last row and last symbol 1e-4 absolute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tetraear_tpu.dsp import backhalf as jax_backhalf  # noqa: E402
from tetraear_tpu.dsp import kernels as jax_kernels  # noqa: E402
from tetraear_tpu.dsp import pallas_kernels as pk  # noqa: E402
from tetraear_tpu.dsp.pipeline import CarrierBankDemod as JaxBank  # noqa: E402
from tetraear_tpu.ref import modulator  # noqa: E402
from tetraear_tpu_torch.dsp import cuda_kernels as ck  # noqa: E402

FS = 2.304e6
OFFSETS = [(i - 4) * 25_000 + 12_500.0 for i in range(8)]


def golden_capture(block_len: int, n_blocks: int, seed: int = 11):
    """The test_backhalf.py capture: 8 carriers of real TETRA slots
    (random payloads) at 25 dB SNR, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    n = n_blocks * block_len
    sym_count = int(n / FS * 18_000) + 64

    def carrier_bits():
        slots = [modulator.make_slot_bits(
            rng.integers(0, 2, 432).astype(np.uint8))
            for _ in range(2 * sym_count // 510 + 1)]
        return np.concatenate(slots)[:2 * sym_count]

    bits = [carrier_bits() for _ in OFFSETS]
    iq = modulator.generate_multi_carrier(
        bits, fs=FS, offsets_hz=OFFSETS, snr_db=25, rng=rng)
    if len(iq) < n:
        pad = 0.001 * (rng.standard_normal(n - len(iq))
                       + 1j * rng.standard_normal(n - len(iq)))
        iq = np.concatenate([iq, pad.astype(np.complex64)])
    return iq[:n].astype(np.complex64)


def _record(name, log):
    real = getattr(pk, name)

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        log[name] = (args, kw, out)
        return out
    return real, wrapper


@pytest.fixture(scope="module")
def ref():
    """JAX reference runs: two fused block steps with the Pallas calls
    of the second recorded, and the interpret-mode fft2p of its block."""
    bank = JaxBank(fs=FS, freqs_hz=OFFSETS, frontend="fft")
    ch = bank.channelizer
    iq = golden_capture(bank.block_len, 2)
    fused = jax_backhalf.FusedRx(bank)
    state = fused.init_state()
    x0 = iq[:bank.block_len]
    x1 = iq[bank.block_len:]
    _, state = fused.step(jnp.asarray(jax_kernels.c2p_np(x0)), state)
    log = {}
    saved = {}
    try:
        for name in ("band_synth", "fused_backhalf"):
            saved[name], wrapped = _record(name, log)
            setattr(pk, name, wrapped)
        out, _ = fused.step(jnp.asarray(jax_kernels.c2p_np(x1)), state)
        jax.block_until_ready(out)
    finally:
        for name, real in saved.items():
            setattr(pk, name, real)
    tail_p = np.ascontiguousarray(
        np.asarray(state["bank"]["channelizer"]["tail"]).T)
    x_p = jax_kernels.c2p_np(x1)
    planes_spliced = ch.wideband_planes_spliced(
        jnp.asarray(tail_p), jnp.asarray(x_p), interpret=True)
    xx = np.concatenate([tail_p[0] + 1j * tail_p[1],
                         x_p[0] + 1j * x_p[1]]).astype(np.complex64)
    planes = ch.wideband_planes(jnp.asarray(xx), interpret=True)
    return {"ch": ch, "log": log, "fused": fused, "tail_p": tail_p,
            "x_p": x_p, "planes_spliced": np.asarray(planes_spliced),
            "planes": np.asarray(planes)}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_fft2p_spliced_matches_jax(ref):
    ch = ref["ch"]
    n1, n2 = ch.fft2p_n1, ch.fft2p_n2
    o2 = ch.overlap // n1
    got = ck.fft2p_planes_spliced(
        _t(ref["tail_p"]).reshape(2, o2, n1),
        _t(ref["x_p"]).reshape(2, n2 - o2, n1), n1, n2, ch.fft2p_wrap)
    want = ref["planes_spliced"]
    assert got.shape == want.shape
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    assert np.abs(got.numpy() - want).max() <= 1e-4 * rms


def test_fft2p_unspliced_matches_jax(ref):
    """The JAX fft2p_planes (no splice) is the port kernel's o2 = 0."""
    ch = ref["ch"]
    n1, n2 = ch.fft2p_n1, ch.fft2p_n2
    win = torch.cat([_t(ref["tail_p"]), _t(ref["x_p"])], dim=1)
    got = ck.fft2p_planes_spliced(win[:, :0].reshape(2, 0, n1),
                                  win.reshape(2, n2, n1), n1, n2,
                                  ch.fft2p_wrap)
    want = ref["planes"]
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    assert np.abs(got.numpy() - want).max() <= 1e-4 * rms


def test_band_synth_matches_jax(ref):
    args, kw, (y_want, ph_want) = ref["log"]["band_synth"]
    assert kw["phasor_drop"] == ref["ch"].drop
    y, ph = ck.band_synth(*(_t(a) for a in args[:9]), args[9],
                          kw["phasor_drop"])
    y_want = np.asarray(y_want)
    ph_want = np.asarray(ph_want)
    assert y.shape == y_want.shape and ph.shape == ph_want.shape
    rms = np.sqrt(np.mean(y_want.astype(np.float64) ** 2))
    assert np.abs(y.numpy() - y_want).max() <= 1e-5 * rms
    mag = np.abs(ph_want[:, 0, 0] + 1j * ph_want[:, 0, 1])
    assert np.all(np.abs(ph.numpy() - ph_want).max(axis=(1, 2))
                  <= 1e-5 * mag)
    assert not ph.numpy()[:, :, 2:].any()


def test_fused_backhalf_matches_jax(ref):
    args, kw, outs = ref["log"]["fused_backhalf"]
    y, bt, rr, rc, sc, bsel, dsel = (_t(a) for a in args[:7])
    got = ck.fused_backhalf(y, bt, rr, rc, sc, bsel, dsel, kw["drop"],
                            kw["k_max"])
    want = [np.asarray(o) for o in outs]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.numpy().dtype == w.dtype
    fused = ref["fused"]
    c = y.shape[0]
    corr, err, soft, bt2, last, misc = (g.numpy() for g in got)
    np.testing.assert_array_equal(
        err.reshape(c, -1)[:, :fused.n_err],
        want[1].reshape(c, -1)[:, :fused.n_err])
    np.testing.assert_array_equal(bt2, want[3])
    np.testing.assert_allclose(corr.reshape(c, -1)[:, :fused.n_corr],
                               want[0].reshape(c, -1)[:, :fused.n_corr],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(soft, want[2], atol=2e-4, rtol=0)
    np.testing.assert_allclose(last, want[4], atol=1e-4, rtol=0)
    np.testing.assert_allclose(misc, want[5], atol=1e-4, rtol=0)
    # the block really carries frames: sync hits and CRC passes
    assert (corr >= 0.9).sum() > 0 and (err <= 2).sum() > 0


# -- the wrapper contract ----------------------------------------------------

def _fft2p_args():
    return [torch.zeros(2, 8, 128), torch.zeros(2, 120, 128), 128, 128, 2]


def _band_synth_args():
    p = 4
    return [torch.zeros(2, 40, 128), torch.zeros(2, 128, p, 128),
            torch.zeros(3, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32), torch.zeros(2 * p, 2 * p),
            torch.zeros(128, 128), torch.zeros(128, 128),
            torch.zeros(128, p), torch.zeros(128, p), p, 8]


def _backhalf_args():
    c, p = 2, 8
    return [torch.zeros(c, 2, 128, p), torch.zeros(c, 10, 128),
            torch.zeros(c, 2, 128, 1), torch.zeros(c, 2, 1, p),
            torch.zeros(c, 16), torch.zeros(c, dtype=torch.int32),
            torch.zeros(c, dtype=torch.int32), 8, 200]


WRAPPERS = {
    "fft2p": (ck.fft2p_planes_spliced, _fft2p_args),
    "band_synth": (ck.band_synth, _band_synth_args),
    "fused_backhalf": (ck.fused_backhalf, _backhalf_args),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_cpu_runs_plain_version(name):
    fn, make = WRAPPERS[name]
    before = dict(ck.launches)
    out = fn(*make())
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.device.type == "cpu" for o in outs)
    assert ck.launches == before       # plain versions count nothing


@pytest.mark.parametrize("name", list(WRAPPERS))
@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity"])
def test_wrapper_rejects_bad_input(name, fault):
    fn, make = WRAPPERS[name]
    args = make()
    t = args[0]
    if fault == "dtype":
        args[0] = t.to(torch.float64)
    elif fault == "shape":
        args[0] = t[..., :-1].contiguous()
    else:
        args[0] = torch.zeros(t.shape[:-2] + t.shape[-2:][::-1]
                              ).transpose(-1, -2)
        assert not args[0].is_contiguous() and args[0].shape == t.shape
    with pytest.raises(ValueError):
        fn(*args)


def test_module_import_builds_nothing():
    """Importing the module must not compile or load the kernels."""
    import subprocess
    import sys
    code = ("import tetraear_tpu_torch.dsp.cuda_kernels as ck; "
            "assert ck._lib is None and not ck.build_info; print('ok')")
    from pathlib import Path
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr
