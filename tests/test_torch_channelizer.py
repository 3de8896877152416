"""Port channelizer geometry and tables vs the JAX reference.

tetraear_tpu_torch builds the overlap-save channelizer's geometry and
host tables without JAX; every value must equal the JAX object's
exactly, at the test geometry (2.304 MHz, 8 carriers) and at the fleet
geometry (36.864 MHz, 1024 carriers on the 25 kHz grid).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from tetraear_tpu.dsp import backhalf as jax_backhalf  # noqa: E402
from tetraear_tpu.dsp import channelizer as jax_chan  # noqa: E402
from tetraear_tpu.dsp.pipeline import CarrierBankDemod as JaxBank  # noqa: E402
from tetraear_tpu_torch import convert  # noqa: E402
from tetraear_tpu_torch.dsp import channelizer as port_chan  # noqa: E402
from tetraear_tpu_torch.dsp.backhalf import FusedRx  # noqa: E402
from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod  # noqa: E402


def grid(c):
    return [(i - c // 2) * 25_000 + 12_500.0 for i in range(c)]


GEOMETRIES = {"fs2.304_C8": (2.304e6, 8), "fs36.864_C1024": (36.864e6, 1024)}

SCALARS = ("fs", "decim", "nfft", "n_band", "out_rate", "h1_len",
           "fft2p_n1", "fft2p_n2", "fft2p_ok", "fft2p_wrap",
           "fft2p_splice", "overlap", "block_len", "drop", "n_out",
           "aligned", "quantized", "synth_rows")

TABLES = ("k_c", "residual_hz", "band_start", "h1_band", "d_shift",
          "h1_roll", "ramp", "sign", "row_start", "h1_planes", "m1c",
          "m2re", "m2im", "twre", "twim", "cycle_step")


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def banks(request):
    fs, c = GEOMETRIES[request.param]
    return (JaxBank(fs=fs, freqs_hz=grid(c), frontend="fft"),
            CarrierBankDemod(fs=fs, freqs_hz=grid(c), frontend="fft"))


def test_geometry_equal(banks):
    jb, pb = banks
    for name in SCALARS:
        assert getattr(pb.channelizer, name) == \
            getattr(jb.channelizer, name), name
    assert (pb.k_max, pb.block_len, pb.granularity) == \
        (jb.k_max, jb.block_len, jb.granularity)


@pytest.mark.parametrize("name", TABLES)
def test_table_equal(banks, name):
    jb, pb = banks
    want = getattr(jb.channelizer, name)
    got = getattr(pb.channelizer, name)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_tables_from_jax_equal_port_tables(banks):
    jb, pb = banks
    from_jax = convert.tables_from_jax(jb.channelizer, device="cpu")
    for name, t in from_jax.items():
        own = torch.from_numpy(np.asarray(getattr(pb.channelizer, name)))
        assert torch.equal(t, own), name


@pytest.mark.parametrize("fs", [2.304e6, 2.4e6, 9.216e6, 36.864e6,
                                294.912e6, 1.024e6])
def test_choose_decim_and_nfft(fs):
    assert port_chan.choose_decim(fs) == jax_chan.choose_decim(fs)
    assert port_chan.choose_nfft(fs) == jax_chan.choose_nfft(fs)


def test_fused_geometry_and_init_state(banks):
    """FusedRx sizes and the initial carried state match the JAX
    FusedRx (state compared through convert.state_from_jax)."""
    jb, pb = banks
    jf = jax_backhalf.FusedRx(jb)
    pf = FusedRx(pb, device="cpu")
    assert (pf.p, pf.sy, pf.drop, pf.k_max, pf.n_corr, pf.n_err) == \
        (jf.p, jf.sy, jf.drop, jf.k_max, jf.n_corr, jf.n_err)
    np.testing.assert_array_equal(pf.rc_planes.numpy(), jf._rc_planes)
    np.testing.assert_array_equal(pf._rt0_re.numpy(), jf._rt0.real)
    np.testing.assert_array_equal(pf._rt0_im.numpy(), jf._rt0.imag)
    import jax
    want = jax.tree_util.tree_map(np.asarray, jf.init_state())
    got = convert.state_to_numpy(pf.init_state())
    conv = convert.state_to_numpy(
        convert.state_from_jax(want, device="cpu"))
    for tree in (got, conv):
        flat_got = jax.tree_util.tree_leaves_with_path(tree)
        for path, leaf in flat_got:
            ref = want
            for key in path:
                ref = ref[key.key]
            np.testing.assert_array_equal(leaf, ref, err_msg=str(path))


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_ineligible_rate_raises_jax_message():
    """A rate with resample stages (2.4 Msps: 150 kHz channel) is not
    fused-eligible; the port's FusedRx raises the JAX FusedRx message
    (the bank itself builds: the classic chain serves it)."""
    want = _message(lambda: jax_backhalf.FusedRx(
        JaxBank(fs=2.4e6, freqs_hz=[12_500.0], frontend="fft")))
    got = _message(lambda: FusedRx(CarrierBankDemod(
        fs=2.4e6, freqs_hz=[12_500.0], frontend="fft"), device="cpu"))
    assert got == want and "72 kHz" in got


def test_conv_frontend_and_afc_raise_jax_messages():
    assert "72 kHz" in _message(lambda: FusedRx(CarrierBankDemod(
        fs=2.304e6, freqs_hz=[12_500.0], frontend="conv"), device="cpu"))
    want = _message(lambda: jax_backhalf.FusedRx(JaxBank(
        fs=2.304e6, freqs_hz=[12_500.0], frontend="fft", afc=True)))
    got = _message(lambda: FusedRx(CarrierBankDemod(
        fs=2.304e6, freqs_hz=[12_500.0], frontend="fft", afc=True),
        device="cpu"))
    assert got == want and "AFC" in got
