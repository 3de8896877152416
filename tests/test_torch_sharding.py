"""The port's carrier x time sharding (tetraear_tpu_torch/runtime/
sharding.py) against the JAX package's, on the CPU.

  * ``ShardedDemod`` (conv frontend) on a virtual 2 x 4 CPU mesh against
    the JAX class on its 2 x 4 mesh of virtual CPU devices, on the input
    of tests/integration/test_sharding.py's fixture (C=4, 2.4 Msps,
    seg_len 72,000): valid equal, hard equal on the valid symbols beyond
    the 64-symbol warmup that test uses, sync_hits equal, soft within
    2e-4 (float32 rounding of the NCO / resample chain; the largest
    difference seen is 4e-5).
  * ``ShardedFFTDemod`` on a 2 x 2 mesh against the JAX class at
    2.304 MHz (quantized grid: the element route, ``band_extract``'s
    plain version) and 10.24 MHz (aligned: the row route,
    ``band_extract_rows``'s plain version), 4 modulated carriers each:
    valid, hard and sync_hits equal.
  * ``make_mesh`` and ``plan_input_halo`` against the reference's,
    including the error on too few devices; the int64 phase guard.
  * Carrier-axis invariance: carrier sharding duplicates nothing, so
    sync_hits and the deduped unique frames are equal over the (1, 2),
    (2, 2) and (4, 2) meshes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tetraear_tpu.dsp import design as jax_design  # noqa: E402
from tetraear_tpu.ref import modulator as jax_modulator  # noqa: E402
from tetraear_tpu.runtime import sharding as jsh  # noqa: E402
from tetraear_tpu_torch import golden  # noqa: E402
from tetraear_tpu_torch.dsp import design  # noqa: E402
from tetraear_tpu_torch.runtime import multichip  # noqa: E402
from tetraear_tpu_torch.runtime import sharding as tsh  # noqa: E402

SOFT_TOL = 2e-4
WARMUP = 64


def _cpu(n: int) -> list:
    return ["cpu"] * n


@pytest.fixture(scope="module")
def conv_pair():
    """Both packages' ShardedDemod on the JAX integration test's input."""
    rng = np.random.default_rng(0)
    c = 4
    offsets = [(i - 2) * 25_000 + 12_500 for i in range(c)]
    bits = [rng.integers(0, 2, 4600).astype(np.uint8) for _ in range(c)]
    iq = jax_modulator.generate_multi_carrier(
        bits, fs=2.4e6, offsets_hz=offsets, snr_db=25,
        rng=np.random.default_rng(1))
    jd = jsh.ShardedDemod(fs=2.4e6, freqs_hz=offsets,
                          mesh=jsh.make_mesh(2, 4), seg_len=72_000)
    td = tsh.ShardedDemod(fs=2.4e6, freqs_hz=offsets,
                          mesh=tsh.make_mesh(2, 4, _cpu(8)), seg_len=72_000)
    return jd.run(iq), td.run(iq), td


def test_conv_shapes_and_tables(conv_pair):
    want, got, td = conv_pair
    for k in ("hard", "soft", "valid"):
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
    assert got["hard"].shape[:2] == (4, 4)


def test_conv_valid_and_hard_equal_beyond_warmup(conv_pair):
    want, got, _ = conv_pair
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"].astype(bool)
    v[..., :WARMUP] = False
    assert v.sum() > 1000
    np.testing.assert_array_equal(got["hard"][v], want["hard"][v])


def test_conv_sync_hits_equal(conv_pair):
    want, got, _ = conv_pair
    assert got["sync_hits"] == want["sync_hits"]


def test_conv_soft_within_tolerance(conv_pair):
    want, got, _ = conv_pair
    v = want["valid"].astype(bool)
    np.testing.assert_allclose(got["soft"][v], want["soft"][v], rtol=0,
                               atol=SOFT_TOL)


FFT_CASES = {
    # fs: (offsets, whether the grid is aligned)
    2.304e6: ([-512_500.0, -37_500.0, 12_500.0, 512_500.0], False),
    10.24e6: ([-1_012_500.0, -37_500.0, 12_500.0, 1_512_500.0], True),
}


@pytest.fixture(scope="module", params=sorted(FFT_CASES))
def fft_pair(request):
    fs = request.param
    offs, aligned = FFT_CASES[fs]
    td = tsh.ShardedFFTDemod(fs=fs, freqs_hz=offs,
                             mesh=tsh.make_mesh(2, 2, _cpu(4)))
    # every carrier transmits over the whole capture: symbol decisions on
    # noise alone (past the end of a stream) follow the FFTs' rounding
    iq = golden.fleet_capture(fs, offs, range(4), 2 * td.seg_len, seed=5)
    jd = jsh.ShardedFFTDemod(fs=fs, freqs_hz=offs, mesh=jsh.make_mesh(2, 2))
    return jd.run(iq), td.run(iq), td, aligned


def test_fft_route_and_geometry(fft_pair):
    _, _, td, aligned = fft_pair
    assert td.chan.aligned == aligned
    assert {p.form for p in td.plans} == {"rows" if aligned else "pairs"}
    assert len(td.plans) == 2 and len(td.plans[0].starts) == 2


def test_fft_valid_hard_hits_equal(fft_pair):
    want, got, td, _ = fft_pair
    assert got["hard"].shape == want["hard"].shape
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["hard"], want["hard"])
    assert got["sync_hits"] == want["sync_hits"]
    # every slot of every carrier and segment is seen
    assert got["sync_hits"] >= 4 * 2 * td.seg_len / td.fs * 18_000 / 255


@pytest.mark.parametrize("fs", sorted(FFT_CASES))
def test_fft_unique_frames_are_the_slots(fs):
    offs, _ = FFT_CASES[fs]
    td = tsh.ShardedFFTDemod(fs=fs, freqs_hz=offs,
                             mesh=tsh.make_mesh(2, 2, _cpu(4)))
    iq, n_slots = multichip.modulated_capture(offs, 2 * td.seg_len, fs=fs,
                                              seed=5)
    out = td.run(iq)
    assert multichip.count_unique_frames(
        out, 4, 2, *multichip.fft_frame_geometry(td)) == n_slots


def test_make_mesh_matches_reference():
    for n_c, n_t in ((2, 4), (1, 8), (4, 2), (1, 1)):
        want = jsh.make_mesh(n_c, n_t)
        got = tsh.make_mesh(n_c, n_t, _cpu(8))
        assert got.shape == dict(want.shape)
        assert got.axis_names == tuple(want.axis_names)
        assert got.devices.shape == want.devices.shape
        assert got.local() == [tuple(i) for i in np.ndindex(n_c, n_t)]
    with pytest.raises(ValueError) as want_err:
        jsh.make_mesh(4, 4)
    with pytest.raises(ValueError) as got_err:
        tsh.make_mesh(4, 4, _cpu(8))
    assert str(got_err.value) == str(want_err.value) == \
        "need 16 devices, have 8"


def test_mesh_axis_devices_and_ranks():
    m = tsh.Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("carrier", "time"),
                 ranks=[[0, 1], [0, 1]])
    assert m.local(0) == [(0, 0), (1, 0)] and m.local(1) == [(0, 1), (1, 1)]
    assert len(m.axis_devices("time")) == 2
    assert len(tsh.Mesh(["cpu"] * 4, ("voice",)).axis_devices()) == 4
    with pytest.raises(ValueError, match="axis names"):
        tsh.Mesh(["cpu"] * 4, ("carrier", "time"))


@pytest.mark.parametrize("fs", [2.4e6, 2.304e6, 10.24e6, 36.864e6])
def test_plan_input_halo_matches_reference(fs):
    for warm, gran in ((16, 1), (300, 4), (4, 25)):
        want = jsh.plan_input_halo(
            jax_design.build_resample_plan(fs, 72_000.0),
            len(jax_design.rrc_taps(sps=4)), gran, warmup_symbols=warm)
        got = tsh.plan_input_halo(
            design.build_resample_plan(fs, 72_000.0),
            len(design.rrc_taps(sps=4)), gran, warmup_symbols=warm)
        assert got == want


def test_int64_phase_guard():
    """The JAX step's int32 t * seg_step equals the port's int64 product
    below 2^31; the port refuses a mesh where it would not.  At 2.4 Msps,
    seg_len 72,000 and a 33 Hz carrier the step is 2,376,000 cycles:
    900 time shards stay under 2^31, 1000 do not."""
    kw = dict(fs=2.4e6, freqs_hz=[33.0, 12_500.0], seg_len=72_000)
    sd = tsh.ShardedDemod(mesh=tsh.make_mesh(1, 900, _cpu(900)), **kw)
    assert int(sd.seg_step.max()) == 2_376_000
    fs_i = np.int32(2_400_000)
    for t in range(900):
        want = (np.int32(t) * sd.seg_step.astype(np.int32)) % fs_i
        want = (want - sd.halo_cycles.astype(np.int32)) % fs_i
        got = np.remainder(np.remainder(t * sd.seg_step, 2_400_000)
                           - sd.halo_cycles, 2_400_000)
        np.testing.assert_array_equal(got, want.astype(np.int64))
    with pytest.raises(ValueError, match="int32 phase"):
        tsh.ShardedDemod(mesh=tsh.make_mesh(1, 1000, _cpu(1000)), **kw)


def test_carrier_axis_invariance():
    """(1, 2), (2, 2) and (4, 2) give the same sync_hits, unique frames,
    valid and hard symbols: the carrier axis duplicates nothing."""
    offs = [(i - 4) * 25_000 + 12_500.0 for i in range(8)]
    mk = tsh.ShardedFFTDemod(fs=2.304e6, freqs_hz=offs,
                             mesh=tsh.make_mesh(1, 2, _cpu(2)))
    iq, n_slots = multichip.modulated_capture(offs, 2 * mk.seg_len,
                                              fs=2.304e6, seed=9)
    res = []
    for n_c in (1, 2, 4):
        sd = tsh.ShardedFFTDemod(fs=2.304e6, freqs_hz=offs,
                                 mesh=tsh.make_mesh(n_c, 2, _cpu(2 * n_c)))
        out = sd.run(iq)
        res.append((out, multichip.count_unique_frames(
            out, 8, 2, *multichip.fft_frame_geometry(sd))))
    (first, uniq0), rest = res[0], res[1:]
    assert uniq0 == n_slots
    for out, uniq in rest:
        assert uniq == uniq0
        assert out["sync_hits"] == first["sync_hits"]
        np.testing.assert_array_equal(out["valid"], first["valid"])
        np.testing.assert_array_equal(out["hard"], first["hard"])


def test_conv_rung_on_a_virtual_mesh():
    """The multi-device dry run's conv rung (runtime/multichip.py) on a
    virtual 2 x 2 CPU mesh: unique frames equal the transmitted slots."""
    r = multichip.conv_rung(_cpu(4), 2, 2, say=lambda s: None)
    assert r["unique_frames"] == r["slots"] == 8
