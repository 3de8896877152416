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
