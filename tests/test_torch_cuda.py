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
    0, half and all symbols valid: phase_kernels_extra exits on any
    excess error."""
    smoke.phase_kernels_extra(seed=6)


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
