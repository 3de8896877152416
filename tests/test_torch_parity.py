"""Parity of the port against the reference chain (BASELINE.md parity
bound), as tests/integration/test_parity.py holds the JAX package to it.

The port's ref/legacy.py (the reference's scipy decimate -> Butterworth
filtfilt -> best-phase symbol pick -> legacy quantizer, a host copy) is
held bit for bit to the JAX package's on golden captures at SNR 25, 15
and 10 dB; then the port's Pipeline on the CPU at 2.4 Msps (the classic
conv chain) is held to the parity bound on the same captures: at least
the legacy chain's frames and CRC passes, and in fact all 8 slots.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

SNRS = [25, 15, 10]


def _capture(snr_db):
    from tetraear_tpu_torch.ref import golden
    payloads = [golden.sds_text_payload("HELLO HELLO")] * 8
    return golden.golden_iq(payloads, fs=2.4e6, snr_db=snr_db, seed=snr_db)


@pytest.mark.parametrize("snr_db", SNRS)
def test_legacy_process_bit_equal(snr_db):
    from tetraear_tpu.ref import golden as ref_golden
    from tetraear_tpu.ref import legacy as ref_legacy
    from tetraear_tpu_torch.ref import legacy
    iq = _capture(snr_db)
    want_iq = ref_golden.golden_iq(
        [ref_golden.sds_text_payload("HELLO HELLO")] * 8, fs=2.4e6,
        snr_db=snr_db, seed=snr_db)
    np.testing.assert_array_equal(iq, want_iq)
    got = legacy.legacy_process(iq, 2.4e6)
    want = ref_legacy.legacy_process(iq, 2.4e6)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # with a frequency shift too (the reference's mixer step)
    np.testing.assert_array_equal(
        legacy.legacy_process(iq, 2.4e6, freq_offset=1500.0),
        ref_legacy.legacy_process(iq, 2.4e6, freq_offset=1500.0))
    assert legacy.chain_stats(got) == ref_legacy.chain_stats(want)


@pytest.mark.parametrize("snr_db", SNRS)
def test_pipeline_dominates_legacy(snr_db):
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.golden import ArraySource
    from tetraear_tpu_torch.ref import legacy
    iq = _capture(snr_db)
    s_leg = legacy.chain_stats(legacy.legacy_process(iq, 2.4e6))
    frames = []
    pipe = Pipeline(PipelineConfig(sample_rate=2.4e6, device="cpu",
                                   voice=False), on_frame=frames.append)
    pipe.run_offline(ArraySource(iq, 2.4e6))
    assert pipe.runner.fused is None         # the classic conv chain
    n_crc = sum(bool(f.get("burst_crc")) for f in frames)
    # parity bound: at least match the reference...
    assert len(frames) >= s_leg["frames"]
    assert n_crc >= s_leg["crc_pass"]
    # ...and in fact decode everything that was transmitted
    assert len(frames) == 8
    assert n_crc == 8
    assert all(f.get("sds_message") == "[TXT] HELLO HELLO" for f in frames)


@pytest.mark.parametrize("snr_db", SNRS)
def test_oracle_dominates_legacy(snr_db):
    """The port's corrected oracle demod (ref/demod.py) on the same
    captures, as the JAX package's parity test runs it."""
    from tetraear_tpu_torch.ref import demod, legacy
    iq = _capture(snr_db)
    s_leg = legacy.chain_stats(legacy.legacy_process(iq, 2.4e6))
    s_new = legacy.chain_stats(demod.OracleDemod(fs=2.4e6).run(iq)["symbols"])
    assert s_new["frames"] >= s_leg["frames"]
    assert s_new["crc_pass"] >= s_leg["crc_pass"]
    assert s_new["frames"] == 8
    assert s_new["crc_pass"] == 8


def test_legacy_chain_reproduces_reference_defect():
    """The port's legacy quantizer carries the reference's symbol-1
    defect (clean +3pi/4 transitions decode as 3), as the JAX one does."""
    from tetraear_tpu.ref.demod import dqpsk_demod as ref_demod
    from tetraear_tpu_torch.ref.demod import dqpsk_demod
    pts = np.exp(1j * np.cumsum([0.0] + [3 * np.pi / 4] * 8)).astype(
        np.complex64)
    hard, _, _ = dqpsk_demod(pts, None, quantizer="legacy")
    assert np.all(hard == 3)
    np.testing.assert_array_equal(
        hard, ref_demod(pts, None, quantizer="legacy")[0])
