"""The port's scanners (tetraear_tpu_torch/scan/) against the JAX
package's on the same captures, on the CPU.

  * ``WidebandScanner.scan(device="cpu")`` on the two-carrier 2.4 Msps
    capture of tests/unit/test_scan_validate.py (4 slots: shorter than
    one FFT block, so both take the conv bank) and on a 14-slot one (two
    FFT blocks: the FFT bank, ``band_synth_y``'s plain version here): every
    channel's verdicts, frame and sync counts, correlation and CRC rate
    equal; ``power_db`` within 1e-4 dB (float32 band power; the largest
    difference seen is 2e-6).
  * ``FrequencyScanner`` and ``TetraSignalDetector`` (host numpy copies)
    on the synthetic step source that test drives: equal results.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tetraear_tpu.ref import golden, modulator  # noqa: E402
from tetraear_tpu.scan import detector as jdet  # noqa: E402
from tetraear_tpu.scan import scanner as jscan  # noqa: E402
from tetraear_tpu_torch.scan import detector as tdet  # noqa: E402
from tetraear_tpu_torch.scan import scanner as tscan  # noqa: E402

POWER_TOL_DB = 1e-4
HOT = (-37_500.0, 62_500.0)


def _capture(n_payloads: int) -> np.ndarray:
    """tests/unit/test_scan_validate.py's wideband capture."""
    rng = np.random.default_rng(2)
    payloads = [golden.sds_text_payload("HELLO HELLO")] * n_payloads
    parts = []
    for off in HOT:
        bits_stream = golden.build_stream(payloads, seed=17)
        pad = rng.integers(0, 2, 64).astype(np.uint8)
        parts.append(modulator.generate_carrier(
            np.concatenate([pad, bits_stream]), fs=2.4e6,
            freq_offset_hz=off))
    n = min(len(p) for p in parts)
    iq = np.sum([p[:n] for p in parts], axis=0).astype(np.complex64)
    return modulator.add_awgn(iq, 25, np.random.default_rng(3))


@pytest.fixture(scope="module", params=[4, 14], ids=["conv", "fft"])
def wideband(request):
    iq = _capture(request.param)
    want = jscan.WidebandScanner(fs=2.4e6).scan(iq, center_freq_hz=392.5e6)
    ws = tscan.WidebandScanner(fs=2.4e6)
    got = ws.scan(iq, center_freq_hz=392.5e6, device="cpu")
    return want, got, ws, (len(iq), request.param)


def test_wideband_bank_choice(wideband):
    """The short capture takes the conv bank, the long one two blocks of
    the FFT bank."""
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    _, _, ws, (n, n_payloads) = wideband
    bl = CarrierBankDemod(fs=ws.fs, freqs_hz=ws.offsets,
                          frontend="fft").block_len
    assert ws.n_channels == 92
    assert n // bl == (0 if n_payloads == 4 else 2)


def test_wideband_results_equal(wideband):
    want, got, _, _ = wideband
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "power_db":
                assert abs(g[k] - w[k]) <= POWER_TOL_DB, (w["offset_hz"], k)
            else:
                assert g[k] == w[k], (w["offset_hz"], k, w[k], g[k])


def test_wideband_finds_the_carriers(wideband):
    _, got, _, _ = wideband
    hits = {r["offset_hz"] for r in got if r["is_tetra"]}
    assert set(HOT) <= hits and len(hits) <= len(HOT) + 2
    by = {r["offset_hz"]: r for r in got}
    for off in HOT:
        assert by[off]["n_frames"] > 0 and by[off]["crc_pass_rate"] > 0.5


class FakeCapture:
    """Synthetic step source: TETRA on one channel, noise elsewhere
    (tests/unit/test_scan_validate.py)."""

    def __init__(self, tetra_freq, iq):
        self.tetra_freq, self.iq, self.freq = tetra_freq, iq, 0.0
        self.rng = np.random.default_rng(5)

    def set_frequency(self, f):
        self.freq = f

    def read_samples(self, n):
        if abs(self.freq - self.tetra_freq) < 12_500:
            return self.iq[:n]
        return 0.001 * (self.rng.standard_normal(n)
                        + 1j * self.rng.standard_normal(n)).astype(
                            np.complex64)


@pytest.fixture(scope="module")
def tetra_iq():
    payloads = [golden.sds_text_payload("HELLO HELLO")] * 4
    return golden.golden_iq(payloads, fs=2.4e6, snr_db=25, seed=31)


def test_frequency_scanner_equal(tetra_iq):
    runs = []
    for mod in (jscan, tscan):
        sc = mod.FrequencyScanner(FakeCapture(392.5e6, tetra_iq),
                                  sample_rate=2.4e6)
        runs.append(sc.scan_range(392.45e6, 392.55e6, min_power=-70,
                                  min_confidence=0.4))
    want, got = runs
    assert got == want
    assert 392.5e6 in [f["frequency"] for f in got]


def test_scan_frequency_equal(tetra_iq):
    want = jscan.FrequencyScanner(FakeCapture(392.5e6, tetra_iq)
                                  ).scan_frequency(392.5e6, dwell_time=0.1)
    got = tscan.FrequencyScanner(FakeCapture(392.5e6, tetra_iq)
                                 ).scan_frequency(392.5e6, dwell_time=0.1)
    assert got == want and got["is_tetra"]


@pytest.mark.parametrize("what", ["tetra", "noise"])
def test_detector_equal(tetra_iq, what):
    rng = np.random.default_rng(12345)
    x = tetra_iq if what == "tetra" else 0.01 * (
        rng.standard_normal(100_000)
        + 1j * rng.standard_normal(100_000)).astype(np.complex64)
    want = jdet.TetraSignalDetector(sample_rate=2.4e6).analyze_signal(x)
    got = tdet.TetraSignalDetector(sample_rate=2.4e6).analyze_signal(x)
    assert got == want
    assert got["is_tetra"] == (what == "tetra")
