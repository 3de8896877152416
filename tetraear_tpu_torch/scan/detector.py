"""TETRA signal detection: is this 25 kHz channel carrying TETRA?
(the port's copy of tetraear_tpu/scan/detector.py; host numpy)

Behavioural equivalent of the reference detector
(tetraear/signal/scanner.py:24-289): band power, pi/4-DQPSK phase-cluster
confidence, 31-bit sync-pattern correlation, full decode validation and
power stability, combined into an analyze_signal verdict.

All metrics are vectorized NumPy (and trivially vmappable); the wideband
scanner (tetraear_tpu_torch.scan.scanner.WidebandScanner) evaluates them for
every channel of a capture at once instead of retuning per channel.
"""

from __future__ import annotations

import numpy as np

from tetraear_tpu_torch.frame.decoder import TetraDecoder
from tetraear_tpu_torch.ref.demod import OracleDemod


class TetraSignalDetector:
    """Single-channel TETRA-likeness tests (scanner.py:24)."""

    def __init__(self, sample_rate: float = 2.4e6, noise_floor: float = -45,
                 bottom_threshold: float = -85):
        self.sample_rate = sample_rate
        self.symbol_rate = 18_000
        self.channel_bandwidth = 25_000
        self.noise_floor = noise_floor
        self.bottom_threshold = bottom_threshold

    def calculate_power(self, samples: np.ndarray) -> float:
        """Mean power in dB (scanner.py:42-55)."""
        if samples.size == 0:
            return float(self.bottom_threshold)
        power = float(np.mean(np.abs(samples) ** 2))
        return 10.0 * np.log10(power + 1e-10)

    def detect_tetra_modulation(self, samples: np.ndarray):
        """Symbol-spaced phase-difference clustering at the pi/4-DQPSK
        transition set -> (is_tetra, confidence).

        NOTE: corrects two defects in the reference detector
        (tetraear/signal/scanner.py:57-96): (1) its expected-phase list
        spans ALL multiples of pi/4 with a +-pi/8 tolerance, which tiles
        the entire circle, so every input — including pure noise — scores
        confidence 1.0; (2) it differences consecutive raw samples at
        2.4 Msps, where phase increments are tiny regardless of
        modulation.  Here samples are decimated to ~1 symbol per step and
        only the *odd* multiples {+-pi/4, +-3pi/4} (the legal transition
        set) count; confidence is excess clustering above the 50% chance
        level.
        """
        if len(samples) < 1000:
            return False, 0.0
        down = max(1, int(round(self.sample_rate / self.symbol_rate)))
        s = samples[::down]
        if len(s) < 64:
            return False, 0.0
        s = s / (np.abs(s).max() + 1e-10)
        pd = np.diff(np.angle(s))
        pd = (pd + np.pi) % (2 * np.pi) - np.pi
        expected = np.array([-3, -1, 1, 3]) * (np.pi / 4)
        dist = np.min(np.abs(pd[:, None] - expected[None, :]), axis=1)
        frac = float(np.mean(dist < np.pi / 8))
        confidence = max(0.0, 2.0 * (frac - 0.5))
        return confidence > 0.4, confidence

    def detect_sync_pattern(self, samples: np.ndarray):
        """Training-sequence correlation on properly demodulated bits
        -> (found, max_correlation).

        Replaces the reference's quantize-raw-phases heuristic
        (scanner.py:98-147), whose 0.75 threshold is routinely exceeded by
        noise (max over ~2000 random 31-bit windows sits near 0.84).  We
        demodulate and correlate the real 22-bit TS1/TS2 words, requiring
        >=0.90 — a clean signal scores 1.0.
        """
        if len(samples) < 10_000:
            return False, 0.0
        try:
            out = OracleDemod(fs=self.sample_rate).run(samples)
            bits = np.empty(2 * len(out["symbols"]), dtype=np.uint8)
            bits[0::2] = (out["symbols"] >> 1) & 1
            bits[1::2] = out["symbols"] & 1
            from tetraear_tpu_torch.frame.decoder import sync_correlate
            corr = sync_correlate(bits)
            max_corr = float(corr.max()) if len(corr) else 0.0
            return max_corr >= 0.90, max_corr
        except Exception:
            return False, 0.0

    def validate_frames(self, samples: np.ndarray):
        """Full decode + CRC validation (scanner.py:149-202)
        -> (frames_valid, crc_pass_rate)."""
        if len(samples) < 10_000:
            return False, 0.0
        try:
            out = OracleDemod(fs=self.sample_rate).run(samples)
            demodulated = out["symbols"]
            if len(demodulated) < 255:
                return False, 0.0
            decoder = TetraDecoder(auto_decrypt=False)
            frames = decoder.decode(demodulated)
            if not frames:
                return False, 0.0
            crc_pass = 0.0
            for f in frames:
                if f.get("burst_crc") is True:
                    crc_pass += 1
                elif f.get("burst_crc") is False:
                    pass
                elif "type" in f and "number" in f:
                    crc_pass += 0.5
            crc_rate = crc_pass / max(len(frames), 1)
            return (len(frames) >= 2 and crc_rate > 0.5), crc_rate
        except Exception:
            return False, 0.0

    def check_power_stability(self, samples: np.ndarray,
                              num_windows: int = 5) -> bool:
        """Power std-dev < 10 dB across windows (scanner.py:204-231)."""
        if len(samples) < num_windows * 1000:
            return False
        w = len(samples) // num_windows
        powers = [self.calculate_power(samples[i * w:(i + 1) * w])
                  for i in range(num_windows)]
        if len(powers) > 1:
            return float(np.std(powers)) < 10.0
        return True

    def analyze_signal(self, samples: np.ndarray) -> dict:
        """Combined verdict (scanner.py:233-289): require modulation AND
        sync; frame validation overrides and boosts confidence."""
        samples = np.asarray(samples)
        power = self.calculate_power(samples)
        is_mod, mod_conf = self.detect_tetra_modulation(samples)
        has_sync, sync_corr = self.detect_sync_pattern(samples)
        frames_valid, crc_rate = self.validate_frames(samples)
        power_stable = self.check_power_stability(samples)

        if has_sync and is_mod:
            confidence = mod_conf * 0.4 + sync_corr * 0.4 + crc_rate * 0.2
        elif has_sync:
            confidence = sync_corr * 0.6
        elif is_mod:
            confidence = mod_conf * 0.5
        else:
            confidence = 0.0

        is_tetra = (is_mod and has_sync) and power_stable
        if frames_valid:
            is_tetra = True
            confidence = max(confidence, 0.7)

        return {
            "power_db": power,
            "is_tetra": is_tetra,
            "confidence": confidence,
            "modulation_confidence": mod_conf,
            "sync_detected": has_sync,
            "sync_correlation": sync_corr,
            "frames_validated": frames_valid,
            "crc_pass_rate": crc_rate,
            "power_stable": power_stable,
            "signal_present": power > self.bottom_threshold,
        }
