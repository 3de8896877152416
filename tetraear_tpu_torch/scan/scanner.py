"""Frequency scanning: per-step sweeps and one-shot wideband channel maps
(tetraear_tpu/scan/scanner.py).

Two scanners:

  * FrequencyScanner — API-compatible with the reference
    (tetraear/signal/scanner.py:292-554): retune + dwell + analyze per
    25 kHz step, Poland presets, result table.  Works against any capture
    object exposing set_frequency/read_samples (hardware or synthetic).

  * WidebandScanner — the accelerator design: ONE capture covers fs/25
    kHz channels; the carrier bank demodulates all of them simultaneously
    and every channel is scored (power, sync rate, CRC) in a single
    batched pass.  The bank runs on the card unless ``scan`` is given
    ``device="cpu"``; its FFT channelizer launches ``band_synth_y``
    there.  A 2.4 Msps capture scans 96 channels in one shot instead of 96
    retune+dwell cycles (~30-50 s of dwell time in the reference).
"""

from __future__ import annotations

import logging
import time

import numpy as np

from tetraear_tpu_torch.frame import decoder as dec_mod
from tetraear_tpu_torch.scan.detector import TetraSignalDetector

logger = logging.getLogger(__name__)


class FrequencyScanner:
    """Step scanner, reference-compatible (scanner.py:292)."""

    POLAND_RANGES = [
        (390.0, 395.0),
        (380.0, 385.0),
        (410.0, 430.0),
    ]
    CHANNEL_SPACING = 25.0  # kHz

    def __init__(self, rtl_capture, sample_rate: float = 2.4e6,
                 scan_step: float = 25e3, noise_floor: float = -45,
                 bottom_threshold: float = -85):
        self.capture = rtl_capture
        self.sample_rate = sample_rate
        self.scan_step = scan_step
        self.noise_floor = noise_floor
        self.bottom_threshold = bottom_threshold
        self.detector = TetraSignalDetector(
            sample_rate, noise_floor=noise_floor,
            bottom_threshold=bottom_threshold)
        self.found_channels: list = []

    def scan_frequency(self, frequency: float,
                       dwell_time: float = 0.5) -> dict:
        """Tune, dwell, capture <=256k samples, analyze
        (scanner.py:325-381)."""
        try:
            if hasattr(self.capture, "sdr") and self.capture.sdr:
                self.capture.sdr.center_freq = frequency
            elif hasattr(self.capture, "set_frequency"):
                self.capture.set_frequency(frequency)
            time.sleep(0.05)
            num_samples = min(int(self.sample_rate * dwell_time), 256 * 1024)
            try:
                samples = self.capture.read_samples(num_samples)
            except Exception as e:
                logger.debug("read error at %.3f MHz: %s",
                             frequency / 1e6, e)
                samples = np.zeros(0, dtype=np.complex64)
            if len(samples) > 100:
                analysis = self.detector.analyze_signal(samples)
            else:
                analysis = {"power_db": -100, "is_tetra": False,
                            "confidence": 0.0, "signal_present": False}
            analysis["frequency"] = frequency
            analysis["frequency_mhz"] = frequency / 1e6
            return analysis
        except Exception as e:
            return {"frequency": frequency, "frequency_mhz": frequency / 1e6,
                    "power_db": -100, "is_tetra": False, "confidence": 0.0,
                    "signal_present": False, "error": str(e)}

    def scan_range(self, start_freq: float, end_freq: float,
                   min_power: float = -70,
                   min_confidence: float = 0.4) -> list:
        """Sweep [start, end] in scan_step steps (scanner.py:383-445)."""
        logger.info("Scanning range: %.3f - %.3f MHz",
                    start_freq / 1e6, end_freq / 1e6)
        found = []
        num_steps = int((end_freq - start_freq) / self.scan_step)
        for step in range(num_steps + 1):
            freq = start_freq + step * self.scan_step
            if freq > end_freq:
                break
            result = self.scan_frequency(freq, dwell_time=0.3)
            if (result.get("is_tetra")
                    and result.get("power_db", -100) > min_power
                    and result.get("confidence", 0) > min_confidence
                    and result.get("sync_detected")
                    and result.get("power_stable")):
                found.append(result)
                logger.info("Found TETRA at %.3f MHz (%.1f dB, conf %.2f)",
                            freq / 1e6, result["power_db"],
                            result["confidence"])
        return found

    def scan_around_392_5(self, range_mhz: float = 2.5,
                          min_power: float = -70,
                          min_confidence: float = 0.4) -> list:
        center = 392.5e6
        found = self.scan_range(center - range_mhz * 1e6 / 2,
                                center + range_mhz * 1e6 / 2,
                                min_power, min_confidence)
        self.found_channels = found
        return found

    def scan_poland(self, min_power: float = -70,
                    min_confidence: float = 0.4) -> list:
        all_found = []
        scanned = set()
        for start_mhz, end_mhz in [(390.0, 395.0)] + self.POLAND_RANGES:
            if (start_mhz, end_mhz) in scanned:
                continue
            scanned.add((start_mhz, end_mhz))
            all_found.extend(self.scan_range(start_mhz * 1e6, end_mhz * 1e6,
                                             min_power, min_confidence))
        all_found.sort(key=lambda r: r["frequency"])
        self.found_channels = all_found
        return all_found

    def get_found_channels(self) -> list:
        return self.found_channels

    def print_found_channels(self) -> None:
        if not self.found_channels:
            logger.info("No TETRA channels found")
            return
        logger.info("=" * 72)
        logger.info("%-18s %-12s %-12s %-8s", "Frequency (MHz)",
                    "Power (dB)", "Confidence", "Sync")
        for ch in self.found_channels:
            logger.info("%15.3f    %8.1f    %8.2f    %6s",
                        ch["frequency_mhz"], ch["power_db"],
                        ch["confidence"],
                        "Yes" if ch.get("sync_detected") else "No")
        logger.info("=" * 72)


class WidebandScanner:
    """One-shot all-channel scan of a wideband capture (on the card).

    Channelizes every 25 kHz channel in the capture with the batched
    carrier bank and scores each by band power, sync correlation and
    CRC-checked frame decode — the same evidence the step scanner gathers,
    minus the per-channel retune/dwell.
    """

    def __init__(self, fs: float = 2.4e6, channel_spacing: float = 25e3,
                 guard_channels: int = 2):
        self.fs = float(fs)
        self.spacing = channel_spacing
        n_ch = int(fs // channel_spacing) - 2 * guard_channels
        half = n_ch // 2
        self.offsets = np.array(
            [(i - half) * channel_spacing + channel_spacing / 2
             for i in range(n_ch)])
        self.n_channels = n_ch

    def scan(self, iq: np.ndarray, center_freq_hz: float = 0.0,
             min_power: float = -70, min_confidence: float = 0.4,
             device=None) -> list:
        """Score every channel of one capture; returns reference-style
        result dicts sorted by frequency.

        ``min_power`` (dBFS in the 25 kHz channel) and ``min_confidence``
        gate the ``is_tetra`` verdict the same way the step scanner's
        accept test does (reference scanner.py:421-425); all channels are
        still returned so callers can inspect the rejects.  ``device``
        (None: the card) is where the carrier bank runs."""
        from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod

        iq = np.asarray(iq, np.complex64)
        # FFT channelizer when the capture covers at least one block
        # (one wideband FFT for all channels); conv frontend for short
        # dwells
        bank = CarrierBankDemod(fs=self.fs, freqs_hz=self.offsets,
                                frontend="fft")
        if len(iq) < bank.block_len:
            bank = CarrierBankDemod(fs=self.fs, freqs_hz=self.offsets,
                                    block_len=self._block_len(len(iq)))
        out = bank.run(iq, device=device)

        # per-channel band power from the channelized baseband (after the
        # channel-select filter the per-channel stream is clean)
        results = []
        for ci, off in enumerate(self.offsets):
            syms = out["symbols"][ci]
            bits = np.empty(2 * len(syms), dtype=np.uint8)
            bits[0::2] = (syms >> 1) & 1
            bits[1::2] = syms & 1
            corr = dec_mod.sync_correlate(bits)
            max_corr = float(corr.max()) if len(corr) else 0.0
            positions = dec_mod.greedy_positions(corr, 0.90)
            decoder = dec_mod.TetraDecoder(auto_decrypt=False)
            frames = decoder.decode(syms) if max_corr >= 0.75 else []
            crc_rate = (float(np.mean([f.get("burst_crc", False)
                                       for f in frames]))
                        if frames else 0.0)
            # real channelized band power (per-carrier mean |baseband|^2
            # after the channel-select filter), not the unit-normalized
            # soft bits which read ~-3 dB for signal and noise alike
            power_db = float(10 * np.log10(out["power"][ci] + 1e-12))
            confidence = 0.4 * max_corr + 0.4 * crc_rate + \
                0.2 * min(1.0, len(positions) / 4.0)
            results.append({
                "frequency": center_freq_hz + off,
                "frequency_mhz": (center_freq_hz + off) / 1e6,
                "offset_hz": float(off),
                "power_db": float(power_db),
                "is_tetra": (bool(frames) and crc_rate > 0.5
                             and power_db > min_power
                             and confidence >= min_confidence),
                "confidence": float(confidence),
                "sync_detected": max_corr >= 0.90,
                "sync_correlation": max_corr,
                "sync_count": len(positions),
                "frames_validated": bool(frames) and crc_rate > 0.5,
                "crc_pass_rate": crc_rate,
                "n_frames": len(frames),
            })
        return results

    def _block_len(self, n: int) -> int:
        # one block covering the whole capture, rounded to the granularity
        from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
        probe = CarrierBankDemod(fs=self.fs, freqs_hz=[0.0])
        gran = probe.granularity
        return max(gran, (min(n, 512 * 1024) // gran) * gran)
