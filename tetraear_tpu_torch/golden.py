"""Golden multi-carrier captures for end-to-end checks of the port.

Each active carrier transmits real TETRA slots (training sequences,
CRC-protected MAC resource PDUs carrying an SDS text) through the shared
golden transmitter of ``tetraear_tpu_torch.ref``; the wideband sum gets white
noise over the whole band.  Everything is made from ``seed`` with
numpy, so the capture is the same on every machine.
"""

from __future__ import annotations

import math

import numpy as np

from tetraear_tpu_torch.ref import golden, modulator
from tetraear_tpu_torch.runtime.sources import IQSource

SLOT_BITS = 510
BIT_RATE = 36_000.0            # 18 ksym/s, 2 bits per symbol


class ArraySource(IQSource):
    """An in-memory capture as an IQSource (Pipeline.run_offline)."""

    def __init__(self, iq: np.ndarray, sample_rate: float):
        super().__init__(sample_rate=sample_rate)
        self._data = np.asarray(iq, np.complex64)
        self._pos = 0

    def read_samples(self, num_samples: int) -> np.ndarray:
        out = self._data[self._pos:self._pos + num_samples]
        self._pos += len(out)
        return out


def fleet_capture(fs: float, offsets_hz, active, n_samples: int,
                  seed: int = 0, snr_db: float = 25.0,
                  text: str = "FLEET") -> np.ndarray:
    """(n_samples,) complex64 capture at ``fs`` with carriers
    ``offsets_hz[i]`` for i in ``active`` transmitting the SDS text
    "<text> <i>" in every slot.  ``snr_db`` is the ratio of one
    carrier's power to the noise power over the whole band."""
    rng = np.random.default_rng(seed)
    n_slots = math.ceil(n_samples / fs * BIT_RATE / SLOT_BITS) + 2
    parts = []
    for ci in active:
        payloads = [golden.sds_text_payload(f"{text} {ci}")] * n_slots
        bits = np.concatenate([
            rng.integers(0, 2, 64).astype(np.uint8),
            golden.build_stream(payloads, seed=seed + int(ci))])
        iq = modulator.generate_carrier(bits, fs=fs,
                                        freq_offset_hz=offsets_hz[ci])
        parts.append(iq[:n_samples])
    x = np.sum(parts, axis=0).astype(np.complex64)
    p_sig = float(np.mean(np.abs(parts[0]) ** 2))
    sigma = math.sqrt(p_sig / 10.0 ** (snr_db / 10.0) / 2.0)
    noise = rng.standard_normal((2, n_samples)).astype(np.float32) * sigma
    return (x + noise[0] + 1j * noise[1]).astype(np.complex64)
