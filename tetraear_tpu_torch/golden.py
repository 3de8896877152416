"""Golden multi-carrier captures for end-to-end checks of the port.

Each active carrier transmits real TETRA slots (training sequences,
CRC-protected MAC resource PDUs carrying an SDS text) through the shared
golden transmitter of ``tetraear_tpu_torch.ref``; carriers given a
(cipher, key) pair carry an SDS text TEA-encrypted (built as
tests/integration/test_fleet_mixed.py builds its TEA1 carrier, with the
MAC encryption mode of the cipher); the wideband sum gets white noise
over the whole band.  Everything is made from ``seed`` with numpy, so
the capture is the same on every machine; the carriers are modulated on
a thread pool (numpy's large operations release the interpreter lock).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tetraear_tpu_torch.crypto.tea import TEADecryptor
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


def secret_text(ci: int) -> bytes:
    """The plaintext an encrypted carrier ``ci`` sends: an SDS text PDU
    ("\\x82" + "SECRET <ci>"), zero-padded to whole 8-byte blocks (at
    most 16 bytes, the MAC length field's room before the CRC)."""
    msg = b"\x82" + f"SECRET {ci}".encode()
    return msg + b"\x00" * (-len(msg) % 8)


# MAC encryption mode a cipher is announced with (frame/decoder.py:
# 1 SCK -> TEA1, 2 DCK -> TEA2, 3 -> TEA3); the decoder tries that
# family's keys first
ENC_MODE = {"TEA1": 1, "TEA2": 2, "TEA3": 3}


def encrypted_stream(ci: int, cipher: str, key: bytes, n_slots: int,
                     seed: int) -> np.ndarray:
    """n_slots golden slots whose MAC resource PDU carries
    ``secret_text(ci)`` TEA-encrypted with ``key``, announced with the
    cipher's encryption mode (ENC_MODE)."""
    data = TEADecryptor(key, cipher).encrypt(secret_text(ci))
    rng = np.random.default_rng(seed)
    return np.concatenate([
        golden.build_slot(golden.build_mac_resource_data_bits(
            data, enc_mode=ENC_MODE[cipher], rng=rng), rng=rng)
        for _ in range(n_slots)])


def fleet_capture(fs: float, offsets_hz, active, n_samples: int,
                  seed: int = 0, snr_db: float = 25.0,
                  text: str = "FLEET", encrypted=None) -> np.ndarray:
    """(n_samples,) complex64 capture at ``fs`` with carriers
    ``offsets_hz[i]`` for i in ``active`` transmitting the SDS text
    "<text> <i>" in every slot, and each carrier i of ``encrypted`` (a
    map from carrier to (cipher, key): "TEA1" and a 10-byte key, or
    "TEA2" / "TEA3" and 16 bytes) ``secret_text(i)`` encrypted in every
    slot.  ``snr_db`` is the ratio of one carrier's power to
    the noise power over the whole band."""
    rng = np.random.default_rng(seed)
    n_slots = math.ceil(n_samples / fs * BIT_RATE / SLOT_BITS) + 2
    encrypted = dict(encrypted or {})
    carriers = list(active) + sorted(encrypted)
    # each carrier's 64 leading random bits, drawn in carrier order
    heads = [rng.integers(0, 2, 64).astype(np.uint8) for _ in carriers]

    def carrier_iq(ci, head):
        if ci in encrypted:
            cipher, key = encrypted[ci]
            stream = encrypted_stream(int(ci), cipher, key, n_slots,
                                      seed + int(ci))
        else:
            payloads = [golden.sds_text_payload(f"{text} {ci}")] * n_slots
            stream = golden.build_stream(payloads, seed=seed + int(ci))
        iq = modulator.generate_carrier(np.concatenate([head, stream]),
                                        fs=fs, freq_offset_hz=offsets_hz[ci])
        return iq[:n_samples]

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(carrier_iq, carriers, heads))
    x = np.sum(parts, axis=0).astype(np.complex64)
    p_sig = float(np.mean(np.abs(parts[0]) ** 2))
    sigma = math.sqrt(p_sig / 10.0 ** (snr_db / 10.0) / 2.0)
    noise = rng.standard_normal((2, n_samples)).astype(np.float32) * sigma
    return (x + noise[0] + 1j * noise[1]).astype(np.complex64)
