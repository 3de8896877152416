"""Golden multi-carrier captures for end-to-end checks of the port.

Each active carrier transmits real TETRA slots (training sequences,
CRC-protected MAC resource PDUs carrying an SDS text) through the shared
golden transmitter of ``tetraear_tpu_torch.ref``; carriers given a
(cipher, key) pair carry an SDS text TEA-encrypted (built as
tests/integration/test_fleet_mixed.py builds its TEA1 carrier, with the
MAC encryption mode of the cipher); the wideband sum gets white noise
over the whole band.  Carriers given to ``voice`` carry speech instead:
every slot a traffic slot with two ACELP frames, channel-coded by the
port's copy of the ETSI codec (voice_stream), every Nth slot stolen
where asked.  Everything is made from ``seed`` with numpy, so the
capture is the same on every machine; the carriers are modulated on a
thread pool (numpy's large operations release the interpreter lock).
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
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


def speech(n_slots: int, pitch: int = 57, seed: int = 0) -> np.ndarray:
    """(n_slots * 480,) int16 voiced speech stand-in: a pulse train of
    period ``pitch`` with a little noise through a resonant all-pole
    filter (the signal of tests/codec/test_voice_rf.py)."""
    rng = np.random.default_rng(seed)
    n = n_slots * 480
    exc = np.zeros(n)
    exc[::pitch] = 1.0
    exc += 0.05 * rng.standard_normal(n)
    y = np.zeros(n)
    for i in range(n):
        y[i] = exc[i]
        if i > 0:
            y[i] += 1.2 * y[i - 1]
        if i > 1:
            y[i] += -0.8 * y[i - 2]
        if i > 2:
            y[i] += 0.3 * y[i - 3]
    return (y / np.max(np.abs(y)) * 8000).astype(np.int16)


_HEADER_FLIP: dict = {}        # coded bit i < 4 -> (frame, param word)
_HEADER_LOCK = threading.Lock()  # carriers are made on a thread pool


def _coded_bits(lib, params: np.ndarray) -> np.ndarray:
    """(2, 138) [BFI, 137 params] -> the slot's 432 coded bits."""
    ptr = ctypes.POINTER(ctypes.c_int16)
    block = np.zeros(690, np.int16)
    lib.tetra_channel_encode(np.ascontiguousarray(params).ctypes.data_as(
        ptr), block.ctypes.data_as(ptr))
    soft = np.concatenate([block[1:115], block[116:230], block[231:345],
                           block[346:436]])
    return (soft[:432] > 0).astype(np.uint8)


def _header_flips(lib) -> dict:
    """The parameter bit behind each of the slot's first four coded bits:
    they are sent uncoded (class 0), so one parameter bit flips exactly
    one of them."""
    with _HEADER_LOCK:
        if not _HEADER_FLIP:
            zero = _coded_bits(lib, np.zeros((2, 138), np.int16))
            for f in range(2):
                for w in range(1, 138):
                    p = np.zeros((2, 138), np.int16)
                    p[f, w] = 1
                    d = np.nonzero(_coded_bits(lib, p) != zero)[0]
                    if len(d) == 1 and d[0] < 4:
                        _HEADER_FLIP[int(d[0])] = (f, w)
        return _HEADER_FLIP


def voice_stream(pcm: np.ndarray, stolen_every: int = 0,
                 seed: int = 0) -> tuple:
    """Speech -> (the traffic slots' bits, (n_slots, 2, 138) int16 the
    channel decoder's expected output a slot: [BFI, 137 params] of both
    frames).

    As ref.golden.golden_voice_iq: two ACELP frames a slot, channel-coded
    into a voice slot (a bit is sent as 1 where the coded soft value is
    positive); with ``stolen_every`` > 0 every Nth slot is stolen
    (its second frame half-slot-coded, its first given as BFI 1 and zero
    parameters, as the stolen-slot decoder returns it).  A voice slot's
    first four bits are forced to a MAC-FRAG header (build_voice_slot);
    the frame's class-0 parameter bits behind them are set to match, so
    that the sent slot is exactly the coding of the returned
    parameters."""
    from tetraear_tpu_torch import native
    lib = native.codec()._LIB
    flips = _header_flips(lib)
    ptr = ctypes.POINTER(ctypes.c_int16)
    rng = np.random.default_rng(seed + 99)
    enc = lib.tetra_speech_encoder_new()
    slots, expect = [], []
    try:
        pcm = np.asarray(pcm, np.int16)
        for si in range(len(pcm) // 480):
            params = np.zeros((2, 138), np.int16)
            for f in range(2):
                seg = np.ascontiguousarray(
                    pcm[si * 480 + f * 240: si * 480 + (f + 1) * 240])
                lib.tetra_speech_encode(enc, seg.ctypes.data_as(ptr),
                                        params[f].ctypes.data_as(ptr))
            if stolen_every and si % stolen_every == stolen_every - 1:
                soft216 = np.zeros(216, np.int16)
                lib.tetra_channel_encode_stolen(
                    np.ascontiguousarray(params[1, 1:]).ctypes.data_as(ptr),
                    soft216.ctypes.data_as(ptr))
                # the sign convention of the full slot below, under which
                # the receiver's soft bits match the encoder's (the JAX
                # package's golden_voice_iq sends this half inverted, and
                # its stolen frames decode as bad frames)
                slots.append(golden.build_stolen_voice_slot(
                    (soft216 > 0).astype(np.uint8), rng=rng))
                params[0] = 0
                params[0, 0] = 1
                expect.append(params)
                continue
            coded = _coded_bits(lib, params)
            for i, want in enumerate((0, 1, 0, 0)):
                if coded[i] != want:
                    f, w = flips[i]
                    params[f, w] ^= 1
            coded = _coded_bits(lib, params)
            slot = golden.build_voice_slot(coded, rng=rng)
            assert np.array_equal(slot[:216], coded[:216])
            slots.append(slot)
            expect.append(params)
    finally:
        lib.tetra_speech_encoder_free(enc)
    return np.concatenate(slots), np.stack(expect)


def fleet_capture(fs: float, offsets_hz, active, n_samples: int,
                  seed: int = 0, snr_db: float = 25.0,
                  text: str = "FLEET", encrypted=None, voice=None):
    """(n_samples,) complex64 capture at ``fs`` with carriers
    ``offsets_hz[i]`` for i in ``active`` transmitting the SDS text
    "<text> <i>" in every slot, and each carrier i of ``encrypted`` (a
    map from carrier to (cipher, key): "TEA1" and a 10-byte key, or
    "TEA2" / "TEA3" and 16 bytes) ``secret_text(i)`` encrypted in every
    slot.  ``snr_db`` is the ratio of one carrier's power to
    the noise power over the whole band.

    ``voice``, a map from carrier to ``stolen_every``, puts speech on
    those carriers (voice_stream; pitch 40 + i % 30 on carrier i).  Then
    the result is (capture, {carrier: (n_slots, 2, 138) expected channel
    decoder output a slot}), and slot s of a carrier starts at symbol
    ``VOICE_HEAD_SYMS + 255 * s`` of its stream."""
    rng = np.random.default_rng(seed)
    n_slots = math.ceil(n_samples / fs * BIT_RATE / SLOT_BITS) + 2
    encrypted = dict(encrypted or {})
    voiced = dict(voice or {})
    carriers = list(active) + sorted(encrypted) + sorted(voiced)
    # each carrier's 64 leading random bits, drawn in carrier order
    heads = [rng.integers(0, 2, 64).astype(np.uint8) for _ in carriers]
    params = {}

    def carrier_iq(ci, head):
        if ci in voiced:
            stream, params[ci] = voice_stream(
                speech(n_slots, pitch=40 + int(ci) % 30, seed=int(ci)),
                voiced[ci], seed=seed + int(ci))
        elif ci in encrypted:
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
    iq = (x + noise[0] + 1j * noise[1]).astype(np.complex64)
    return (iq, params) if voice is not None else iq


VOICE_HEAD_SYMS = 32           # fleet_capture's 64 leading bits
