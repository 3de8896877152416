"""IQ sample sources: files, synthetic TETRA, RTL-SDR hardware (gated).

Equivalent of the reference capture layer (tetraear/signal/capture.py) plus
the replayable-capture formats its offline tools consume.  All sources share
one interface:

    source.open() -> bool
    source.read_samples(n) -> complex64 ndarray (may be shorter at EOF)
    source.set_frequency(f)
    source.close()
    with source: ...

so the Pipeline, scanners and tools are agnostic to where samples come from
— the same hermetic-boundary philosophy as the reference's mocked-SDR tests
(reference tests/conftest.py:70-78).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

try:  # pragma: no cover - hardware path
    from rtlsdr import RtlSdr
    RTL_SDR_AVAILABLE = True
except (ImportError, OSError):  # pragma: no cover
    RtlSdr = None
    RTL_SDR_AVAILABLE = False

# The 11 legal RTL-SDR sample rates (capture.py:83-87).
RTL_VALID_RATES = [0.225e6, 0.9e6, 1.024e6, 1.536e6, 1.8e6, 1.92e6,
                   2.048e6, 2.4e6, 2.56e6, 2.88e6, 3.2e6]


class IQSource:
    """Base source; concrete sources override _read."""

    def __init__(self, frequency: float = 400e6, sample_rate: float = 2.4e6,
                 gain="auto"):
        self.frequency = frequency
        self.sample_rate = sample_rate
        self.gain = gain

    def open(self) -> bool:
        return True

    def close(self) -> None:
        pass

    def set_frequency(self, frequency: float) -> None:
        self.frequency = frequency

    def read_samples(self, num_samples: int) -> np.ndarray:
        raise NotImplementedError

    def __enter__(self):
        if not self.open():
            raise RuntimeError(f"failed to open {type(self).__name__}")
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class FileIQSource(IQSource):
    """Replay a recorded capture.  Formats by extension:

    .cfile/.fc32/.raw  complex64 interleaved (GNU Radio style)
    .cs16/.sc16        int16 I/Q pairs, scaled to [-1, 1]
    .cu8/.iq           uint8 I/Q pairs offset 127.5 (rtl_sdr raw)
    .npy               NumPy array, complex or (N, 2) float
    """

    def __init__(self, path, sample_rate: float = 2.4e6,
                 frequency: float = 400e6, loop: bool = False):
        super().__init__(frequency=frequency, sample_rate=sample_rate)
        self.path = Path(path)
        self.loop = loop
        self._data: np.ndarray | None = None
        self._pos = 0

    def open(self) -> bool:
        if not self.path.exists():
            logger.error("capture file not found: %s", self.path)
            return False
        ext = self.path.suffix.lower()
        if ext == ".npy":
            arr = np.load(self.path)
            if np.iscomplexobj(arr):
                data = arr.astype(np.complex64)
            else:
                data = (arr[..., 0] + 1j * arr[..., 1]).astype(np.complex64)
        elif ext in (".cs16", ".sc16"):
            raw = np.fromfile(self.path, dtype=np.int16)
            data = ((raw[0::2] + 1j * raw[1::2]) / 32768.0).astype(
                np.complex64)
        elif ext in (".cu8", ".iq", ".bin"):
            raw = np.fromfile(self.path, dtype=np.uint8).astype(np.float32)
            data = (((raw[0::2] - 127.5) + 1j * (raw[1::2] - 127.5))
                    / 127.5).astype(np.complex64)
        else:  # .cfile / .fc32 / .raw / unknown -> complex64
            data = np.fromfile(self.path, dtype=np.complex64)
        self._data = data
        self._pos = 0
        logger.info("opened %s: %d samples (%.2f s @ %.2f Msps)",
                    self.path.name, len(data),
                    len(data) / self.sample_rate, self.sample_rate / 1e6)
        return True

    def read_samples(self, num_samples: int) -> np.ndarray:
        if self._data is None:
            raise RuntimeError("source not opened")
        if self._pos >= len(self._data):
            if not self.loop:
                return np.zeros(0, np.complex64)
            self._pos = 0
        end = min(self._pos + num_samples, len(self._data))
        out = self._data[self._pos:end]
        self._pos = end
        return out

    @property
    def exhausted(self) -> bool:
        return (self._data is not None and not self.loop
                and self._pos >= len(self._data))


class SyntheticTetraSource(IQSource):
    """Endless golden TETRA carrier(s): the hermetic stand-in for hardware.

    Generates CRC-valid MAC-RESOURCE slots carrying the given SDS payloads
    (round-robin), at the requested offsets/SNR.
    """

    def __init__(self, sample_rate: float = 2.4e6, offsets_hz=(0.0,),
                 payload_texts=("HELLO HELLO",), snr_db: float | None = 20,
                 frequency: float = 392.5e6, seed: int = 0,
                 voice: bool = False, voice_pitch: int = 57):
        super().__init__(frequency=frequency, sample_rate=sample_rate)
        self.offsets_hz = list(offsets_hz)
        self.payload_texts = list(payload_texts)
        self.snr_db = snr_db
        self.seed = seed
        self.voice = voice
        self.voice_pitch = voice_pitch
        self._buf = np.zeros(0, np.complex64)
        self._chunk_idx = 0

    def _voice_bits(self, seed: int) -> np.ndarray:
        """Four channel-encoded speech slots (requires the codec lib)."""
        import ctypes

        from tetraear_tpu_torch.ref import golden
        from tetraear_tpu_torch.voice import codec as vcodec
        vp = vcodec.VoiceProcessor()
        if not vp.working:
            raise RuntimeError("voice source requires the codec library")
        lib = vp._lib
        rng = np.random.default_rng(seed)
        n = 4 * 480
        exc = np.zeros(n)
        exc[::self.voice_pitch] = 1.0
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
        pcm = (y / np.max(np.abs(y)) * 8000).astype(np.int16)
        enc = lib.tetra_speech_encoder_new()
        slots = []
        try:
            for si in range(4):
                params = np.zeros((2, 138), np.int16)
                for f in range(2):
                    seg = np.ascontiguousarray(
                        pcm[si * 480 + f * 240:si * 480 + (f + 1) * 240])
                    lib.tetra_speech_encode(
                        enc,
                        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                        params[f].ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int16)))
                block = np.zeros(vcodec.CODEC_BLOCK_WORDS, np.int16)
                lib.tetra_channel_encode(
                    np.ascontiguousarray(params).ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int16)),
                    block.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
                soft = np.concatenate([block[1:115], block[116:230],
                                       block[231:345], block[346:436]])
                slots.append(golden.build_voice_slot(
                    (soft[:432] > 0).astype(np.uint8), rng=rng))
        finally:
            lib.tetra_speech_encoder_free(enc)
        return np.concatenate(slots)

    def _generate_chunk(self) -> np.ndarray:
        from tetraear_tpu_torch.ref import golden, modulator
        payloads = [golden.sds_text_payload(
            self.payload_texts[i % len(self.payload_texts)])
            for i in range(4)]
        seed = self.seed + self._chunk_idx
        self._chunk_idx += 1
        parts = []
        for off in self.offsets_hz:
            if self.voice:
                bits = self._voice_bits(seed)
            else:
                bits = golden.build_stream(payloads, seed=seed,
                                           sysinfo_every=4)
            pad = np.random.default_rng(seed + 5).integers(
                0, 2, 64).astype(np.uint8)
            parts.append(modulator.generate_carrier(
                np.concatenate([pad, bits]), fs=self.sample_rate,
                freq_offset_hz=off))
        n = min(len(p) for p in parts)
        x = np.sum([p[:n] for p in parts], axis=0).astype(np.complex64)
        if self.snr_db is not None:
            x = modulator.add_awgn(x, self.snr_db,
                                   np.random.default_rng(seed + 9))
        return x

    def read_samples(self, num_samples: int) -> np.ndarray:
        while len(self._buf) < num_samples:
            self._buf = np.concatenate([self._buf, self._generate_chunk()])
        out = self._buf[:num_samples]
        self._buf = self._buf[num_samples:]
        return out


class RTLSDRSource(IQSource):
    """RTL-SDR hardware capture (requires pyrtlsdr + librtlsdr).

    Mirrors the reference RTLCapture semantics
    (tetraear/signal/capture.py:47-210): sample-rate rounding to the 11
    legal rates, auto/numeric gain, bias-tee off, USB access-violation
    recovery advice.
    """

    def __init__(self, frequency: float = 400e6, sample_rate: float = 2.4e6,
                 gain="auto"):
        super().__init__(frequency=frequency, sample_rate=sample_rate,
                         gain=gain)
        self.sdr = None

    def open(self) -> bool:  # pragma: no cover - hardware path
        if not RTL_SDR_AVAILABLE:
            logger.error("RTL-SDR library not available")
            return False
        try:
            self.sdr = RtlSdr()
            closest = min(RTL_VALID_RATES,
                          key=lambda r: abs(r - self.sample_rate))
            if abs(closest - self.sample_rate) > 0.1e6:
                logger.warning("rounding sample rate %.3f -> %.3f MHz",
                               self.sample_rate / 1e6, closest / 1e6)
            self.sample_rate = closest
            self.sdr.sample_rate = closest
            self.sdr.center_freq = self.frequency
            if isinstance(self.gain, str) and self.gain.lower() == "auto":
                self.sdr.gain = "auto"
            else:
                self.sdr.gain = float(self.gain)
            try:
                self.sdr.set_bias_tee(False)
            except AttributeError:
                pass
            logger.info("RTL-SDR open: %.3f MHz @ %.2f Msps gain=%s",
                        self.frequency / 1e6, self.sample_rate / 1e6,
                        self.gain)
            return True
        except Exception as e:
            msg = str(e)
            logger.error("failed to open RTL-SDR: %s", e)
            if "LIBUSB_ERROR_ACCESS" in msg or "Access denied" in msg:
                logger.error("USB access problem: install WinUSB via Zadig "
                             "(Windows) or add udev rules (Linux), then "
                             "replug the device")
            return False

    def read_samples(self, num_samples: int):  # pragma: no cover
        if self.sdr is None:
            raise RuntimeError("device not opened")
        try:
            return np.asarray(self.sdr.read_samples(num_samples),
                              dtype=np.complex64)
        except Exception as e:
            if "access violation" in str(e).lower():
                logger.error("USB access violation — close other SDR apps, "
                             "replug the dongle and reopen")
            raise

    def set_frequency(self, frequency: float):  # pragma: no cover
        self.frequency = frequency
        if self.sdr is not None:
            self.sdr.center_freq = frequency

    def close(self):  # pragma: no cover
        if self.sdr is not None:
            try:
                self.sdr.close()
            except Exception:
                pass
            self.sdr = None


def write_capture(path, iq: np.ndarray) -> None:
    """Write complex64 IQ in the format implied by the extension."""
    path = Path(path)
    ext = path.suffix.lower()
    iq = np.asarray(iq, np.complex64)
    if ext == ".npy":
        np.save(path, iq)
    elif ext in (".cs16", ".sc16"):
        out = np.empty(2 * len(iq), np.int16)
        out[0::2] = np.clip(iq.real * 32767, -32768, 32767)
        out[1::2] = np.clip(iq.imag * 32767, -32768, 32767)
        out.tofile(path)
    elif ext in (".cu8", ".iq"):
        out = np.empty(2 * len(iq), np.uint8)
        out[0::2] = np.clip(np.round(iq.real * 127.5 + 127.5), 0, 255)
        out[1::2] = np.clip(np.round(iq.imag * 127.5 + 127.5), 0, 255)
        out.tofile(path)
    else:
        iq.tofile(path)


def open_source(spec: str, sample_rate: float = 2.4e6,
                frequency: float = 392.5e6, gain="auto") -> IQSource:
    """Source factory: 'rtlsdr', 'synthetic[:off1,off2,...]' or a file path."""
    if spec == "rtlsdr":
        return RTLSDRSource(frequency=frequency, sample_rate=sample_rate,
                            gain=gain)
    if spec.startswith("synthetic"):
        voice = spec.startswith("synthetic-voice")
        offsets = (0.0,)
        if ":" in spec:
            offsets = tuple(float(o) for o in spec.split(":", 1)[1].split(","))
        return SyntheticTetraSource(sample_rate=sample_rate,
                                    offsets_hz=offsets, frequency=frequency,
                                    voice=voice)
    return FileIQSource(spec, sample_rate=sample_rate, frequency=frequency)
