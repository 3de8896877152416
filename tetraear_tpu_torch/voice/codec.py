"""TETRA voice codec interface: soft-bit slots -> 8 kHz PCM.

Replaces the reference's subprocess+tempfile invocation of the ETSI
Windows executables (tetraear/audio/voice.py:73-250) with an in-process
C++ library (tetraear_tpu_torch/voice/csrc, loaded via ctypes) implementing the
ETSI TS 300 395-2 channel decoder + ACELP speech decoder.

The wire format is kept byte-identical to the reference so recorded
`tetra_frames_*.bin` dumps replay through either implementation:

  * codec block: 690 little-endian int16 words — header 0x6B21 then 689
    soft bits in [-127, 127] (voice.py:77-99);
  * soft bits laid out in the ETSI Write_Tetra_File block structure:
    positions 1-114, 116-229, 231-344, 346-435
    (tetraear/ui/modern.py:2362-2407);
  * channel-decoder output: per speech frame a BFI word + 137 int16
    parameter words, 2 frames per slot (voice.py:159-173).
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

CODEC_BLOCK_WORDS = 690
CODEC_BLOCK_BYTES = 1380
CODEC_HEADER = 0x6B21
SPEECH_FRAME_PARAMS = 137
SAMPLES_PER_SPEECH_FRAME = 240          # 30 ms at 8 kHz

_LIB_CANDIDATES = [
    # TETRAEAR_CODEC_LIB: explicit path — set by the single-file app
    # bootstrap (tools/build_exe.py), where package-relative paths
    # point inside the archive
    *([Path(os.environ["TETRAEAR_CODEC_LIB"])]
      if os.environ.get("TETRAEAR_CODEC_LIB") else []),
    Path(__file__).parent / "csrc" / "build" / "libtetracodec.so",
    Path(__file__).parent / "libtetracodec.so",
]


def _load_library():
    for p in _LIB_CANDIDATES:
        if p.exists():
            try:
                lib = ctypes.CDLL(str(p))
                lib.tetra_channel_decode.restype = ctypes.c_int
                lib.tetra_channel_decode.argtypes = [
                    ctypes.POINTER(ctypes.c_int16),   # 690-word block
                    ctypes.POINTER(ctypes.c_int16),   # out: 2*(1+137)
                ]
                lib.tetra_speech_decode.restype = ctypes.c_int
                lib.tetra_speech_decode.argtypes = [
                    ctypes.c_void_p,                  # decoder state
                    ctypes.POINTER(ctypes.c_int16),   # (1+137) params
                    ctypes.POINTER(ctypes.c_int16),   # out: 240 PCM
                ]
                lib.tetra_speech_decode_many.restype = ctypes.c_int
                lib.tetra_speech_decode_many.argtypes = [
                    ctypes.c_void_p,                  # decoder state
                    ctypes.POINTER(ctypes.c_int16),   # n x (1+137)
                    ctypes.c_int32,                   # n_frames
                    ctypes.POINTER(ctypes.c_int16),   # out: n x 240
                ]
                lib.tetra_speech_decoder_new.restype = ctypes.c_void_p
                lib.tetra_speech_decoder_free.argtypes = [ctypes.c_void_p]
                # state (de)serialization (checkpoint/resume); absent
                # from pre-round-3 builds — gated via hasattr
                if hasattr(lib, "tetra_speech_decoder_state_size"):
                    lib.tetra_speech_decoder_state_size.restype = \
                        ctypes.c_int
                    lib.tetra_speech_decoder_get_state.restype = None
                    lib.tetra_speech_decoder_get_state.argtypes = [
                        ctypes.c_void_p,
                        ctypes.POINTER(ctypes.c_int16),
                    ]
                    lib.tetra_speech_decoder_set_state.restype = None
                    lib.tetra_speech_decoder_set_state.argtypes = [
                        ctypes.c_void_p,
                        ctypes.POINTER(ctypes.c_int16),
                    ]
                lib.tetra_channel_encode.restype = ctypes.c_int
                lib.tetra_channel_encode.argtypes = [
                    ctypes.POINTER(ctypes.c_int16),   # 2*(1+137) params
                    ctypes.POINTER(ctypes.c_int16),   # out 690-word block
                ]
                lib.tetra_speech_encoder_new.restype = ctypes.c_void_p
                lib.tetra_speech_encoder_free.argtypes = [ctypes.c_void_p]
                lib.tetra_speech_encode.restype = ctypes.c_int
                lib.tetra_speech_encode.argtypes = [
                    ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int16),   # 240 PCM in
                    ctypes.POINTER(ctypes.c_int16),   # out (1+137) params
                ]
                # frame-stealing half slot (EN 300 395-2 §5): one 137-bit
                # speech frame <-> 216 soft bits
                lib.tetra_channel_decode_stolen.restype = ctypes.c_int
                lib.tetra_channel_decode_stolen.argtypes = [
                    ctypes.POINTER(ctypes.c_int16),   # 216 soft bits
                    ctypes.POINTER(ctypes.c_int16),   # out: 137 params
                ]
                lib.tetra_channel_encode_stolen.restype = ctypes.c_int
                lib.tetra_channel_encode_stolen.argtypes = [
                    ctypes.POINTER(ctypes.c_int16),   # 137 params
                    ctypes.POINTER(ctypes.c_int16),   # out: 216 soft bits
                ]
                return lib
            except OSError as e:
                logger.warning("failed to load %s: %s", p, e)
    return None


_LIB = _load_library()


def build_codec_block(soft_symbols: np.ndarray) -> bytes | None:
    """255-slot soft symbols (255, 2) float in [-1,1] -> 1380-byte codec
    block (modern.py:2302-2416 semantics, but from true soft decisions
    rather than hard bits faked to +-127)."""
    soft_symbols = np.asarray(soft_symbols)
    if soft_symbols.shape[0] < 227:
        return None
    # burst payload symbols: 0..107 and 119..226 (skip training)
    idx = np.concatenate([np.arange(0, 108), np.arange(119, 227)])
    sel = soft_symbols[idx]                       # (216, 2)
    soft_bits = sel.reshape(-1)                   # 432 soft bits, msb first
    scaled = np.clip(np.round(soft_bits * 127.0), -127, 127).astype(np.int16)

    block = np.zeros(CODEC_BLOCK_WORDS, dtype=np.int16)
    block[0] = CODEC_HEADER
    spans = [(1, 115), (116, 230), (231, 345), (346, 436)]
    pos = 0
    for lo, hi in spans:
        n = min(hi - lo, len(scaled) - pos)
        if n <= 0:
            break
        block[lo:lo + n] = scaled[pos:pos + n]
        pos += n
    return block.tobytes()


def stolen_soft_bits(soft_symbols: np.ndarray) -> np.ndarray | None:
    """255-slot soft symbols -> (216,) int16 soft bits of block 2 only.

    In a stolen slot (normal training sequence 2, frame["stolen"]) block 1
    carries STCH signalling and block 2 one half-slot-coded speech frame
    (EN 300 395-2 §5 frame stealing): payload symbols 119..226."""
    soft_symbols = np.asarray(soft_symbols)
    if soft_symbols.shape[0] < 227:
        return None
    sel = soft_symbols[119:227]                   # (108, 2)
    soft_bits = sel.reshape(-1)                   # 216 soft bits, msb first
    return np.clip(np.round(soft_bits * 127.0), -127, 127).astype(np.int16)


def bits_to_codec_block(bits: np.ndarray) -> bytes | None:
    """432 hard bits -> codec block with +-127 soft values (the fallback
    path, modern.py:2137-2194)."""
    bits = np.asarray(bits).reshape(-1)
    if len(bits) < 432:
        return None
    soft = np.where(bits[:432] > 0, 127, -127).astype(np.int16)
    block = np.zeros(CODEC_BLOCK_WORDS, dtype=np.int16)
    block[0] = CODEC_HEADER
    spans = [(1, 115), (116, 230), (231, 345), (346, 436)]
    pos = 0
    for lo, hi in spans:
        n = hi - lo
        block[lo:lo + n] = soft[pos:pos + n]
        pos += n
    return block.tobytes()


def block_soft_bits(frame_data: bytes) -> np.ndarray | None:
    """1380-byte codec block -> (432,) int16 soft bits (the batched
    device channel decoder's input layout)."""
    if len(frame_data) != CODEC_BLOCK_BYTES:
        return None
    block = np.frombuffer(frame_data, np.int16)
    if int(block[0]) & 0xFFFF != CODEC_HEADER:
        return None
    return np.concatenate([block[1:115], block[116:230],
                           block[231:345], block[346:436]])[:432]


class VoiceProcessor:
    """Decode 1380-byte codec blocks to float32 PCM at 8 kHz.

    API-compatible with the reference VoiceProcessor (voice.py:24-250):
    same `working` gate, same input validation, same near-silence rejection.
    """

    def __init__(self):
        self._lib = _LIB
        self._dec_state = None
        self.channel_decoder_available = _LIB is not None
        self.speech_decoder_available = _LIB is not None
        self.working = _LIB is not None
        if self.working:
            self._dec_state = self._lib.tetra_speech_decoder_new()
        else:
            logger.warning(
                "TETRA codec library not built; voice decoding disabled "
                "(build with: cd tetraear_tpu_torch/voice/csrc && make)")

    def __del__(self):
        if self._lib is not None and self._dec_state:
            try:
                self._lib.tetra_speech_decoder_free(self._dec_state)
            except Exception:
                pass

    # -- state (de)serialization (checkpoint/resume) --------------------

    @property
    def stateful(self) -> bool:
        """True when the library supports decoder-state snapshots."""
        return (self.working
                and hasattr(self._lib, "tetra_speech_decoder_state_size"))

    def state_bytes(self) -> bytes | None:
        """Snapshot of the LPC/excitation decoder memory, or None when
        unavailable (no codec / pre-round-3 .so)."""
        if not self.stateful:
            return None
        n = self._lib.tetra_speech_decoder_state_size() // 2
        buf = np.zeros(n, np.int16)
        self._lib.tetra_speech_decoder_get_state(
            self._dec_state,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        return buf.tobytes()

    def set_state_bytes(self, data: bytes) -> None:
        if not self.stateful:
            return
        want = self._lib.tetra_speech_decoder_state_size()
        if len(data) != want:
            raise ValueError(f"decoder state is {len(data)} bytes, "
                             f"library expects {want}")
        buf = np.frombuffer(data, np.int16).copy()
        self._lib.tetra_speech_decoder_set_state(
            self._dec_state,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))

    def channel_decode(self, frame_data: bytes) -> np.ndarray | None:
        """690-word block -> (2, 1+137) int16 [BFI, params...] per frame."""
        if not self.working:
            return None
        inp = np.frombuffer(frame_data, dtype=np.int16).copy()
        out = np.zeros(2 * (1 + SPEECH_FRAME_PARAMS), dtype=np.int16)
        rc = self._lib.tetra_channel_decode(
            inp.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        if rc != 0:
            logger.debug("channel decode failed rc=%d", rc)
            return None
        return out.reshape(2, 1 + SPEECH_FRAME_PARAMS)

    def channel_decode_stolen(self, soft216: np.ndarray) -> np.ndarray | None:
        """(216,) soft bits of a stolen slot's block 2 -> (2, 1+137) params.

        Frame 0 (the stolen half) is emitted as BFI=1 all-zero so the
        speech decoder's frame-substitution concealment keeps the 60 ms
        slot timing; frame 1 is the half-slot channel decode
        (tetra_channel_decode_stolen, EN 300 395-2 §5)."""
        if not self.working:
            return None
        soft = np.ascontiguousarray(np.asarray(soft216, np.int16)[:216])
        if soft.shape[0] != 216:
            return None
        params = np.zeros(SPEECH_FRAME_PARAMS, dtype=np.int16)
        rc = self._lib.tetra_channel_decode_stolen(
            soft.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            params.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        out = np.zeros((2, 1 + SPEECH_FRAME_PARAMS), np.int16)
        out[0, 0] = 1                     # stolen frame: conceal
        out[1, 0] = 1 if rc != 0 else 0   # BFI from the half-slot CRC
        out[1, 1:] = params
        return out

    def decode_params(self, frames: np.ndarray) -> np.ndarray:
        """(N, 1+137) [BFI, params...] -> float32 PCM (speech synthesis
        half; channel decoding already done, e.g. on device).  One
        foreign call for all N frames (tetra_speech_decode_many); a
        failing frame aborts with empty audio and the decoder state
        advanced exactly as the former per-frame loop left it."""
        if not self.working:
            return np.zeros(0, np.float32)
        fr = np.ascontiguousarray(np.asarray(frames, np.int16))
        out = np.zeros((len(fr), SAMPLES_PER_SPEECH_FRAME), np.int16)
        ptr = ctypes.POINTER(ctypes.c_int16)
        rc = self._lib.tetra_speech_decode_many(
            self._dec_state, fr.ctypes.data_as(ptr), len(fr),
            out.ctypes.data_as(ptr))
        if rc != 0:
            logger.debug("speech decode failed rc=%d", rc)
            return np.zeros(0, np.float32)
        audio = out.reshape(-1).astype(np.float32) / 32768.0
        if audio.size and float(np.max(np.abs(audio))) < 1e-5:
            # near-silent output == decode failure (voice.py:223-232)
            return np.zeros(0, np.float32)
        return audio

    def decode_params_many(self, slots: np.ndarray) -> list:
        """(M, 2, 1+137) slot params -> list of M per-slot float32 PCM
        arrays (480 samples each, empty on a failed/near-silent slot).

        The whole run is ONE foreign call (tetra_speech_decode_many),
        so the GIL stays released throughout — the per-frame ctypes
        round trips made threaded per-carrier synthesis SLOWER than
        sequential (GIL convoy; api._synth_voice_parallel).  Failure
        semantics match the former per-slot loop exactly: a failing
        frame voids its slot's audio, skips the slot's remaining
        frame(s) without advancing the decoder through them, and
        synthesis resumes at the next slot; the near-silence rejection
        (voice.py:223-232) applies per slot."""
        slots = np.ascontiguousarray(np.asarray(slots, np.int16))
        m = len(slots)
        if not self.working or not m:
            return [np.zeros(0, np.float32)] * m
        out = np.zeros((m, 2, SAMPLES_PER_SPEECH_FRAME), np.int16)
        ok = np.ones(m, bool)
        ptr = ctypes.POINTER(ctypes.c_int16)
        s = 0
        while s < m:
            rc = self._lib.tetra_speech_decode_many(
                self._dec_state, slots[s:].ctypes.data_as(ptr),
                2 * (m - s), out[s:].ctypes.data_as(ptr))
            if rc == 0:
                break
            if rc < 0:                         # bad handle/args: nothing
                logger.debug("speech decode rejected rc=%d", rc)
                ok[s:] = False                 # decoded at all — void the
                break                          # rest, never re-issue
            bad = s + (rc - 1) // 2            # slot of the failed frame
            logger.debug("speech decode failed at slot %d", bad)
            ok[bad] = False
            s = bad + 1
        audio = out.reshape(m, -1).astype(np.float32) / 32768.0
        res = []
        for i in range(m):
            a = audio[i]
            if not ok[i] or float(np.max(np.abs(a))) < 1e-5:
                # near-silent output == decode failure (voice.py:223-232)
                res.append(np.zeros(0, np.float32))
            else:
                res.append(a)
        return res

    def decode_frame(self, frame_data: bytes) -> np.ndarray:
        """1380-byte soft-bit block -> float32 PCM in [-1, 1]
        (voice.py:73-250 semantics, no subprocess, no temp files)."""
        if not self.working or not frame_data:
            return np.zeros(0, np.float32)
        if len(frame_data) != CODEC_BLOCK_BYTES:
            logger.debug("invalid frame size: %d", len(frame_data))
            return np.zeros(0, np.float32)
        header = struct.unpack("<H", frame_data[0:2])[0]
        if header != CODEC_HEADER:
            logger.debug("invalid header: 0x%04X", header)
            return np.zeros(0, np.float32)

        frames = self.channel_decode(frame_data)
        if frames is None:
            return np.zeros(0, np.float32)
        return self.decode_params(frames)
