"""Recording + playback controller (Qt-free).

The logic behind the GUI's REC button and Monitor-Audio checkbox
(tetraear/ui/modern.py:4049-4194): continuous WAV recording of decoded
voice with silent-file deletion, optional MP3 export on stop, and live
playback through sounddevice when available — all injectable/testable
without Qt or an audio device.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

VOICE_RATE = 8000


def _default_player():
    """Best-effort live playback sink; None when sounddevice is absent
    (headless/CI), mirroring the reference's optional dependency."""
    try:  # pragma: no cover - needs an audio device
        import sounddevice as sd

        stream = sd.OutputStream(samplerate=VOICE_RATE, channels=1,
                                 dtype="float32")
        stream.start()
        return lambda audio: stream.write(
            np.asarray(audio, np.float32).reshape(-1, 1))
    except Exception as e:
        logger.debug("live playback unavailable: %s", e)
        return None


class RecordingController:
    """REC state machine: feed() routes voice PCM to the active WAV
    recorder and the live player."""

    def __init__(self, records_dir, export_mp3: bool = False,
                 delete_silent: bool = True, player=None,
                 max_recordings: int | None = None):
        self.records_dir = Path(records_dir)
        self.export_mp3 = export_mp3
        self.delete_silent = delete_silent
        self.max_recordings = max_recordings
        self._player = player
        self._recorder = None
        self.monitor = False
        self.recordings: list = []      # finished (wav_path, mp3_path)
        self._seq = 0

    @property
    def recording(self) -> bool:
        return self._recorder is not None

    def start(self) -> Path:
        from tetraear_tpu_torch.voice.export import WavRecorder
        if self._recorder is not None:
            return self._recorder.path
        ts = time.strftime("%Y%m%d_%H%M%S")
        self._seq += 1
        path = self.records_dir / f"rec_{ts}_{self._seq:03d}.wav"
        self._recorder = WavRecorder(
            path, sample_rate=VOICE_RATE,
            delete_if_silent=self.delete_silent)
        logger.info("recording to %s", path)
        return path

    def stop(self) -> Path | None:
        """Close the WAV; returns the kept path (None if deleted-silent).
        Exports MP3 when configured and ffmpeg is present."""
        if self._recorder is None:
            return None
        path = self._recorder.close()
        self._recorder = None
        mp3 = None
        if path is not None and self.export_mp3:
            from tetraear_tpu_torch.voice.export import wav_to_mp3
            try:
                mp3 = wav_to_mp3(path)
            except Exception as e:  # ffmpeg missing: keep the WAV
                logger.warning("mp3 export failed: %s", e)
        if path is not None:
            self.recordings.append((path, mp3))
            self._prune()
        return path

    def _prune(self) -> None:
        """Keep at most max_recordings newest files (the reference's
        'Max Recordings' setting): delete the oldest finished WAV/MP3
        pairs beyond the limit."""
        if not self.max_recordings or self.max_recordings <= 0:
            return
        while len(self.recordings) > self.max_recordings:
            wav, mp3 = self.recordings.pop(0)
            for f in (wav, mp3):
                if f is None:
                    continue
                try:
                    Path(f).unlink(missing_ok=True)
                except OSError as e:
                    logger.warning("prune failed for %s: %s", f, e)

    def set_monitor(self, enabled: bool) -> None:
        self.monitor = bool(enabled)
        if enabled and self._player is None:
            self._player = _default_player()

    def feed(self, audio: np.ndarray) -> None:
        """Voice PCM callback (Pipeline on_audio)."""
        if self._recorder is not None:
            self._recorder.write(np.asarray(audio, np.float32))
        if self.monitor and self._player is not None:
            try:
                self._player(audio)
            except Exception as e:  # device unplugged etc.
                logger.debug("playback error: %s", e)
                self._player = None

    def close(self) -> None:
        self.stop()


class RawFMRecorder:
    """48 kHz WAV sink for the raw-FM monitoring path (the reference's
    Raw FM checkbox, modern.py:2040-2061 + 2258-2300): receives the
    Pipeline's input-rate FM-discriminator audio (PipelineConfig.raw_fm
    -> on_raw_audio) and streams it through a stateful polyphase
    resampler to AUDIO_RATE before writing."""

    def __init__(self, records_dir, fs: float,
                 audio_rate: float = 48_000.0):
        from fractions import Fraction
        from tetraear_tpu_torch.dsp import design
        from tetraear_tpu_torch.ref import polyphase
        self._polyphase = polyphase
        frac = Fraction(int(round(audio_rate)), int(round(fs)))
        up, down = frac.numerator, frac.denominator
        h = design.kaiser_lowpass(min(15_000.0, audio_rate * 0.4),
                                  audio_rate * 0.1, fs * up,
                                  atten_db=50.0)
        self._st = design.ResampleStage(
            up=up, down=down, taps=tuple((h * up).astype(np.float32)))
        self._hist = np.zeros(polyphase.stage_history_len(self._st),
                              np.complex64)
        self._pending = np.zeros(0, np.float32)
        self.records_dir = Path(records_dir)
        self.audio_rate = audio_rate
        self._down = down
        self._rec = None

    @property
    def recording(self) -> bool:
        return self._rec is not None

    def start(self) -> Path:
        from tetraear_tpu_torch.voice.export import WavRecorder
        if self._rec is not None:
            return self._rec.path
        ts = time.strftime("%Y%m%d_%H%M%S")
        path = self.records_dir / f"rawfm_{ts}.wav"
        self._rec = WavRecorder(path, sample_rate=int(self.audio_rate),
                                delete_if_silent=False)
        logger.info("raw FM recording to %s", path)
        return path

    def feed(self, audio: np.ndarray) -> None:
        """Input-rate float32 FM audio (Pipeline on_raw_audio)."""
        if self._rec is None:
            return
        buf = np.concatenate([self._pending,
                              np.asarray(audio, np.float32)])
        n = len(buf) - len(buf) % self._down
        self._pending = buf[n:]
        if n == 0:
            return
        y, self._hist = self._polyphase.stage_apply(
            self._st, buf[:n].astype(np.complex64), self._hist)
        self._rec.write(y.real.astype(np.float32))

    def stop(self) -> Path | None:
        if self._rec is None:
            return None
        path = self._rec.close()
        self._rec = None
        return path
