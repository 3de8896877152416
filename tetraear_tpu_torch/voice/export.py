"""Audio output: WAV writing, MP3 export (ffmpeg, gated), call grouping.

Equivalents of the reference's audio plumbing:
  * wav_to_mp3 / find_ffmpeg (tetraear/audio/export.py:19-66)
  * continuous per-call WAV recording at 8 kHz (modern.py:4073-4154)
  * VoiceAccumulator: groups PCM per talkgroup, finalizes a call after a
    3 s gap (listen_clear.py:65-106)
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import time
import wave
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

VOICE_SAMPLE_RATE = 8000


def write_wav(path, audio: np.ndarray,
              sample_rate: int = VOICE_SAMPLE_RATE) -> None:
    """float32 [-1,1] or int16 PCM -> mono 16-bit WAV."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(audio.tobytes())


def read_wav(path) -> tuple:
    with wave.open(str(path), "rb") as wf:
        rate = wf.getframerate()
        data = np.frombuffer(wf.readframes(wf.getnframes()), dtype=np.int16)
    return data, rate


def find_ffmpeg() -> str | None:
    """Locate ffmpeg on PATH (export.py:19-35)."""
    return shutil.which("ffmpeg")


def wav_to_mp3(wav_path, mp3_path=None, bitrate: str = "128k",
               delete_wav: bool = False) -> Path | None:
    """Convert WAV to MP3 with libmp3lame (export.py:37-66); returns the
    MP3 path or None when ffmpeg is unavailable or conversion fails."""
    ffmpeg = find_ffmpeg()
    if not ffmpeg:
        logger.debug("ffmpeg not found; skipping MP3 export")
        return None
    wav_path = Path(wav_path)
    mp3_path = Path(mp3_path) if mp3_path else wav_path.with_suffix(".mp3")
    try:
        result = subprocess.run(
            [ffmpeg, "-y", "-loglevel", "error", "-i", str(wav_path),
             "-codec:a", "libmp3lame", "-b:a", bitrate, str(mp3_path)],
            capture_output=True, timeout=60, check=False)
        if result.returncode != 0:
            logger.warning("ffmpeg failed: %s",
                           result.stderr.decode(errors="ignore")[:200])
            return None
        if delete_wav:
            wav_path.unlink(missing_ok=True)
        return mp3_path
    except (subprocess.TimeoutExpired, OSError) as e:
        logger.warning("MP3 export failed: %s", e)
        return None


class WavRecorder:
    """Continuous streaming WAV writer (modern.py:4073-4154 semantics),
    with optional silent-file deletion on close."""

    def __init__(self, path, sample_rate: int = VOICE_SAMPLE_RATE,
                 delete_if_silent: bool = True,
                 silence_threshold: float = 1e-4):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._wf = wave.open(str(self.path), "wb")
        self._wf.setnchannels(1)
        self._wf.setsampwidth(2)
        self._wf.setframerate(sample_rate)
        self._max_amp = 0.0
        self._frames = 0
        self.delete_if_silent = delete_if_silent
        self.silence_threshold = silence_threshold

    def write(self, audio: np.ndarray) -> None:
        audio = np.asarray(audio)
        if audio.dtype != np.int16:
            self._max_amp = max(self._max_amp,
                                float(np.max(np.abs(audio), initial=0.0)))
            audio = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
        else:
            self._max_amp = max(
                self._max_amp,
                float(np.max(np.abs(audio), initial=0) / 32768.0))
        self._wf.writeframes(audio.tobytes())
        self._frames += len(audio)

    def close(self) -> Path | None:
        self._wf.close()
        if (self.delete_if_silent
                and (self._frames == 0
                     or self._max_amp < self.silence_threshold)):
            self.path.unlink(missing_ok=True)
            return None
        return self.path


class VoiceAccumulator:
    """Group decoded voice per talkgroup into calls; a call finalizes after
    ``gap_s`` seconds without new audio (listen_clear.py:65-106)."""

    def __init__(self, out_dir, gap_s: float = 3.0,
                 min_call_s: float = 0.5,
                 sample_rate: int = VOICE_SAMPLE_RATE,
                 export_mp3: bool = False):
        self.out_dir = Path(out_dir)
        self.gap_s = gap_s
        self.min_call_s = min_call_s
        self.sample_rate = sample_rate
        self.export_mp3 = export_mp3
        self._calls: dict = {}      # talkgroup -> {audio: [], last: t}
        self.finalized: list = []

    def add(self, talkgroup, audio: np.ndarray,
            now: float | None = None) -> None:
        now = now if now is not None else time.time()
        call = self._calls.setdefault(
            talkgroup, {"audio": [], "last": now, "start": now})
        call["audio"].append(np.asarray(audio, np.float32))
        call["last"] = now

    def poll(self, now: float | None = None) -> list:
        """Finalize calls whose last audio is older than gap_s; returns the
        newly written file paths."""
        now = now if now is not None else time.time()
        done = []
        for tg in list(self._calls):
            call = self._calls[tg]
            if now - call["last"] >= self.gap_s:
                del self._calls[tg]
                audio = np.concatenate(call["audio"]) if call["audio"] \
                    else np.zeros(0, np.float32)
                dur = len(audio) / self.sample_rate
                if dur < self.min_call_s:
                    continue
                ts = time.strftime("%Y%m%d_%H%M%S",
                                   time.localtime(call["start"]))
                path = self.out_dir / f"call_tg{tg}_{ts}.wav"
                write_wav(path, audio, self.sample_rate)
                if self.export_mp3:
                    wav_to_mp3(path)
                done.append(path)
                self.finalized.append(path)
        return done

    def flush(self) -> list:
        """Finalize everything regardless of gap."""
        for call in self._calls.values():
            call["last"] = -1e18
        return self.poll(now=time.time())
