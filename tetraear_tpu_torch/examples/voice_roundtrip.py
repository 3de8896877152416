"""Full voice chain: PCM -> ACELP -> RF -> demod -> ACELP -> WAV.

Synthesises speech-like PCM, encodes it with the native codec, transmits
it as pi/4-DQPSK traffic slots, then receives and decodes it back to a
playable WAV::

    python -m tetraear_tpu_torch.examples.voice_roundtrip [out.wav]
        [--device cpu]

The codec library is built with g++ at first use.  On the CUDA card the
speech channel decoder and the speech synthesis run as kernels; with
``--device cpu`` the pipeline runs their plain versions and synthesizes
on the host.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np


def synth_speech(n_slots: int, pitch: int = 57) -> np.ndarray:
    """Speech-like int16 PCM: a pulse train through an all-pole filter,
    480 samples (two 30 ms frames) a slot."""
    rng = np.random.default_rng(0)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.examples.voice_roundtrip")
    ap.add_argument("out", nargs="?", default="roundtrip.wav",
                    help="WAV to write (default: roundtrip.wav)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch import native
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.device import resolve
    from tetraear_tpu_torch.ref import golden
    from tetraear_tpu_torch.runtime.sources import FileIQSource, write_capture
    from tetraear_tpu_torch.voice.export import write_wav
    resolve(args.device)
    native.codec()                      # g++ at first use; raises on failure

    out = Path(args.out)
    pcm = synth_speech(6)
    iq = golden.golden_voice_iq(pcm, fs=2.4e6, snr_db=25, seed=5)
    print(f"[*] transmitted {len(pcm)} PCM samples as "
          f"{len(iq)} IQ samples")

    chunks = []
    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False, voice=True,
                         validate=False, block_len=32_000,
                         device=args.device)
    pipe = Pipeline(cfg, on_audio=chunks.append)
    with tempfile.TemporaryDirectory(prefix="voice_roundtrip_") as tmp:
        cap = Path(tmp) / "voice.cfile"
        write_capture(cap, iq)
        pipe.run(FileIQSource(cap, sample_rate=2.4e6))

    audio = np.concatenate(chunks) if chunks else np.zeros(0)
    write_wav(out, audio)
    print(f"[*] decoded {pipe.stats.voice_frames} voice slots -> "
          f"{len(audio)} samples -> {out.name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
