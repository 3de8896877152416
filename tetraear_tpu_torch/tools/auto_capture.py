"""Headless auto-capture: run until readable text or voice is found.

Equivalent of the reference's tools/rtl_auto_capture.py: stream from a
source, decode, and stop as soon as a readable SDS message or non-silent
voice decode appears (or a time budget expires), writing what was found.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="auto-capture")
    ap.add_argument("--source", default="rtlsdr")
    ap.add_argument("-f", "--frequency", type=float, default=392.5)
    ap.add_argument("-s", "--sample-rate", type=float, default=2.4)
    ap.add_argument("-o", "--output-dir", default="auto_capture")
    ap.add_argument("--max-blocks", type=int, default=200,
                    help="give up after N blocks (default 200 ~ 11 s)")
    ap.add_argument("--min-text-len", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.device import resolve
    resolve(args.device)

    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.runtime.sources import open_source
    from tetraear_tpu_torch.voice.export import write_wav

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    found: dict = {}

    def on_frame(frame):
        # CRC gate: the adaptive sync cascade also emits frames from
        # noise (reference-compatible), and their MAC parse can yield
        # plausible-looking SDS strings (e.g. "[GPS] ..." hex dumps) —
        # only a CRC-verified burst counts as a find
        if not frame.get("burst_crc"):
            return
        text = frame.get("sds_message") or frame.get("decoded_text")
        if (text and not text.startswith("[BIN")
                and len(text) >= args.min_text_len):
            found.setdefault("text", text)
            found.setdefault("frame", frame)

    def on_audio(audio):
        if np.max(np.abs(audio)) > 1e-3:
            found.setdefault("audio_chunks", []).append(audio)

    cfg = PipelineConfig(sample_rate=args.sample_rate * 1e6,
                         frequency=args.frequency * 1e6,
                         detect_gate=args.source == "rtlsdr",
                         device=args.device)
    pipe = Pipeline(cfg, on_frame=on_frame, on_audio=on_audio)
    src = open_source(args.source, sample_rate=args.sample_rate * 1e6,
                      frequency=args.frequency * 1e6)

    with src:
        for n in range(args.max_blocks):
            block = src.read_samples(pipe.block_len)
            if len(block) < pipe.block_len:
                break
            pipe.process_block(block)
            if "text" in found or "audio_chunks" in found:
                print(f"[+] hit after {n + 1} blocks")
                break

    if "text" in found:
        print(f"[+] readable text: {found['text']!r}")
        from tetraear_tpu_torch.api import _jsonable
        (out_dir / "hit_frame.json").write_text(
            json.dumps(_jsonable(found["frame"]), indent=2))
    if "audio_chunks" in found:
        audio = np.concatenate(found["audio_chunks"])
        path = out_dir / "hit_voice.wav"
        write_wav(path, audio)
        print(f"[+] voice: {len(audio)} samples -> {path}")
    if not found:
        print("[-] nothing readable found")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
