"""Clear-traffic listener with per-call voice accumulation.

Equivalent of the reference's listen_clear.py: stream, decode, filter for
readable clear traffic, decode voice per talkgroup and finalize calls after
a 3 s silence gap into WAV files.
"""

from __future__ import annotations

import argparse


def _ascii_purity(text: str) -> float:
    """ASCII-purity filter for clear text (listen_clear.py:53-63)."""
    if not text:
        return 0.0
    good = sum(1 for c in text if c.isprintable() or c in "\n\r\t")
    return good / len(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="listen-clear")
    ap.add_argument("--source", default="synthetic")
    ap.add_argument("-f", "--frequency", type=float, default=392.5)
    ap.add_argument("-s", "--sample-rate", type=float, default=2.4)
    ap.add_argument("-o", "--output-dir", default="calls")
    ap.add_argument("--max-blocks", type=int, default=None)
    ap.add_argument("--gap", type=float, default=3.0,
                    help="silence gap that finalizes a call (s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.device import resolve
    resolve(args.device)

    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.runtime.sources import open_source
    from tetraear_tpu_torch.voice.export import VoiceAccumulator

    acc = VoiceAccumulator(args.output_dir, gap_s=args.gap)
    current_tg = {"tg": 0}

    def on_frame(frame):
        if frame.get("encrypted") and not frame.get("decrypted"):
            return
        meta = frame.get("call_metadata") or {}
        if meta.get("talkgroup_id"):
            current_tg["tg"] = meta["talkgroup_id"]
        text = frame.get("sds_message")
        if text and _ascii_purity(text) > 0.8:
            print(f"[TG {current_tg['tg']}] {text}")

    def on_audio(audio):
        acc.add(current_tg["tg"], audio)
        for path in acc.poll():
            print(f"[+] call written: {path}")

    cfg = PipelineConfig(sample_rate=args.sample_rate * 1e6,
                         frequency=args.frequency * 1e6,
                         detect_gate=args.source == "rtlsdr",
                         device=args.device)
    pipe = Pipeline(cfg, on_frame=on_frame, on_audio=on_audio)
    src = open_source(args.source, sample_rate=args.sample_rate * 1e6,
                      frequency=args.frequency * 1e6)
    try:
        pipe.run(src, max_blocks=args.max_blocks)
    except KeyboardInterrupt:
        pass
    for path in acc.flush():
        print(f"[+] call written: {path}")
    print(f"[*] {pipe.stats.frames} frames, "
          f"{pipe.stats.voice_frames} voice frames, "
          f"{len(acc.finalized)} calls")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
