"""Live auto-decrypt listener with plaintext scoring.

Equivalent of the reference's decrypt_capture.py: stream, decode with
aggressive bruteforce enabled, and report every successful decryption with
its key, confidence and recovered text.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="decrypt-capture")
    ap.add_argument("--source", default="synthetic")
    ap.add_argument("-f", "--frequency", type=float, default=392.5)
    ap.add_argument("-s", "--sample-rate", type=float, default=2.4)
    ap.add_argument("-k", "--keys", help="user key file (ALG:ID:HEX)")
    ap.add_argument("--max-blocks", type=int, default=None)
    ap.add_argument("--min-score", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.device import resolve
    resolve(args.device)

    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.runtime.sources import open_source

    hits = []

    def on_frame(frame):
        if frame.get("decrypted") and \
                frame.get("decrypt_confidence", 0) >= args.min_score:
            hits.append(frame)
            print(f"[+] DECRYPTED frame #{frame.get('number')} "
                  f"key={frame.get('key_used')} "
                  f"score={frame.get('decrypt_confidence')}")
            if frame.get("sds_message"):
                print(f"    text: {frame['sds_message']}")
        elif frame.get("decryption_attempted") and \
                not frame.get("decrypted"):
            best = frame.get("best_score", 0)
            if best > 40:
                print(f"[-] frame #{frame.get('number')}: best score {best} "
                      f"({frame.get('keys_tried')} keys)")

    cfg = PipelineConfig(sample_rate=args.sample_rate * 1e6,
                         frequency=args.frequency * 1e6,
                         auto_decrypt=True, key_file=args.keys,
                         detect_gate=args.source == "rtlsdr",
                         voice=False, device=args.device)
    pipe = Pipeline(cfg, on_frame=on_frame)
    src = open_source(args.source, sample_rate=args.sample_rate * 1e6,
                      frequency=args.frequency * 1e6)
    try:
        pipe.run(src, max_blocks=args.max_blocks)
    except KeyboardInterrupt:
        pass
    print(f"[*] {pipe.stats.frames} frames, {pipe.stats.encrypted} "
          f"encrypted, {len(hits)} decrypted")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
