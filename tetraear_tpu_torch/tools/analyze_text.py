"""Analyze decoded text plausibility in a JSONL frame log.

Equivalent of the reference's analyze_text.py: scan a continuous-capture
log, score every decoded/SDS text and print the most plausible messages.
"""

from __future__ import annotations

import argparse
import json

from tetraear_tpu_torch.frame import sds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="analyze-text")
    ap.add_argument("frames", help="JSONL frame log")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--min-score", type=float, default=1.0)
    args = ap.parse_args(argv)

    rows = []
    with open(args.frames, encoding="utf-8") as f:
        for i, line in enumerate(f):
            try:
                fr = json.loads(line)
            except json.JSONDecodeError:
                continue
            for key in ("sds_message", "decoded_text"):
                text = fr.get(key)
                if not text:
                    continue
                s = sds.score_text(text)
                rows.append((s, i, key, text))

    rows.sort(key=lambda r: -r[0])
    shown = 0
    for s, i, key, text in rows:
        if s < args.min_score or shown >= args.top:
            break
        print(f"{s:5.2f}  line {i:<6} {key:<13} {text[:100]!r}")
        shown += 1
    print(f"\n[*] {len(rows)} texts total, {shown} above "
          f"score {args.min_score}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
