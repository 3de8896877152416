"""Continuous JSONL frame capture (reference: continuous_capture.py).

Streams from any IQ source, decodes frames and appends them to a JSONL log
that the offline tools (bruteforce-keys, analyze-text) re-consume.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="continuous-capture")
    ap.add_argument("--source", default="synthetic",
                    help="'rtlsdr', 'synthetic[:offsets]' or capture file")
    ap.add_argument("-f", "--frequency", type=float, default=392.5)
    ap.add_argument("-s", "--sample-rate", type=float, default=2.4)
    ap.add_argument("-o", "--output-dir", default="logs")
    ap.add_argument("--max-blocks", type=int, default=None)
    ap.add_argument("--duration", type=float, default=None,
                    help="stop after N seconds")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.device import resolve
    resolve(args.device)

    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.runtime.sources import open_source

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ts = time.strftime("%Y%m%d_%H%M%S")
    out_path = out_dir / f"continuous_{ts}.jsonl"

    counters = {"frames": 0}
    fh = open(out_path, "a", encoding="utf-8")

    def on_frame(frame):
        from tetraear_tpu_torch.api import _jsonable
        fh.write(json.dumps(_jsonable(frame)) + "\n")
        fh.flush()
        counters["frames"] += 1
        if counters["frames"] % 20 == 0:
            print(f"[*] {counters['frames']} frames captured")

    cfg = PipelineConfig(
        sample_rate=args.sample_rate * 1e6,
        frequency=args.frequency * 1e6,
        detect_gate=args.source == "rtlsdr",
        records_dir=None,
        voice=False,
        device=args.device,
    )
    pipe = Pipeline(cfg, on_frame=on_frame)
    src = open_source(args.source, sample_rate=args.sample_rate * 1e6,
                      frequency=args.frequency * 1e6)

    max_blocks = args.max_blocks
    if args.duration is not None:
        max_blocks = int(args.duration * args.sample_rate * 1e6
                         / pipe.block_len)
    print(f"[*] capturing to {out_path}")
    try:
        stats = pipe.run(src, max_blocks=max_blocks)
    except KeyboardInterrupt:
        stats = pipe.stats
    finally:
        fh.close()
    print(f"[*] done: {counters['frames']} frames, "
          f"{stats.samples / 1e6:.1f} Msamples")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
