"""Command-line interface of the port: the offline ``decode`` command.

    python -m tetraear_tpu_torch decode --source capture.cf32 -s 2.304 \\
        --offsets 12500,-12500 --device cuda

decodes a capture file on the fused receive path (the JAX package's
``decode``, restricted to the configuration that path serves) and
prints each frame and a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys

from tetraear_tpu.cli import CLIListener


def cmd_decode_file(args) -> int:
    from tetraear_tpu.runtime.sources import open_source
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig

    listener = CLIListener(show_invalid=args.show_invalid)
    offsets = tuple(float(o) for o in str(args.offsets).split(","))
    cfg = PipelineConfig(
        sample_rate=args.sample_rate * 1e6,
        frequency=args.frequency * 1e6,
        carrier_offsets_hz=offsets,
        auto_decrypt=args.auto_decrypt,
        key_file=args.keys,
        records_dir=args.records_dir,
        expected_mcc=args.expected_mcc,
        device=args.device,
    )
    pipe = Pipeline(cfg, on_frame=listener.on_frame)
    src = open_source(args.source, sample_rate=args.sample_rate * 1e6,
                      frequency=args.frequency * 1e6)
    stats = pipe.run_offline(src, blocks_per_dispatch=args.dispatch_blocks,
                             max_blocks=args.max_blocks)
    summary = stats.as_dict()
    summary["device"] = args.device
    summary["device_dispatches"] = pipe.dispatches
    summary["activity"] = pipe.aggregator.snapshot()
    summary["tdma"] = [t.stats() for t in pipe.trackers if t.slot_counter]
    print(json.dumps(summary, indent=2, default=str))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tetraear_tpu_torch",
        description="TETRA fleet receive path on PyTorch + CUDA")
    sub = parser.add_subparsers(dest="command")
    p = sub.add_parser("decode", help="offline decode of a capture file")
    p.add_argument("--source", required=True, help="capture file path")
    p.add_argument("-s", "--sample-rate", type=float, default=2.304,
                   help="sample rate in Msps, 72 kHz * 2^m "
                        "(default 2.304)")
    p.add_argument("-f", "--frequency", type=float, default=392.5,
                   help="centre frequency in MHz (default 392.5)")
    p.add_argument("--offsets", default="12500",
                   help="comma-separated carrier offsets in Hz")
    p.add_argument("--device", default="cpu",
                   help="torch device: cpu (plain versions) or cuda "
                        "(CUDA kernels)")
    p.add_argument("--auto-decrypt", action="store_true", default=False)
    p.add_argument("-k", "--keys", help="key file (ALG:ID:HEX per line)")
    p.add_argument("--records-dir", help="directory for the JSONL log")
    p.add_argument("--expected-mcc", type=int,
                   help="expected country MCC for validation")
    p.add_argument("--dispatch-blocks", type=int, default=16,
                   help="blocks per device batch (default 16)")
    p.add_argument("--max-blocks", type=int,
                   help="stop after N blocks (default: run to EOF)")
    p.add_argument("--show-invalid", action="store_true")
    p.set_defaults(func=cmd_decode_file)
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 2
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
