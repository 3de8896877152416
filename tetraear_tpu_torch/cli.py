"""Command-line interface of the port: ``listen``, ``decode``,
``scan``, ``bench`` and the tools.

    python -m tetraear_tpu_torch listen --source synthetic --max-blocks 4
    python -m tetraear_tpu_torch decode --source capture.cs16 -s 2.4 \\
        --offsets 12500,-287500
    python -m tetraear_tpu_torch scan --wideband --source capture.cs16

``listen`` streams a source block by block through
``Pipeline.run`` / ``process_block`` (the JAX CLI's default command, the
CLI listener of modern.py:5334-5405); ``decode`` decodes a capture file
S blocks per device batch (``Pipeline.run_offline``).  Both print each
frame and a JSON summary (with the tracer's counters; ``--trace``
adds each span's totals), take the receive-chain options and
``--frame-workers``, and run on the card unless ``--device cpu`` is
given.  ``scan`` looks for TETRA channels: ``--wideband`` scores every
25 kHz channel of one ``--dwell`` seconds capture with the carrier bank
(scan.scanner.WidebandScanner, on ``--device``); without it the step
scanner retunes the source over [start, stop] MHz and analyses each
channel on the host (FrequencyScanner).  ``bench`` runs the port's
benchmark (tetraear_tpu_torch/bench.py: real-time carriers per card,
BENCH_* in the environment, C=20480 by default) on ``--device``:

    python -m tetraear_tpu_torch bench

The tool subcommands (``TOOLS``: ``bruteforce-keys``, ``decrypt-capture``,
``continuous-capture``, ``listen-clear``, ``auto-capture``,
``generate-keys``, ``analyze-text``, ``verify-codec``, ``build-release``)
hand the rest of the command line to the tool's own ``main``:

    python -m tetraear_tpu_torch bruteforce-keys frames.jsonl -k keys.txt
"""

from __future__ import annotations

import argparse
import json
import sys

C_RESET = "\x1b[0m"
C_GREEN = "\x1b[32m"
C_YELLOW = "\x1b[33m"
C_RED = "\x1b[31m"
C_CYAN = "\x1b[36m"
C_MAGENTA = "\x1b[35m"
C_DIM = "\x1b[2m"


class CLIListener:
    """Colorized frame printer (modern.py:5334-5405)."""

    def __init__(self, show_invalid: bool = False):
        self.show_invalid = show_invalid
        self.count = 0

    def on_frame(self, frame: dict) -> None:
        self.count += 1
        if not self.show_invalid and frame.get("valid") is False:
            return
        crc = frame.get("burst_crc")
        crc_s = (f"{C_GREEN}CRC✓{C_RESET}" if crc
                 else f"{C_RED}CRC✗{C_RESET}")
        enc = frame.get("encrypted")
        if enc and frame.get("decrypted"):
            enc_s = f"{C_MAGENTA}DEC[{frame.get('encryption_algorithm')}]" \
                f"{C_RESET}"
        elif enc:
            enc_s = f"{C_YELLOW}ENC[{frame.get('encryption_algorithm')}]" \
                f"{C_RESET}"
        else:
            enc_s = f"{C_GREEN}CLR{C_RESET}"
        line = (f"#{self.count:<5} {frame.get('type_name', '?'):<14} "
                f"car{frame.get('carrier', 0)} {crc_s} {enc_s}")
        meta = frame.get("call_metadata")
        if meta:
            if meta.get("talkgroup_id"):
                line += f" TG={meta['talkgroup_id']}"
            if meta.get("source_ssi"):
                line += f" SSI={meta['source_ssi']}"
            if meta.get("mcc"):
                from tetraear_tpu_torch.frame import mcc_mnc
                line += (f" {C_CYAN}"
                         f"{mcc_mnc.get_location_info(meta['mcc'], meta.get('mnc'))}"
                         f"{C_RESET}")
        sds = frame.get("sds_message")
        if sds:
            line += f"\n      {C_CYAN}💬 {sds}{C_RESET}"
        if frame.get("has_voice"):
            line += f" {C_GREEN}🔊{C_RESET}"
        print(line)

    def on_status(self, status: str) -> None:
        print(f"{C_DIM}[status] {status}{C_RESET}", file=sys.stderr)


def _add_common(p: argparse.ArgumentParser, source_default) -> None:
    p.add_argument("-f", "--frequency", type=float, default=392.5,
                   help="centre frequency in MHz (default 392.5)")
    p.add_argument("-s", "--sample-rate", type=float, default=2.4,
                   help="sample rate in Msps (default 2.4)")
    p.add_argument("-g", "--gain", default="auto",
                   help="SDR gain ('auto' or dB)")
    p.add_argument("--source", default=source_default,
                   required=source_default is None,
                   help="IQ source: 'rtlsdr', 'synthetic[:off1,...]' or a "
                        "capture file path")
    p.add_argument("--offsets", default="0",
                   help="comma-separated carrier offsets in Hz to "
                        "demodulate (default: 0 = centre channel)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' "
                        "runs the kernels' plain versions)")
    p.add_argument("--frontend", choices=("conv", "fft"), default="conv",
                   help="conv: NCO + polyphase stages; fft: wideband FFT "
                        "channelizer (default conv)")
    p.add_argument("--no-carrier-afc", dest="carrier_afc",
                   action="store_false", default=True,
                   help="switch the per-carrier frequency tracking off")
    p.add_argument("--dense-hits", dest="sparse_hits",
                   action="store_false", default=True,
                   help="fetch the dense scan planes instead of sparse "
                        "hit keys")
    p.add_argument("--auto-decrypt", action="store_true", default=True)
    p.add_argument("--no-auto-decrypt", dest="auto_decrypt",
                   action="store_false")
    p.add_argument("-k", "--keys", help="key file (ALG:ID:HEX per line)")
    p.add_argument("--records-dir", help="directory for the JSONL log")
    p.add_argument("--expected-mcc", type=int,
                   help="expected country MCC for validation (e.g. 260)")
    p.add_argument("--frame-workers", type=int, default=0,
                   help="shard the per-hit frame layer over N worker "
                        "processes (0 = in-process)")
    p.add_argument("--voice-threads", type=int, default=0,
                   help="synthesize voice carriers on N threads "
                        "(0 = sequential)")
    p.add_argument("--max-blocks", type=int,
                   help="stop after N blocks (default: run to EOF)")
    p.add_argument("--show-invalid", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")


def _make_pipeline(args, on_frame=None, on_status=None):
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    offsets = tuple(float(o) for o in str(args.offsets).split(","))
    cfg = PipelineConfig(
        sample_rate=args.sample_rate * 1e6,
        frequency=args.frequency * 1e6,
        carrier_offsets_hz=offsets,
        auto_decrypt=args.auto_decrypt,
        key_file=args.keys,
        records_dir=args.records_dir,
        expected_mcc=args.expected_mcc,
        detect_gate=args.source == "rtlsdr",
        frontend=args.frontend,
        carrier_afc=args.carrier_afc,
        sparse_hits=args.sparse_hits,
        frame_workers=args.frame_workers,
        voice_threads=args.voice_threads,
        device=args.device,
    )
    return Pipeline(cfg, on_frame=on_frame, on_status=on_status)


def _open_source(args):
    from tetraear_tpu_torch.runtime.sources import open_source
    return open_source(args.source, sample_rate=args.sample_rate * 1e6,
                       frequency=args.frequency * 1e6, gain=args.gain)


def _summary(pipe, stats) -> dict:
    """The run's JSON summary: the stats, the tracer's counters (always
    on) and, with ``--trace``, its per-stage totals (``report()``)."""
    from tetraear_tpu_torch.runtime import profiling
    summary = stats.as_dict()
    summary["device"] = str(pipe.device)
    summary["backhalf"] = pipe.runner._backhalf_reason
    summary["activity"] = pipe.aggregator.snapshot()
    summary["tdma"] = [t.stats() for t in pipe.trackers if t.slot_counter]
    tracer = profiling.tracer()
    summary["counters"] = tracer.counters()
    if tracer.on:
        summary["stages"] = tracer.report()
    return summary


def _trace(args) -> None:
    if args.trace:
        from tetraear_tpu_torch.runtime import profiling
        profiling.tracer().enable()


def cmd_listen(args) -> int:
    """Stream a source block by block (Pipeline.run -> process_block)."""
    _trace(args)
    listener = CLIListener(show_invalid=args.show_invalid)
    pipe = _make_pipeline(args, on_frame=listener.on_frame,
                          on_status=listener.on_status)
    try:
        src = _open_source(args)
        print(f"Listening on {args.frequency:.4f} MHz "
              f"({len(pipe.bank.freqs_hz)} carrier(s), "
              f"source={args.source}) — Ctrl-C to stop")
        try:
            stats = pipe.run(src, max_blocks=args.max_blocks)
        except KeyboardInterrupt:
            stats = pipe.stats
            print("\nstopped")
        print(json.dumps(_summary(pipe, stats), indent=2, default=str))
    finally:
        pipe.close()
    return 0


def cmd_decode_file(args) -> int:
    """Offline decode of a recorded capture -> frames on stdout/JSONL,
    S blocks per device batch (Pipeline.run_offline)."""
    _trace(args)
    listener = CLIListener(show_invalid=args.show_invalid)
    pipe = _make_pipeline(args, on_frame=listener.on_frame)
    try:
        stats = pipe.run_offline(_open_source(args),
                                 blocks_per_dispatch=args.dispatch_blocks,
                                 max_blocks=args.max_blocks)
        summary = _summary(pipe, stats)
        summary["device_dispatches"] = pipe.dispatches
        print(json.dumps(summary, indent=2, default=str))
    finally:
        pipe.close()
    return 0


def cmd_scan(args) -> int:
    """Scan for TETRA channels (the JAX CLI's ``scan``)."""
    import numpy as np
    if args.wideband:
        from tetraear_tpu_torch.scan.scanner import WidebandScanner
        src = _open_source(args)
        with src:
            iq = src.read_samples(int(args.sample_rate * 1e6 * args.dwell))
        ws = WidebandScanner(fs=args.sample_rate * 1e6)
        results = ws.scan(np.asarray(iq), center_freq_hz=args.frequency * 1e6,
                          device=args.device)
        hits = [r for r in results if r["is_tetra"]]
        print(f"{'MHz':>10}  {'corr':>6}  {'CRC':>5}  {'frames':>6}")
        for r in sorted(results, key=lambda r: -r["confidence"])[:20]:
            mark = " *" if r["is_tetra"] else ""
            print(f"{r['frequency_mhz']:10.4f}  {r['sync_correlation']:6.2f}"
                  f"  {r['crc_pass_rate']:5.2f}  {r['n_frames']:6d}{mark}")
        print(f"{len(hits)} active TETRA channel(s)")
        return 0
    from tetraear_tpu_torch.scan.scanner import FrequencyScanner
    src = _open_source(args)
    if not src.open():
        print("failed to open source", file=sys.stderr)
        return 1
    try:
        sc = FrequencyScanner(src, sample_rate=args.sample_rate * 1e6)
        found = sc.scan_range(args.start * 1e6, args.stop * 1e6)
        sc.found_channels = found
        sc.print_found_channels()
        for ch in found:
            print(f"{ch['frequency_mhz']:.4f} MHz  power="
                  f"{ch['power_db']:.1f} dB  conf={ch['confidence']:.2f}")
    finally:
        src.close()
    return 0


def cmd_bench(args) -> int:
    """The port's benchmark, in process (bench.main)."""
    from tetraear_tpu_torch import bench
    return bench.main([] if args.device is None
                      else ["--device", args.device])


# subcommand -> module of tetraear_tpu_torch.tools whose main() takes the
# rest of the command line (the JAX CLI's tool dispatch)
TOOLS = (
    ("listen-clear", "listen_clear"),
    ("continuous-capture", "continuous_capture"),
    ("decrypt-capture", "decrypt_capture"),
    ("bruteforce-keys", "bruteforce_keys"),
    ("generate-keys", "generate_common_keys"),
    ("analyze-text", "analyze_text"),
    ("verify-codec", "verify_codec"),
    ("auto-capture", "auto_capture"),
    ("build-release", "build_release"),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tetraear_tpu_torch",
        description="TETRA receive chain on PyTorch + CUDA")
    sub = parser.add_subparsers(dest="command")
    trace_help = ("trace the run: the summary adds each span's totals "
                  "(runtime/profiling.Tracer.report) to the counters")
    p = sub.add_parser("listen", help="realtime/headless listener")
    _add_common(p, "rtlsdr")
    p.add_argument("--trace", action="store_true", help=trace_help)
    p.set_defaults(func=cmd_listen)
    p = sub.add_parser("decode", help="offline decode of a capture file")
    _add_common(p, None)
    p.add_argument("--trace", action="store_true", help=trace_help)
    p.add_argument("--dispatch-blocks", type=int, default=16,
                   help="blocks per device batch (default 16)")
    p.set_defaults(func=cmd_decode_file)
    p = sub.add_parser("scan", help="scan for TETRA channels")
    _add_common(p, "rtlsdr")
    p.add_argument("start", type=float, nargs="?", default=390.0,
                   help="start MHz")
    p.add_argument("stop", type=float, nargs="?", default=395.0,
                   help="stop MHz")
    p.add_argument("--wideband", action="store_true",
                   help="one-shot all-channel scan of a single capture")
    p.add_argument("--dwell", type=float, default=0.2,
                   help="seconds of capture a wideband scan reads")
    p.set_defaults(func=cmd_scan)
    p = sub.add_parser("bench", help="real-time carriers per card "
                                     "(BENCH_* in the environment)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' "
                        "runs the kernels' plain versions)")
    p.set_defaults(func=cmd_bench)
    for name, module in TOOLS:
        p = sub.add_parser(name, help=f"tool: {module}", add_help=False)
        p.set_defaults(tool_module=module)
    args, rest = parser.parse_known_args(argv)
    if getattr(args, "tool_module", None):
        import importlib
        mod = importlib.import_module(
            f"tetraear_tpu_torch.tools.{args.tool_module}")
        return mod.main(rest)
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if not getattr(args, "func", None):
        parser.print_help()
        return 2
    if getattr(args, "verbose", False):
        from tetraear_tpu_torch.utils.logging import setup_logging
        setup_logging(True)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
