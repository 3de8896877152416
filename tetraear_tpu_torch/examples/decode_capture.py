"""Offline decode of an IQ capture with the streaming Pipeline API.

Generates a synthetic TETRA carrier (so the example is self-contained),
writes it as a .cfile, then decodes it exactly as you would a real
capture::

    python -m tetraear_tpu_torch.examples.decode_capture [capture.cfile]
        [--device cpu]

Pass a path to decode your own capture (complex64 .cfile, .cs16, .cu8 or
.npy; the sample rate is taken as 2.4 Msps).  The pipeline runs on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np


def make_demo_capture(path: Path) -> int:
    """Four SDS slots ("EXAMPLE CAPTURE") at 2.4 Msps, 20 dB SNR, written
    to ``path``; returns the number of IQ samples."""
    from tetraear_tpu_torch.ref import golden, modulator
    from tetraear_tpu_torch.runtime.sources import write_capture
    payloads = [golden.sds_text_payload("EXAMPLE CAPTURE")] * 4
    bits = golden.build_stream(payloads, seed=1, sysinfo_every=4)
    iq = modulator.generate_carrier(bits, fs=2.4e6)
    iq = modulator.add_awgn(iq, 20, np.random.default_rng(1))
    write_capture(path, iq)
    return len(iq)


def decode(path: Path, device) -> int:
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.runtime.sources import FileIQSource

    def on_frame(frame):
        line = (f"#{frame['number']:<3} {frame['type_name']:<14} "
                f"crc={'ok' if frame.get('burst_crc') else 'FAIL'}")
        if frame.get("sds_message"):
            line += f"  {frame['sds_message']}"
        print(line)

    cfg = PipelineConfig(sample_rate=2.4e6, detect_gate=False, device=device)
    pipe = Pipeline(cfg, on_frame=on_frame)
    stats = pipe.run(FileIQSource(path, sample_rate=2.4e6))
    print(f"[*] {stats.frames} frames, {stats.crc_pass} CRC-valid, "
          f"{stats.sds_messages} SDS messages")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.examples.decode_capture")
    ap.add_argument("capture", nargs="?", help="IQ capture to decode "
                    "(default: a demo capture written to a temporary "
                    "directory)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    from tetraear_tpu_torch.device import resolve
    resolve(args.device)
    if args.capture:
        return decode(Path(args.capture), args.device)
    with tempfile.TemporaryDirectory(prefix="decode_capture_") as tmp:
        path = Path(tmp) / "demo.cfile"
        n = make_demo_capture(path)
        print(f"[*] wrote demo capture: {path.name} ({n} IQ samples)")
        return decode(path, args.device)


if __name__ == "__main__":
    raise SystemExit(main())
