"""Decode the checked-in recorded-style capture end to end.

Demonstrates the offline workflow on a realistic impaired recording
(LO offset, clock drift, multipath and noise, int16 wire format): the
batched offline runner (``Pipeline.run_offline``), auto-decryption of
the TEA1-encrypted carrier, and the per-carrier summaries::

    python -m tetraear_tpu_torch.examples.offair_fixture [--device cpu]

The fixture is tests/fixtures/offair_2carrier.cs16 of the checkout.
"""

from __future__ import annotations

import argparse
import collections
from pathlib import Path

FIXTURE = (Path(__file__).resolve().parents[2] / "tests" / "fixtures"
           / "offair_2carrier.cs16")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.examples.offair_fixture")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.runtime.sources import FileIQSource

    frames = []
    cfg = PipelineConfig(
        sample_rate=2.4e6, frequency=392.5e6,
        carrier_offsets_hz=(12_500.0, -287_500.0),
        detect_gate=False, voice=False, auto_decrypt=True,
        device=args.device)
    pipe = Pipeline(cfg, on_frame=frames.append)
    pipe.run_offline(FileIQSource(FIXTURE, sample_rate=2.4e6),
                     blocks_per_dispatch=8)

    print(f"{len(frames)} frames in {pipe.dispatches} device dispatches")
    by_carrier = collections.defaultdict(list)
    for f in frames:
        by_carrier[f["carrier"]].append(f)
    for ci, fs in sorted(by_carrier.items()):
        crc = sum(1 for f in fs if f.get("burst_crc"))
        dec = sum(1 for f in fs if f.get("decrypted"))
        texts = {f.get("sds_message") for f in fs if f.get("sds_message")}
        print(f"carrier {ci} @ {fs[0]['frequency'] / 1e6:.4f} MHz: "
              f"{len(fs)} frames, {crc} CRC-pass, {dec} decrypted")
        for t in sorted(texts):
            print(f"   {t}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
