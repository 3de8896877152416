"""One-shot wideband scan: find every TETRA channel in a capture.

Builds a 2.4 MHz band with three active carriers at arbitrary offsets,
then runs the WidebandScanner, which channelizes the whole band through
the FFT frontend and sync/CRC-verifies every 25 kHz channel at once::

    python -m tetraear_tpu_torch.examples.wideband_scan [--device cpu]

Exits 1 unless exactly the three carriers are found.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.examples.wideband_scan")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.device import resolve
    from tetraear_tpu_torch.ref import golden, modulator
    from tetraear_tpu_torch.scan.scanner import WidebandScanner
    resolve(args.device)

    fs = 2.4e6
    center = 392.5e6
    # 25 kHz channel grid with a half-channel offset (..., 12.5k, 37.5k)
    active = (-287.5e3, 37.5e3, 462.5e3)
    rng = np.random.default_rng(0)
    parts = []
    for k, off in enumerate(active):
        bits = golden.build_stream(
            [golden.sds_text_payload("SCAN ME")] * 4, seed=k)
        parts.append(modulator.generate_carrier(bits, fs=fs,
                                                freq_offset_hz=off))
    n = min(len(p) for p in parts)
    iq = np.sum([p[:n] for p in parts], axis=0).astype(np.complex64)
    iq = modulator.add_awgn(iq, 20, rng)

    ws = WidebandScanner(fs=fs)
    results = ws.scan(iq, center_freq_hz=center, device=args.device)
    hits = [r for r in results if r["is_tetra"]]
    print(f"{'MHz':>10}  {'corr':>6}  {'CRC':>5}")
    for r in hits:
        print(f"{r['frequency_mhz']:10.4f}  {r['sync_correlation']:6.2f}"
              f"  {r['crc_pass_rate']:5.2f}")
    expect = sorted((center + o) / 1e6 for o in active)
    got = sorted(float(r["frequency_mhz"]) for r in hits)
    print(f"[*] expected {expect} -> found {got}")
    return 0 if len(hits) == len(active) else 1


if __name__ == "__main__":
    raise SystemExit(main())
