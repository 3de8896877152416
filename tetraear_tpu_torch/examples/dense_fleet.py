"""Dense-fleet host path: worker-sharded frame layer on mixed traffic.

Generates a multi-carrier capture (clear SDS on three channels, a
TEA1-encrypted channel decrypted automatically with a common key),
decodes it through the batched offline runner with the per-hit frame
layer sharded over worker processes (frame.parallel.ShardedFrameLayer,
what ``--frame-workers N`` enables on the CLI), and prints the traffic
grouped by carrier::

    python -m tetraear_tpu_torch.examples.dense_fleet [--device cpu]

The carrier bank and the key search run on the CUDA card unless
``--device cpu`` is given; the three workers run host code only.
"""

from __future__ import annotations

import argparse

import numpy as np


def fleet_capture() -> tuple:
    """(IQ at 2.304 MHz, carrier offsets): six carriers, SDS text on 0,
    2 and 4, a TEA1 carrier on 5 ("COVERT OPS GO" under a common key),
    random bits on 1 and 3; 25 dB SNR."""
    from tetraear_tpu_torch.crypto.tea import TEADecryptor
    from tetraear_tpu_torch.ref import golden, modulator
    fs = 2.304e6
    offsets = [(i - 3) * 25_000 + 12_500.0 for i in range(6)]
    texts = {0: "ENGINE 4 ON SCENE", 2: "BACKUP SECTOR 2",
             4: "UNITS HOLD POS"}
    key = bytes.fromhex("0123456789ABCDEF0123")      # a common TEA1 key
    secret = b"\x82COVERT OPS GO"
    cipher = TEADecryptor(key, "TEA1").encrypt(
        secret + b"\x00" * ((-len(secret)) % 8))
    streams = []
    for c in range(6):
        if c in texts:
            streams.append(golden.build_stream(
                [golden.sds_text_payload(texts[c])] * 4))
        elif c == 5:
            slots = [golden.build_slot(golden.build_mac_resource_data_bits(
                cipher, enc_mode=1, rng=np.random.default_rng(40 + i)))
                for i in range(4)]
            streams.append(np.concatenate(slots))
        else:
            streams.append(np.random.default_rng(50 + c).integers(
                0, 2, 2040).astype(np.uint8))
    iq = modulator.generate_multi_carrier(
        streams, fs=fs, offsets_hz=offsets, snr_db=25,
        rng=np.random.default_rng(60))
    return iq, offsets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.examples.dense_fleet")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.device import resolve
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.frame.parallel import ShardedFrameLayer
    from tetraear_tpu_torch.runtime.stream import DecodeRunner
    device = resolve(args.device)

    iq, offsets = fleet_capture()
    bank = CarrierBankDemod(fs=2.304e6, freqs_hz=offsets, frontend="fft")
    if len(iq) < 2 * bank.block_len:
        pad = 0.001 * np.random.default_rng(61).standard_normal(
            2 * bank.block_len - len(iq))
        iq = np.concatenate([iq, pad.astype(np.complex64)])

    layer = ShardedFrameLayer(len(offsets), n_workers=3,
                              auto_decrypt=True, device=device)
    try:
        runner = DecodeRunner(bank, layer, blocks_per_dispatch=2,
                              device=device)
        out = runner.run(iq)
    finally:
        layer.close()

    by_carrier: dict = {}
    for f in out["frames"]:
        if not f.get("burst_crc"):
            continue          # noise decodes via the adaptive cascade
        by_carrier.setdefault(f["carrier"], []).append(f)
    for ci in sorted(by_carrier):
        fl = by_carrier[ci]
        msgs = sorted({f.get("sds_message") for f in fl
                       if f.get("sds_message")})
        dec = sum(1 for f in fl if f.get("decrypted"))
        print(f"carrier {ci} ({offsets[ci]/1e3:+.1f} kHz): "
              f"{len(fl)} frames"
              + (f", {dec} decrypted" if dec else ""))
        for m in msgs:
            print(f"    {m}")
    total = sum(len(v) for v in by_carrier.values())
    print(f"\n{total} frames across {len(by_carrier)} carriers "
          f"({runner.dispatches} device dispatches, 3 frame workers)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
