"""Multi-device deployment: the carrier x time sharded demodulator.

Demonstrates the scaling path (runtime/sharding.py): carriers sharded
across one mesh axis, the time stream across the other, the halos
exchanged between neighbouring time shards; then the voice slot bank and
the key search sharded over a one-axis mesh.  The mesh here is a virtual
one of eight entries that all name one device (the CUDA card, or the
CPU with ``--device cpu``), whose shards run one after the other; on a
machine with eight cards give ``make_mesh`` their list instead and the
same code spreads over them::

    python -m tetraear_tpu_torch.examples.sharded_deployment [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch.examples.sharded_deployment")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.crypto.batch import tea_key_search
    from tetraear_tpu_torch.device import resolve
    from tetraear_tpu_torch.ref import golden, modulator
    from tetraear_tpu_torch.runtime.sharding import (Mesh, ShardedFFTDemod,
                                                     make_mesh)
    from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool
    dev = resolve(args.device)
    entries = [dev] * 8
    print(f"[*] 8 mesh entries on {dev.type} (a virtual mesh of one "
          f"device)")

    # 2 carrier shards x 4 time shards over the 8 entries
    mesh = make_mesh(2, 4, entries)

    fs = 2.4e6
    offsets = (-300e3, -25e3, 25e3, 300e3)
    rng = np.random.default_rng(0)
    parts = []
    for k, off in enumerate(offsets):
        bits = golden.build_stream(
            [golden.sds_text_payload("SHARDED DECODE")] * 4, seed=k)
        parts.append(modulator.generate_carrier(bits, fs=fs,
                                                freq_offset_hz=off))
    n = min(len(p) for p in parts)
    iq = np.sum([p[:n] for p in parts], axis=0).astype(np.complex64)
    iq = modulator.add_awgn(iq, 20, rng)

    demod = ShardedFFTDemod(fs=fs, freqs_hz=offsets, mesh=mesh)
    need = demod.n_time * demod.seg_len
    if len(iq) < need:   # pad the demo capture to a whole mesh block
        tail = 0.001 * (rng.standard_normal(need - len(iq)) * (1 + 1j))
        iq = np.concatenate([iq, tail.astype(np.complex64)])
    out = demod.run(iq[:need])
    print(f"[*] hard symbols {tuple(out['hard'].shape)} "
          f"(carrier x time-shard x sym) across a "
          f"{dict(mesh.shape)} mesh, {out['sync_hits']} sync hits")

    # the voice fleet axis: the ACELP slot bank sharded over the mesh,
    # PCM bit-identical at any mesh size
    vmesh = Mesh(np.array(entries, dtype=object), ("voice",))
    pool = DeviceSpeechPool(slots=8, mesh=vmesh)
    frames = np.zeros((3, 138), np.int16)
    frames[:, 1:] = rng.integers(0, 2, (3, 137))
    pcm = pool.synthesize([(0, frames)])[0]
    print(f"[*] voice: {len(pcm)} PCM samples decoded on the "
          f"{vmesh.shape['voice']}-entry voice mesh")

    # fleet decrypt: keys x frames sharded over the mesh
    payloads = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    keys = [bytes(rng.integers(0, 256, 10, dtype=np.uint8).tolist())
            for _ in range(8)]
    res = tea_key_search(payloads, keys, "TEA1", mesh=vmesh)
    print(f"[*] crypto: {len(keys)} keys x {len(payloads)} frames "
          f"searched on the mesh, best scores "
          f"{np.asarray(res['best_score'])[:4].tolist()} ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
