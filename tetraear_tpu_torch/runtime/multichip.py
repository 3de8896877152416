"""Multi-device dry run of the sharded paths (the JAX package's
``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n_devices, devices=None)`` runs every sharded path
over a mesh of ``n_devices`` entries of ``devices`` (default: every
visible card; a list may repeat a device, a virtual mesh whose shards
run one after the other on it):

  * the conv rung: ``ShardedDemod`` on a modulated multi-carrier capture
    with a known slot count; the mesh-wide sync statistic must see the
    slots, and the deduped unique frames (``count_unique_frames``) must
    equal the transmitted slots exactly;
  * the FFT rung: the same with ``ShardedFFTDemod`` at 10.24 MHz;
  * the voice rung: ``DeviceSpeechPool(mesh=)`` PCM bit-identical to the
    unsharded pool at mesh sizes 1/2/4/8, across a state-carrying second
    call.  The JAX rung also reads the compiled program for collectives;
    the port's pool issues none by construction (each shard launches its
    own decode on its own device, and only the PCM rows are copied back);
  * the crypto rung: a K 6 x B 1024 key search with the payload axis
    sharded, every plaintext equal to ``TEADecryptor``'s and
    ``best_key_index`` to the host argmax;
  * the scaling table: the exact redundant-work ratio and ``sync_hits``
    over the time, carrier and 2-D layouts (equal across the carrier
    layouts of one time split; raw hits count a sync word inside a time
    halo twice).  Wall time is printed
    only for a card, beside its name; on a virtual mesh it is labelled
    "one card, shards serialised" and is no scaling figure.

Run: ``python -m tetraear_tpu_torch.runtime.multichip [N] [--cpu]``
(``--cpu``: a virtual mesh of N CPU entries).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve


def modulated_capture(offsets, n_samples, fs=2.4e6, seed=7, active=None):
    """Multi-carrier TETRA signal with a KNOWN number of sync-bearing
    slots per carrier; returns (iq, n_slots_total).  ``active`` (default:
    every carrier) names the carriers that transmit; the others carry
    only the noise."""
    from tetraear_tpu_torch.ref import golden, modulator

    n_slots = max(2, int(n_samples / fs * 18_000 / 255) - 2)
    active = range(len(offsets)) if active is None else active
    streams = []
    for ci in active:
        payloads = [golden.sds_text_payload(f"MESH CARRIER {ci}")] * n_slots
        streams.append(golden.build_stream(payloads))
    iq = modulator.generate_multi_carrier(
        streams, fs=fs, offsets_hz=[offsets[ci] for ci in active],
        snr_db=25, rng=np.random.default_rng(seed))
    if len(iq) < n_samples:
        pad = 0.001 * (np.random.default_rng(seed + 1).standard_normal(
            n_samples - len(iq)) * (1 + 1j))
        iq = np.concatenate([iq, pad.astype(np.complex64)])
    return iq[:n_samples], n_slots * len(active)


def count_unique_frames(out, n_carriers, n_time, seg_syms, halo_syms,
                        carriers=None):
    """Exact post-dedup frame count from a sharded demod output.

    Per carrier (of ``carriers``, default all) and shard, find EXACT
    (22/22) training-sequence matches in the valid symbol stream, map
    each to a global bit position via the shard's known symbol offset,
    and dedup across the halo double-coverage with a small tolerance
    window (the per-shard O&M timing phase can shift the symbol grid by
    a couple of symbols).  Returns the mesh-wide unique frame count, to
    be compared EXACTLY against the transmitted slot count."""
    from tetraear_tpu_torch.frame import burst as burst_mod

    pats = [np.asarray(p, np.uint8) for p in
            (burst_mod.SYNC_CONTINUOUS_DOWNLINK,
             burst_mod.SYNC_DISCONTINUOUS_DOWNLINK)]
    tol = 32                                    # bits (+-8 symbols)
    total = 0
    for ci in (range(n_carriers) if carriers is None else carriers):
        positions = []
        for t in range(n_time):
            v = np.asarray(out["valid"][ci, t]).astype(bool)
            seg = np.asarray(out["hard"][ci, t])[v]
            bits = np.empty(2 * len(seg), np.uint8)
            bits[0::2] = seg >> 1
            bits[1::2] = seg & 1
            # shard t's first VALID symbol sits at this global index
            # (every shard prepends the halo span: zeros on shard 0)
            n_masked = int(np.argmax(v)) if v.any() else 0
            g0 = t * seg_syms - halo_syms + n_masked
            for p in pats:
                if len(bits) < len(p):
                    continue
                w = np.lib.stride_tricks.sliding_window_view(bits, len(p))
                for i in np.nonzero((w == p[None, :]).all(axis=1))[0]:
                    positions.append(2 * g0 + int(i))
        positions.sort()
        last = -10 ** 9
        for p in positions:
            if p - last > tol:
                total += 1
            last = p
    return total


def fft_frame_geometry(sd) -> tuple:
    """(seg_syms, halo_syms) of a ShardedFFTDemod for count_unique_frames."""
    return (sd._out_len(sd.seg_len // sd.chan.decim) // sd.sps,
            sd._out_len(sd.back_halo) // sd.sps)


def _layout(n_devices: int) -> tuple:
    """The reference's 2-D choice: the largest of 2, 4, 8 carrier shards
    that leaves at least 2 time shards."""
    n_c = 1
    for cand in (2, 4, 8):
        if n_devices % cand == 0 and n_devices // cand >= 2:
            n_c = cand
    return n_c, n_devices // n_c


def conv_rung(devices, n_c: int, n_t: int, say=print) -> dict:
    """ShardedDemod on a modulated 2.4 Msps capture over an n_c x n_t
    mesh: unique frames equal the transmitted slots."""
    from tetraear_tpu_torch.runtime.sharding import ShardedDemod, make_mesh

    mesh = make_mesh(n_c, n_t, devices=devices[:n_c * n_t])
    n_carriers = 2 * n_c
    offsets = [(i - n_carriers // 2) * 25_000 + 12_500
               for i in range(n_carriers)]
    seg_len = 48_000         # 20 ms per shard: a few slots per segment
    sd = ShardedDemod(fs=2.4e6, freqs_hz=offsets, mesh=mesh,
                      seg_len=seg_len)
    iq, n_slots = modulated_capture(offsets, n_t * seg_len)
    out = sd.run(iq)
    if out["hard"].shape[:2] != (n_carriers, n_t):
        raise AssertionError(f"conv rung: output {out['hard'].shape}")
    if not np.all(np.asarray(out["valid"]).sum(axis=-1) > 0):
        raise AssertionError("conv rung: a shard without valid symbols")
    if out["sync_hits"] < 0.7 * n_slots:
        raise AssertionError(f"sync_hits={out['sync_hits']} for {n_slots} "
                             f"transmitted slots")
    uniq = count_unique_frames(out, n_carriers, n_t,
                               sd._n_out_syms(sd.seg_len),
                               sd._n_out_syms(sd.halo))
    if uniq != n_slots:
        raise AssertionError(f"unique frames {uniq} != transmitted slots "
                             f"{n_slots}")
    say(f"dryrun_multichip OK (conv): mesh carrier={n_c} x time={n_t}, "
        f"hard={out['hard'].shape}, unique_frames={uniq} == transmitted "
        f"slots={n_slots} (raw sync_hits={out['sync_hits']})")
    return {"unique_frames": uniq, "slots": n_slots,
            "sync_hits": out["sync_hits"]}


def fft_rung(devices, n_c: int, n_t: int, say=print) -> dict:
    """ShardedFFTDemod at 10.24 MHz (aligned grid) over an n_c x n_t
    mesh: unique frames equal the transmitted slots."""
    from tetraear_tpu_torch.runtime.sharding import (ShardedFFTDemod,
                                                     make_mesh)

    mesh = make_mesh(n_c, n_t, devices=devices[:n_c * n_t])
    n_carriers = 2 * n_c
    offsets = [(i - n_carriers // 2) * 25_000 + 12_500
               for i in range(n_carriers)]
    sdf = ShardedFFTDemod(fs=10.24e6, freqs_hz=offsets, mesh=mesh)
    iq, n_slots = modulated_capture(offsets, n_t * sdf.seg_len, fs=10.24e6,
                                    seed=11)
    out = sdf.run(iq)
    if out["hard"].shape[0] != n_carriers:
        raise AssertionError(f"fft rung: output {out['hard'].shape}")
    uniq = count_unique_frames(out, n_carriers, n_t,
                               *fft_frame_geometry(sdf))
    if uniq != n_slots:
        raise AssertionError(f"unique frames {uniq} != transmitted slots "
                             f"{n_slots}")
    say(f"dryrun_multichip OK (fft): seg_len={sdf.seg_len}, "
        f"hard={out['hard'].shape}, unique_frames={uniq} == transmitted "
        f"slots={n_slots} (raw sync_hits={out['sync_hits']})")
    return {"unique_frames": uniq, "slots": n_slots,
            "sync_hits": out["sync_hits"]}


def voice_rung(devices, max_devices: int, say=print) -> None:
    """DeviceSpeechPool(mesh=) PCM bit-identical to the single-device pool
    at mesh sizes 1/2/4/8, across a state-carrying second call.  The
    decode is per-row integer arithmetic with no cross-row term, and
    each shard's launch runs on its own device: no collective."""
    from tetraear_tpu_torch.runtime.sharding import Mesh
    from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool

    rng = np.random.default_rng(21)

    def frames(n):
        f = np.zeros((n, 138), np.int16)
        f[:, 1:] = rng.integers(0, 2, (n, 137))
        return f

    items1 = [(c, frames(4)) for c in range(8)]
    items2 = [(c, frames(4)) for c in range(8)]     # state-carry call
    ref = DeviceSpeechPool(slots=8, device=devices[0])
    want = [ref.synthesize(items1), ref.synthesize(items2)]
    sizes = [n for n in (1, 2, 4, 8) if n <= max_devices]
    for n in sizes:
        pool = DeviceSpeechPool(slots=8, mesh=Mesh(devices[:n], ("voice",)))
        got = [pool.synthesize(items1), pool.synthesize(items2)]
        for wa, ga in zip(want, got):
            for w, g in zip(wa, ga):
                if not np.array_equal(w, g):
                    raise AssertionError(
                        f"voice PCM diverged at mesh size {n}")
    n_samp = sum(p.shape[0] for _, p in items1 + items2) * 240
    say(f"voice rung OK: slot axis sharded at mesh sizes {sizes}; "
        f"{n_samp} PCM samples bit-identical to the single-device pool at "
        f"every size; no collective (one decode launch a shard on its own "
        f"device, the PCM rows copied back)")


def crypto_rung(devices, max_devices: int, say=print) -> None:
    """K 6 x B 1024 key search on a payload-sharded mesh, every
    plaintext equal to the host TEADecryptor and the best key to the
    host argmax over the scores."""
    from tetraear_tpu_torch.crypto import batch as cbatch
    from tetraear_tpu_torch.crypto.tea import TEADecryptor
    from tetraear_tpu_torch.runtime.sharding import Mesh

    rng = np.random.default_rng(33)
    B, K, L = 1024, 6, 16
    payloads = rng.integers(0, 256, (B, L), dtype=np.uint8)
    keys = [bytes(rng.integers(0, 256, 10, dtype=np.uint8).tolist())
            for _ in range(K)]
    mesh = Mesh(devices[:max_devices], ("b",))

    plain = cbatch.tea_decrypt_batch(payloads, keys, "TEA1", mesh=mesh)
    if plain.shape != (K, B, L):
        raise AssertionError(f"crypto rung: {plain.shape}")
    for ki, key in enumerate(keys):
        dec = TEADecryptor(key, "TEA1")
        for bi in range(B):
            if plain[ki, bi].tobytes() != dec.decrypt(
                    payloads[bi].tobytes()):
                raise AssertionError(f"device plaintext != host "
                                     f"TEADecryptor at key {ki}, "
                                     f"payload {bi}")
    res = cbatch.tea_key_search(payloads, keys, "TEA1", mesh=mesh)
    if not np.array_equal(res["best_key_index"],
                          np.argmax(res["scores"], axis=0)):
        raise AssertionError("best_key_index != host argmax")
    for bi in range(8):
        ki = int(res["best_key_index"][bi])
        want = TEADecryptor(keys[ki], "TEA1").decrypt(
            payloads[bi].tobytes())
        if res["plaintexts"][bi].tobytes() != want:
            raise AssertionError(f"best plaintext {bi}")
    say(f"crypto rung OK: {K} keys x {B} frames searched on a "
        f"{max_devices}-entry mesh (payload axis sharded, no collective); "
        f"all {K * B} plaintexts EXACTLY equal the host TEADecryptor")


def mesh_label(devices) -> str:
    """The card's name beside a time, and whether shards run serialised
    on one device (a virtual mesh)."""
    dev = [resolve(d) for d in devices]
    if dev[0].type != "cuda":
        return "CPU"
    name = torch.cuda.get_device_name(dev[0])
    if len({str(d) for d in dev}) < len(dev):
        return f"{name}, one card, shards serialised"
    return name


def scaling_table(devices, max_devices: int, say=print) -> list:
    """Partition-overhead table over the time, carrier and 2-D layouts:
    the exact redundant-work ratio (each time shard re-demodulates a
    fixed halo; carrier sharding duplicates nothing) and sync_hits,
    equal across the carrier layouts of one time split.  The capture is
    a fixed 640 ms so each time shard still holds a long segment at 8
    shards."""
    from tetraear_tpu_torch.runtime.sharding import ShardedDemod, make_mesh

    total = 1_536_000                    # 640 ms at 2.4 Msps
    offsets = [(i - 4) * 25_000 + 12_500 for i in range(8)]
    iq, _ = modulated_capture(offsets, total, seed=3)
    label = mesh_label(devices[:max_devices])
    card = label != "CPU"

    def timed(n_c, n_t):
        mesh = make_mesh(n_c, n_t, devices=devices[:n_c * n_t])
        sd = ShardedDemod(fs=2.4e6, freqs_hz=offsets, mesh=mesh,
                          seg_len=total // n_t)
        out = sd.run(iq)                 # warm
        dt = None
        if card:
            dt = 1e9
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = sd.run(iq)
                dt = min(dt, time.perf_counter() - t0)
        work = (total + n_t * sd.halo) / (total + sd.halo)
        return dt, work, out["sync_hits"]

    shapes = [("time", 1, n) for n in (1, 2, 4, 8) if n <= max_devices]
    shapes += [("carrier", n, 1) for n in (2, 4, 8) if n <= max_devices]
    if max_devices >= 8:
        shapes += [("2-D", 2, 4), ("2-D", 4, 2)]
    rows = [(lab, n_c, n_t, *timed(n_c, n_t)) for lab, n_c, n_t in shapes]
    say("# scaling (fixed 640 ms capture, 8 carriers"
        + (f"; wall time on {label})" if card else ")"))
    say("# layout   carrier x time  redundant_work(t)  sync_hits"
        + ("  wall_ms" if card else ""))
    for lab, n_c, n_t, dt, work, hits in rows:
        say(f"#  {lab:8s}      {n_c} x {n_t}    {work:17.3f}  {hits:9d}"
            + (f"  {dt * 1e3:7.2f}" if card else ""))
    # carrier sharding duplicates nothing: layouts with the same time
    # split see the same hits (raw hits count a sync word in a time halo
    # twice, so they may grow with the time split)
    by_time: dict = {}
    for lab, n_c, n_t, _dt, _work, hits in rows:
        by_time.setdefault(n_t, set()).add(hits)
    if any(len(h) != 1 for h in by_time.values()):
        raise AssertionError(f"sync_hits differ across carrier layouts: "
                             f"{[(r[0], r[1], r[2], r[5]) for r in rows]}")
    return [{"layout": lab, "carrier": n_c, "time": n_t,
             "redundant_work": work, "sync_hits": hits,
             "wall_ms": None if dt is None else dt * 1e3}
            for lab, n_c, n_t, dt, work, hits in rows]


def dryrun_multichip(n_devices: int, devices=None, say=print) -> dict:
    """Run every rung over an n_devices mesh of ``devices`` (default:
    every visible card)."""
    from tetraear_tpu_torch.runtime import distributed
    from tetraear_tpu_torch.runtime.sharding import visible_devices

    devices = visible_devices() if devices is None else [
        resolve(d) for d in devices]
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    devices = devices[:n_devices]
    n_c, n_t = _layout(n_devices)
    res = {"conv": conv_rung(devices, n_c, n_t, say),
           "fft": fft_rung(devices, n_c, n_t, say)}
    voice_rung(devices, n_devices, say)
    crypto_rung(devices, n_devices, say)
    res["scaling"] = scaling_table(devices, n_devices, say)
    # the multi-process entry is importable and a clean no-op without
    # the TETRAEAR_* variables
    if distributed.init_distributed() not in (False, True):
        raise AssertionError("init_distributed")
    say("distributed: single-process no-op OK (TETRAEAR_COORDINATOR / "
        "NUM_PROCESSES / PROCESS_ID for several processes)")
    return res


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if args else None
    if "--cpu" in sys.argv:
        dryrun_multichip(n or 8, devices=["cpu"] * (n or 8))
    else:
        from tetraear_tpu_torch.runtime.sharding import visible_devices
        devs = visible_devices()
        dryrun_multichip(min(8, n or len(devs)), devices=devs)
