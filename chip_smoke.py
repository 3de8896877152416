#!/usr/bin/env python3
"""Smoke test of tetraear_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the checkout's sources and drives the
port's receive path on the card in phases, one line per result:

  1. the card: name and power limit (nvidia-smi);
  2. build: nvcc time and the kernels' register / shared-memory use;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     same inputs at the C=1024 (36.864 MHz) and C=10240 (294.912 MHz)
     geometries, with the error, the tolerance and both times;
  4. decode small: Pipeline.run_offline on a golden 8-carrier capture at
     2.304 MHz on the card and on the CPU; the frames must be equal and
     carry the transmitted SDS texts;
  5. decode at fleet size: Pipeline.run_offline at C=1024 / 36.864 MHz
     with modulated carriers spread over the band (the launch counts of
     this run are reported), then ms/block and the realtime factor of
     the chained block step at C=1024 and C=10240.

The last two lines are one JSON object of kernel results and the
result line {"ok": true, "device": {...}}.  Any failed phase exits
non-zero before the result line; so does a machine without a CUDA
device, and a directory without the tetraear_tpu_torch package.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

KERNELS = {
    "fft2p": ("tetraear_tpu_torch/dsp/csrc/fft2p.cu",
              "tetraear_tpu/dsp/pallas_kernels.py:1603"),
    "band_synth": ("tetraear_tpu_torch/dsp/csrc/band_synth.cu",
                   "tetraear_tpu/dsp/pallas_kernels.py:325"),
    "fused_backhalf": ("tetraear_tpu_torch/dsp/csrc/backhalf.cu",
                       "tetraear_tpu/dsp/pallas_kernels.py:1013"),
}
FS_SMALL = 2.304e6
FS_FLEET = 36.864e6
FS_BENCH = 294.912e6


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def grid(c: int) -> list:
    """C carriers on the 25 kHz grid centred on the capture (bench.py)."""
    return [(i - c // 2) * 25_000 + 12_500.0 for i in range(c)]


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> tuple:
    """(max |a - b|, RMS of b) in float64."""
    a = a.double()
    b = b.double()
    return (a - b).abs().max().item(), b.pow(2).mean().sqrt().item()


def phase_kernels(fs: float, c: int, seed: int, reps: int) -> dict:
    """Each kernel vs its plain version at one geometry."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod

    bank = CarrierBankDemod(fs=fs, freqs_hz=grid(c))
    ch = bank.channelizer
    fused = FusedRx(bank, "cuda")
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    res = {}
    n1, n2 = ch.fft2p_n1, ch.fft2p_n2
    o2 = ch.overlap // n1
    tail_p = randn(2, o2, n1)
    x3 = randn(2, n2 - o2, n1)
    args1 = (tail_p, x3, n1, n2, ch.fft2p_wrap)
    got = ck.fft2p_planes_spliced(*args1)
    ref = ck.fft2p_plain(*args1)
    err, rms = max_err(got, ref)
    tol = 1e-4 * rms
    # the unspliced transform (JAX fft2p_planes) is the o2 = 0 case
    win = torch.cat([tail_p, x3], dim=1)
    args1b = (win[:, :0], win, n1, n2, ch.fft2p_wrap)
    err0, _ = max_err(ck.fft2p_planes_spliced(*args1b),
                      ck.fft2p_plain(*args1b))
    res["fft2p"] = {
        "max_abs_err": max(err, err0), "tol": tol,
        "ms": event_ms(lambda: ck.fft2p_planes_spliced(*args1), reps),
        "plain_ms": event_ms(lambda: ck.fft2p_plain(*args1), reps)}
    if not max(err, err0) <= tol:
        fail(f"fft2p C={c}: max err {max(err, err0):.3e} > {tol:.3e}")
    planes = ref

    args2 = (planes, fused.h1_planes, fused.row_start, fused.d_shift,
             fused.m1c, fused.m2re, fused.m2im, fused.twre, fused.twim,
             ch.synth_rows, ch.drop)
    y_k, ph_k = ck.band_synth(*args2)
    y_p, ph_p = ck.band_synth_plain(*args2)
    err_y, rms_y = max_err(y_k, y_p)
    err_ph, _ = max_err(ph_k, ph_p)
    # the phasor is sum_k w_k |y_k|^2 with |w_k| = 1: an error of e*RMS
    # in y moves it by at most ~2e of the band power sum_k |y_k|^2
    band_power = y_p.double().pow(2).sum(dim=(1, 2, 3)).max().item()
    tol_y, tol_ph = 1e-5 * rms_y, 2e-5 * band_power
    res["band_synth"] = {
        "max_abs_err": err_y, "tol": tol_y, "phasor_err": err_ph,
        "phasor_tol": tol_ph,
        "ms": event_ms(lambda: ck.band_synth(*args2), reps),
        "plain_ms": event_ms(lambda: ck.band_synth_plain(*args2), reps)}
    if not (err_y <= tol_y and err_ph <= tol_ph):
        fail(f"band_synth C={c}: y err {err_y:.3e} (tol {tol_y:.3e}), "
             f"phasor err {err_ph:.3e} (tol {tol_ph:.3e})")

    # a mid-stream state: random cycles, symbol clock, tails, bit tail
    state = fused.init_state()
    bk = state["bank"]
    bk["channelizer"]["cycles"] = torch.from_numpy(
        rng.integers(0, min(ch.nfft, 1 << 24), c).astype(np.float32)).to(dev)
    bk["timing"]["next_t"] = torch.from_numpy(
        rng.uniform(1.0, 5.0, c).astype(np.float32)).to(dev)
    bk["timing"]["acc"] = randn(c, 2)
    bk["timing"]["tail"] = randn(c, 4, 2) * 1e-3
    bk["prev_sym"] = randn(c, 2) * 1e-3
    bits = np.zeros((c, 10 * 128), np.float32)
    bits[:, :ck.TAILBITS] = rng.integers(0, 2, (c, ck.TAILBITS))
    state["bit_tail"] = torch.from_numpy(bits.reshape(c, 10, 128)).to(dev)
    ang = bk["channelizer"]["cycles"] * (2 * math.pi) / float(ch.nfft)
    g = fused.glue(ph_p, (torch.cos(ang), -torch.sin(ang)), state)
    args3 = fused.backhalf_args(y_p, g, state)
    out_k = ck.fused_backhalf(*args3)
    out_p = ck.fused_backhalf_plain(*args3, ck.z_rows_for(fused.p))
    names = ("corr", "err", "soft", "bt2", "last", "misc")
    worst = 0.0
    for name, a, b in zip(names, out_k, out_p):
        e, _ = max_err(a, b)
        exact = name in ("corr", "err", "bt2")
        if (exact and e != 0.0) or e > 1e-6:
            fail(f"fused_backhalf C={c}: {name} differs by {e:.3e}")
        worst = max(worst, e)
    res["fused_backhalf"] = {
        "max_abs_err": worst, "tol": 1e-6,
        "ms": event_ms(lambda: ck.fused_backhalf(*args3), reps),
        "plain_ms": event_ms(
            lambda: ck.fused_backhalf_plain(*args3,
                                            ck.z_rows_for(fused.p)), reps)}
    torch.cuda.synchronize()
    for name, r in res.items():
        say(f"kernel {name} C={c}: max_abs_err {r['max_abs_err']:.3e} "
            f"(tol {r['tol']:.3e}), kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms")
    return res


def frames_key(frames: list) -> list:
    return [(f["carrier"], f["stream_symbol"], bool(f.get("burst_crc")),
             f.get("sds_message")) for f in frames]


def run_pipeline(iq, fs: float, offsets: list, device: str,
                 blocks_per_dispatch: int) -> tuple:
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.golden import ArraySource
    frames = []
    pipe = Pipeline(PipelineConfig(sample_rate=fs,
                                   carrier_offsets_hz=tuple(offsets),
                                   validate=False, device=device),
                    on_frame=frames.append)
    stats = pipe.run_offline(ArraySource(iq, fs),
                             blocks_per_dispatch=blocks_per_dispatch)
    return frames, stats, pipe


def phase_decode_small() -> None:
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.golden import fleet_capture
    offsets = grid(8)
    bl = CarrierBankDemod(fs=FS_SMALL, freqs_hz=offsets).block_len
    iq = fleet_capture(FS_SMALL, offsets, range(8), 3 * bl, seed=7,
                       text="SMALL")
    f_gpu, _, _ = run_pipeline(iq, FS_SMALL, offsets, "cuda", 2)
    f_cpu, _, _ = run_pipeline(iq, FS_SMALL, offsets, "cpu", 2)
    if frames_key(f_gpu) != frames_key(f_cpu):
        fail(f"decode small: card frames ({len(f_gpu)}) differ from the "
             f"CPU run ({len(f_cpu)})")
    good = {f["carrier"] for f in f_gpu
            if f.get("burst_crc")
            and f.get("sds_message") == f"[TXT] SMALL {f['carrier']}"}
    if len(good) != 8:
        fail(f"decode small: SDS text recovered on carriers {sorted(good)}")
    n_crc = sum(1 for f in f_gpu if f.get("burst_crc"))
    say(f"decode small: {len(f_gpu)} frames, {n_crc} CRC pass, SDS text "
        f"on all 8 carriers, equal to the CPU run")


def phase_decode_fleet() -> dict:
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.golden import fleet_capture
    c = 1024
    offsets = grid(c)
    active = [5, 170, 341, 512, 683, 854, 1019]
    bl = CarrierBankDemod(fs=FS_FLEET, freqs_hz=offsets).block_len
    t0 = time.time()
    iq = fleet_capture(FS_FLEET, offsets, active, 2 * bl, seed=11)
    say(f"decode fleet: capture of {len(active)} carriers over 2 blocks "
        f"made in {time.time() - t0:.1f} s")
    ck.reset_launches()
    t0 = time.time()
    frames, stats, pipe = run_pipeline(iq, FS_FLEET, offsets, "cuda", 2)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(ck.launches)
    if min(counts.values()) == 0:
        fail(f"decode fleet: a kernel was never launched: {counts}")
    good = {f["carrier"] for f in frames
            if f.get("burst_crc")
            and f.get("sds_message") == f"[TXT] FLEET {f['carrier']}"}
    if good != set(active):
        fail(f"decode fleet: SDS text on carriers {sorted(good)}, "
             f"expected {active}")
    # idle carriers carry noise, where the soft CRC (<= 2 bit errors)
    # passes by chance as in the reference; no CRC-passing frame may
    # show another carrier's text
    wrong = [f for f in frames if f.get("burst_crc")
             and str(f.get("sds_message", "")).startswith("[TXT] FLEET")
             and f.get("sds_message") != f"[TXT] FLEET {f['carrier']}"]
    if wrong:
        fail(f"decode fleet: {len(wrong)} texts on the wrong carrier")
    say(f"decode fleet C={c}: {stats.frames} frames, {stats.crc_pass} CRC "
        f"pass, SDS text on carriers {sorted(good)}; launches {counts}; "
        f"wall {wall:.2f} s incl. first-call setup")
    return counts


def phase_chain(fs: float, c: int, n_blocks: int, seed: int,
                kern: dict) -> dict:
    """bench.py chain_e2e_fused: FusedRx.step + sparse_hits over
    n_blocks on one resident noise block; fetch a value of the last."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp import framescan
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    bank = CarrierBankDemod(fs=fs, freqs_hz=grid(c))
    fused = FusedRx(bank, "cuda")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (2, bank.block_len)).astype(np.float32)).cuda()

    def chain(state, n):
        total = None
        for _ in range(n):
            out, state = fused.step(x, state)
            keys, counts = framescan.sparse_hits(out["corr"],
                                                 out["crc_err"])
            total = counts.sum()
        return state, int(total.item())

    state, _ = chain(fused.init_state(), 1)          # warm-up
    torch.cuda.synchronize()
    before = dict(ck.launches)
    t0 = time.time()
    state, hits = chain(state, n_blocks)
    wall = (time.time() - t0) / n_blocks
    rose = {k: ck.launches[k] - before[k] for k in before}
    if rose != {"fft2p": n_blocks, "band_synth": n_blocks,
                "fused_backhalf": n_blocks}:
        fail(f"chain C={c}: kernel launches {rose} for {n_blocks} blocks")
    block_s = bank.block_len / fs
    kern_ms = sum(kern[k]["ms"] for k in KERNELS)
    r = {"ms_per_block": wall * 1e3, "rt_factor": block_s / wall,
         "block_ms": block_s * 1e3,
         "split_ms": {**{k: kern[k]["ms"] for k in KERNELS},
                      "glue_sparse_launch": wall * 1e3 - kern_ms}}
    say(f"chain C={c}: {r['ms_per_block']:.3f} ms/block for "
        f"{r['block_ms']:.3f} ms of signal, rt_factor "
        f"{r['rt_factor']:.3f}; split {json.dumps(r['split_ms'])}; "
        f"last-block hit count {hits}")
    return r


def main() -> int:
    if not (ROOT / "tetraear_tpu_torch" / "dsp" / "csrc").is_dir():
        print("chip_smoke.py: run it from the root of a tetraear checkout "
              "(tetraear_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    t0 = time.time()
    ck.build()
    say(f"build: {time.time() - t0:.1f} s ({ck.build_info['path']})")
    for line in ck.build_info.get("log", "").splitlines():
        if "Used" in line or "spill" in line:
            say(f"  ptxas {line.strip()}")

    kern = phase_kernels(FS_FLEET, 1024, seed=1, reps=20)
    kern_big = phase_kernels(FS_BENCH, 10240, seed=2, reps=5)
    phase_decode_small()
    counts = phase_decode_fleet()
    chain_1024 = phase_chain(FS_FLEET, 1024, 5, 3, kern)
    chain_10240 = phase_chain(FS_BENCH, 10240, 5, 4, kern_big)
    if "jax" in sys.modules:
        fail("jax was imported")

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": kern[name]["max_abs_err"],
            "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
            "shape": "C=1024 fs=36.864MHz",
            "max_abs_err_c10240": kern_big[name]["max_abs_err"],
            "ms_c10240": kern_big[name]["ms"],
            "plain_ms_c10240": kern_big[name]["plain_ms"]})
    say(json.dumps({"kernels": kernels,
                    "chain": {"c1024": chain_1024, "c10240": chain_10240},
                    "card": card}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
