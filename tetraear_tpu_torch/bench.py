"""Benchmark: real-time TETRA carriers per card (the port's ``bench``).

    python -m tetraear_tpu_torch bench              # C=20480, both modes
    BENCH_CARRIERS=1024 python -m tetraear_tpu_torch bench
    BENCH_CARRIERS=8 BENCH_STEPS=2 python -m tetraear_tpu_torch bench \\
        --device cpu                                # the plain versions

The counterpart of the JAX package's root ``bench.py``, chain for
chain.  The headline is end to end, IQ -> CRC-checked frame candidates:
one chained block step runs the whole receive chain (the fused one,
``FusedRx.step``, where ``backhalf.try_fused`` accepts the bank, else
the classic bank step and ``frame_scan_packed_even``) on C carriers of
one resident wideband noise block and reduces its verdict planes to two
int32 counters on the device: sync hits (corr >= 0.90) and aligned sync
+ CRC passes (crc_err <= 2).  Beside it, in ``both`` mode, the demod
only chain (the bank step, hard symbols) and the voice chain (every
carrier an active call: sparse hit keys, two 216-symbol voice slots a
carrier through ``viterbi_decode`` and four speech frames a carrier
through ``acelp_decode``, the decoder state carried).

Timing: each chain runs ``steps`` block steps, each step's input the
previous step's state, issued from a Python loop as the port's main
path issues them (no CUDA graph, no torch.compile: the host's issue
time is part of what the port costs).  A chain runs once to warm up,
then once timed; the clock stops only after the host has fetched a
value that depends on the last step's state and counters.

Environment: BENCH_CARRIERS (20480), BENCH_STEPS (20), BENCH_FRONTEND
(fft; conv runs only when asked for), BENCH_MODE (both, e2e, demod,
voice), BENCH_NFFT_CAP (2^26, 0 disables), BENCH_VOICE=0 (no voice
chain in both mode), BENCH_NO_FUSED=1 (the classic chain),
BENCH_TIMEOUT_S (2700, a SIGALRM watchdog).  ``--device`` picks the
device (default: the card; ``cpu`` runs the kernels' plain versions).

Where the port differs from the JAX bench by design:
  * no compile cache: the kernels build at first use into the
    git-ignored build/tetraear_tpu_torch/, as everywhere in the port;
  * no degrade ladder: fused or classic is ``try_fused``'s verdict on the
    geometry or BENCH_NO_FUSED=1, the conv frontend runs only when
    BENCH_FRONTEND=conv asks for it, and a failed chain (a kernel that
    does not build or launch included) is never reported as
    ``degraded``: ``main`` prints the zero line with
    ``"degraded": "fatal: ..."`` so that the last JSON line parses, and
    exits non-zero;
  * without a card and without ``--device cpu`` it raises.

Prints the bootstrap zero line first and the result line last (stdout,
line-buffered), a ``# backend=...`` summary on stderr.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import sys
import threading
import time
import traceback

import numpy as np
import torch

from tetraear_tpu_torch.device import resolve
from tetraear_tpu_torch.dsp import backhalf, framescan, kernels
from tetraear_tpu_torch.dsp import channelizer as chan_mod
from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
from tetraear_tpu_torch.voice import etsi_tables, speech, viterbi

METRIC = "realtime_tetra_carriers_per_chip"
UNIT = ("realtime carriers (25 kHz pi/4-DQPSK, IQ->sync+CRC-checked "
        "frames on device)")
NFFT_CAP = 2 ** 26
HIT_CORR = 0.90               # a sync hit: corr >= 0.90
CRC_OK = 2                    # a CRC pass: crc_err <= 2
VOICE_OFFSETS = (100, 500)    # the two voice slots' first symbols
VOICE_SYMS = 216
MODES = ("both", "e2e", "demod", "voice")

# ordered pairs [2k] frame A, [2k+1] frame B, k over TAB0 | TAB1 | TAB2:
# the inverse permutation puts them back in serial bit order
_INV = np.argsort(np.concatenate([etsi_tables.TAB0, etsi_tables.TAB1,
                                  etsi_tables.TAB2]) - 1)


def bench_fs(n_carriers: int) -> float:
    """The capture rate of a C-carrier bench: the 25 kHz grid plus a 15%
    guard, rounded up to 72 kHz * 2^m (so the channel rate is exactly
    72 kHz and the fused back half needs no resample stage)."""
    needed = max(9.216e6, n_carriers * 25_000 * 1.15)
    return 72_000.0 * 2 ** math.ceil(math.log2(needed / 72_000.0))


def bench_offsets(n_carriers: int) -> list:
    """C carriers on the 25 kHz grid centred on the capture."""
    return [(i - n_carriers // 2) * 25_000 + 12_500
            for i in range(n_carriers)]


def capped_nfft(fs: float, frontend: str = "fft") -> int | None:
    """The nfft override of BENCH_NFFT_CAP (default 2^26, 0 disables):
    where ``choose_nfft`` would pick more, the bank runs the same fused
    kernels on half-size overlap-save blocks, and the carried state
    keeps the blocking decode-equivalent.  None: no override."""
    if frontend != "fft":
        return None
    cap = int(os.environ.get("BENCH_NFFT_CAP", str(NFFT_CAP)))
    if cap and chan_mod.choose_nfft(fs) > cap:
        return cap
    return None


def make_bank(n_carriers: int, block: int | None = None,
              frontend: str = "fft", device=None) -> tuple:
    """(CarrierBankDemod, fs) of the C-carrier bench.  ``device`` is
    resolved here, so that a bench without a card raises before it
    builds anything (None: the card)."""
    resolve(device)
    fs = bench_fs(n_carriers)
    bank = CarrierBankDemod(fs=fs, freqs_hz=bench_offsets(n_carriers),
                            block_len=block, frontend=frontend,
                            nfft=capped_nfft(fs, frontend))
    return bank, fs


def noise_block(block_len: int, device) -> tuple:
    """The bench's input: complex Gaussian noise from seed 0, as (x_r
    (N, 2) [re, im] for the bank step, x_p planar (2, N) for the fused
    step) float32 on ``device``."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(block_len)
         + 1j * rng.standard_normal(block_len)).astype(np.complex64)
    dev = resolve(device)
    return (torch.from_numpy(kernels.c2r_np(x)).to(dev),
            torch.from_numpy(kernels.c2p_np(x)).to(dev))


def _zero(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=dev)


def scan_counters(corr: torch.Tensor, crc_err: torch.Tensor,
                  nhit: torch.Tensor, nok: torch.Tensor) -> tuple:
    """Add a step's verdicts to the int32 counters: sync hits, and sync
    hits whose frame (216 bits earlier: TS_OFFSET_BITS // 2 even
    positions) passes the CRC."""
    off = framescan.TS_OFFSET_BITS // 2
    hits = corr >= HIT_CORR
    span = min(hits.shape[1] - off, crc_err.shape[1])
    sync_al = hits[:, off:off + span]
    crc_al = crc_err[:, :span]
    nhit = nhit + hits.sum(dtype=torch.int32)
    nok = nok + (sync_al & (crc_al <= CRC_OK)).sum(dtype=torch.int32)
    return nhit, nok


def chain_demod(bank, x_r: torch.Tensor, state: dict, n: int) -> dict:
    """n bank steps (the classic chain without the scan).  Returns the
    state and ``tails``: (n, C) uint8, each step's first hard symbol."""
    tails = []
    for _ in range(n):
        out, state = bank._step_impl(x_r, state)
        tails.append(out["hard"][:, 0])
    return {"state": state, "tails": torch.stack(tails)}


def chain_e2e_fused(fused, x_p: torch.Tensor, state: dict, n: int) -> dict:
    """n fused block steps with the scan counters."""
    nhit = nok = _zero(x_p.device)
    for _ in range(n):
        out, state = fused.step(x_p, state)
        nhit, nok = scan_counters(out["corr"], out["crc_err"], nhit, nok)
    return {"state": state, "nhit": nhit, "nok": nok}


def chain_e2e(bank, x_r: torch.Tensor, state: dict, tail: torch.Tensor,
              n: int) -> dict:
    """n classic block steps (bank step, bit interleave onto the carried
    1200-bit tail, the even-position scan, the tail slide) with the scan
    counters."""
    nhit = nok = _zero(x_r.device)
    for _ in range(n):
        scan, state, tail, _, _ = backhalf.block_step_scan(bank, x_r, state,
                                                           tail)
        nhit, nok = scan_counters(scan["corr"], scan["crc_err"], nhit, nok)
    return {"state": state, "tail": tail, "nhit": nhit, "nok": nok}


def unbuild_index(device) -> torch.Tensor:
    """unbuild's gather index on ``device``: frame A's serial bits sit at
    ordered[:, idx], frame B's at ordered[:, idx + 1]."""
    return torch.from_numpy(2 * _INV).to(device)


def unbuild(ordered: torch.Tensor, bfi: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """(B, 286) channel decoder output + (B,) BFI -> (B, 2, 138) int32
    speech frames [BFI + 137 serial bits]; ``idx`` from unbuild_index."""
    fr = torch.stack([ordered[:, idx], ordered[:, idx + 1]],
                     dim=1).to(torch.int32)
    b = bfi[:, None, None].to(torch.int32).expand(fr.shape[0], 2, 1)
    return torch.cat([b, fr], dim=2)


def voice_batch(fused, soft_planes: torch.Tensor) -> torch.Tensor:
    """A step's soft planes -> the (2C, 432) int32 channel decoder batch:
    two voice slots a carrier (VOICE_OFFSETS; rows c and C + c are
    carrier c's), soft bits * 127 rounded."""
    soft = fused.soft_symbols(soft_planes)
    sb = torch.cat([soft[:, o:o + VOICE_SYMS] for o in VOICE_OFFSETS],
                   dim=0)
    return torch.round(sb.reshape(sb.shape[0], 2 * VOICE_SYMS)
                       * 127.0).to(torch.int32)


def voice_frames(ordered: torch.Tensor, bfi: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """The channel decoder's (2C, 286) output + BFI -> (C, 4, 138) int32
    speech frames, a carrier's two slots in order."""
    c = ordered.shape[0] // 2
    return torch.cat([unbuild(ordered[:c], bfi[:c], idx),
                      unbuild(ordered[c:], bfi[c:], idx)], dim=1)


def chain_voice(fused, x_p: torch.Tensor, state: dict,
                sstate: speech.SpeechState, n: int) -> dict:
    """n fused block steps with every carrier an active call: the scan
    counters, the sparse hit keys, two voice slots a carrier (soft
    symbols from VOICE_OFFSETS, * 127 rounded to int32) through
    ``viterbi.decode`` as one (2C, 432) batch, and their four speech
    frames a carrier, all valid, through ``speech.decode_block`` with
    the decoder state carried.  ``pacc`` sums each step's first PCM
    sample of every frame, the first carrier's best hit key and its hit
    count (int32, wrapping), so that the last fetch depends on all of
    it.  Returns the states, the counters, the last step's PCM and its
    channel decoder batch."""
    dev = x_p.device
    c = fused.bank.n_carriers
    nhit = nok = pacc = _zero(dev)
    valid = torch.ones((c, 4), dtype=torch.bool, device=dev)
    idx = unbuild_index(dev)
    pcm = sb = None
    for _ in range(n):
        out, state = fused.step(x_p, state)
        nhit, nok = scan_counters(out["corr"], out["crc_err"], nhit, nok)
        keys, counts = framescan.sparse_hits(out["corr"], out["crc_err"],
                                             framescan.SPARSE_K)
        sb = voice_batch(fused, out["soft_planes"])
        ordered, bfi = viterbi.decode(sb)
        sstate, pcm = speech.decode_block(sstate,
                                          voice_frames(ordered, bfi, idx),
                                          valid)
        pacc = pacc + pcm[:, :, 0].sum(dtype=torch.int32)
        pacc = pacc + keys[0, 0] + counts[0]
    return {"state": state, "sstate": sstate, "nhit": nhit, "nok": nok,
            "pacc": pacc, "pcm": pcm, "soft_batch": sb}


def time_chain(chain, args_fn, fetch) -> tuple:
    """Run ``chain(*args_fn())`` once to warm up, then time a second run;
    ``fetch`` reads a value of the run's last state and counters to the
    host, which stops the clock.  Returns (seconds, the timed run's
    fetched values)."""
    fetch(chain(*args_fn()))
    t0 = time.perf_counter()
    got = fetch(chain(*args_fn()))
    return time.perf_counter() - t0, got


def run_bench(n_carriers: int = 256, block: int | None = None,
              steps: int = 20, frontend: str = "fft", mode: str = "both",
              device=None) -> dict:
    """Time the chains ``mode`` names at C = ``n_carriers`` and return the
    result: the JAX bench's keys, plus ``counters`` (each chain's fetched
    nhit / nok / pacc, or the demod chain's timing and symbol) as a
    diagnostic.  Any failure raises."""
    if mode not in MODES:
        raise ValueError(f"BENCH_MODE {mode!r}: one of {MODES}")
    dev = resolve(device)
    bank, fs = make_bank(n_carriers, block, frontend, dev)
    block = bank.block_len
    block_s = block / fs
    x_r, x_p = noise_block(block, dev)
    res = {
        "n_carriers": n_carriers,
        "backend": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else str(dev)),
        "block_s": block_s,
        "steps": steps,
        "nfft": bank.channelizer.nfft if bank.channelizer else None,
        "counters": {},
    }

    def timed(name, chain, args_fn, fetch):
        elapsed, got = time_chain(chain, args_fn, fetch)
        res["counters"][name] = got
        return elapsed

    def run_demod():
        elapsed = timed(
            "demod", chain_demod,
            lambda: (bank, x_r, bank.init_state(dev), steps),
            lambda o: {"next_t0": o["state"]["timing"]["next_t"][0].item(),
                       "hard0": int(o["tails"][-1, 0].item())})
        res["demod_rt_factor"] = steps * block_s / elapsed
        res["demod_carriers_rt"] = res["demod_rt_factor"] * n_carriers
        res["demod_elapsed_s"] = elapsed

    def counters(o):
        bank_state = o["state"].get("bank", o["state"])   # fused: nested
        got = {"next_t0": bank_state["timing"]["next_t"][0].item(),
               "nhit": int(o["nhit"].item()), "nok": int(o["nok"].item())}
        if "pacc" in o:
            got["pacc"] = int(o["pacc"].item())
        return got

    if mode == "demod":
        run_demod()

    # fused or classic is the geometry's verdict (or BENCH_NO_FUSED=1),
    # never a fallback from a failed fused chain: that one raises
    fused = None
    reason = "BENCH_NO_FUSED=1"
    if os.environ.get("BENCH_NO_FUSED") != "1":
        fused, reason = backhalf.try_fused(bank, dev)
    res["fused_reason"] = reason

    def run_voice():
        elapsed = timed(
            "voice", chain_voice,
            lambda: (fused, x_p, fused.init_state(),
                     speech.init_state(n_carriers, dev), steps),
            counters)
        res["voice_rt_factor"] = steps * block_s / elapsed
        res["voice_carriers_rt"] = res["voice_rt_factor"] * n_carriers
        res["voice_elapsed_s"] = elapsed
        from tetraear_tpu_torch.runtime import profiling
        # the ceiling is the card's integer issue rate (a basic operation
        # an integer instruction), not a rate acelp_decode was measured
        # at: a share of a measured rate can pass 100.  The model counts
        # the speech decoder's operations only, while the chain also
        # runs the fused step and the channel decoder
        res["voice_model"] = profiling.voice_roofline(
            n_carriers, block_s, rt_factor=res["voice_rt_factor"],
            eff_ops_per_s=(profiling.N_SMS * profiling.ISSUE_PER_CLK_SM
                           * profiling.SM_CLOCK_HZ))

    def roofline():
        # the H100's roofline says nothing of a run on the CPU
        if dev.type == "cuda":
            from tetraear_tpu_torch.runtime.profiling import \
                roofline_fraction
            res["roofline"] = roofline_fraction(
                n_carriers, fs, res["rt_factor"], frontend=frontend)

    if mode == "voice":
        if fused is None:
            raise RuntimeError(f"voice bench mode needs the fused path "
                               f"({reason})")
        run_voice()
        res["rt_factor"] = res["voice_rt_factor"]
        res["carriers_rt"] = res["voice_carriers_rt"]
        res["elapsed_s"] = res["voice_elapsed_s"]
        res["input_msps"] = steps * block / res["elapsed_s"] / 1e6
        roofline()
        return res

    if mode in ("e2e", "both"):
        if fused is not None:
            variant = "fused"
            elapsed = timed(
                "e2e", chain_e2e_fused,
                lambda: (fused, x_p, fused.init_state(), steps), counters)
        else:
            variant = "classic"
            elapsed = timed(
                "e2e", chain_e2e,
                lambda: (bank, x_r, bank.init_state(dev),
                         torch.zeros((n_carriers, backhalf.TAILBITS),
                                     dtype=torch.uint8, device=dev),
                         steps), counters)
        res["e2e_variant"] = variant
        res["rt_factor"] = steps * block_s / elapsed
        res["carriers_rt"] = res["rt_factor"] * n_carriers
        res["elapsed_s"] = elapsed
        res["input_msps"] = steps * block / elapsed / 1e6
        roofline()
        if mode == "both":
            run_demod()
            if fused is not None and os.environ.get("BENCH_VOICE") != "0":
                run_voice()
    else:
        res["rt_factor"] = res["demod_rt_factor"]
        res["carriers_rt"] = res["demod_carriers_rt"]
        res["elapsed_s"] = res["demod_elapsed_s"]
        res["input_msps"] = steps * block / res["elapsed_s"] / 1e6
    return res


def zero_line(degraded: str) -> dict:
    """The line printed first (a run that dies leaves it last) and on a
    failure: value 0 and why."""
    return {"metric": METRIC, "value": 0.0, "unit": UNIT,
            "vs_baseline": 0.0, "degraded": degraded}


def bench_line(r: dict, mode: str) -> dict:
    """The result line of a run_bench result, key for key the JAX bench's:
    ``value`` is capacity (rt_factor x C, the per-carrier rate taken to a
    whole card); ``concurrent_carriers`` is the C that really ran, and
    only when it ran in real time (rt_factor >= 1), else 0."""
    value = float(r["carriers_rt"])
    line = {
        "metric": METRIC,
        "value": round(value, 1),
        "unit": UNIT,
        "vs_baseline": round(value / 1.0, 1),
        "concurrent_carriers": (int(r["n_carriers"])
                                if float(r.get("rt_factor", 0.0)) >= 1.0
                                else 0),
        "rt_factor": round(float(r.get("rt_factor", 0.0)), 3),
    }
    if "e2e_variant" in r:
        line["e2e_variant"] = r["e2e_variant"]
    if "demod_carriers_rt" in r and mode == "both":
        line["demod_only_carriers"] = round(float(r["demod_carriers_rt"]), 1)
    if "voice_carriers_rt" in r:
        line["voice_carriers_rt"] = round(float(r["voice_carriers_rt"]), 1)
    if "voice_model" in r:
        vm = r["voice_model"]
        line["voice_model_carriers_rt"] = round(
            float(vm["model_voice_carriers_rt"]), 1)
        line["voice_model_pct"] = round(
            float(vm.get("voice_model_pct", 0.0)), 1)
    if "roofline" in r:
        rl = r["roofline"]
        line["roofline_pct"] = round(rl["roofline_pct"], 2)
        line["roofline_measured_pct"] = round(
            rl.get("roofline_measured_pct", rl["roofline_pct"]), 2)
        if "measured_gbs" in rl:
            line["measured_gbs"] = rl["measured_gbs"]
            line["measured_gbs_source"] = rl["measured_gbs_source"]
    return line


def summary(r: dict) -> str:
    """The ``# backend=...`` line (stderr)."""
    extra = (f" demod_only={r['demod_carriers_rt']:.0f}"
             if "demod_carriers_rt" in r else "")
    if "roofline" in r:
        rl = r["roofline"]
        extra += (f" roofline={rl['roofline_pct']:.1f}%"
                  f" ({rl['bound']}-bound model:"
                  f" {rl['achieved_tflops']:.2f} TF/s,"
                  f" {rl['achieved_gbs']:.0f} GB/s)")
    return (f"# backend={r['backend']} n_carriers={r['n_carriers']} "
            f"rt_factor={r['rt_factor']:.1f} input={r['input_msps']:.0f} "
            f"Msps elapsed={r['elapsed_s']:.2f}s steps={r['steps']}{extra}")


def main(argv=None) -> int:
    """Run the bench as the environment says; 0 after the result line, 1
    after the fatal zero line."""
    p = argparse.ArgumentParser(
        prog="python -m tetraear_tpu_torch bench",
        description="real-time TETRA carriers per card (BENCH_* in the "
                    "environment)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' "
                        "runs the kernels' plain versions)")
    args = p.parse_args(argv)
    dev = resolve(args.device)
    n_carriers = int(os.environ.get("BENCH_CARRIERS", "20480"))
    steps = int(os.environ.get("BENCH_STEPS", "20"))
    frontend = os.environ.get("BENCH_FRONTEND", "fft")
    mode = os.environ.get("BENCH_MODE", "both")
    # covers the kernels' first build (nvcc, one compile a source in
    # parallel; no compile cache beyond build/tetraear_tpu_torch/) as
    # well as the chains
    budget_s = int(os.environ.get("BENCH_TIMEOUT_S", "2700"))

    def alarm(signum, frame):
        raise TimeoutError(f"bench exceeded {budget_s}s budget")

    # line-buffered, and a zero line first: a run that dies leaves a
    # parseable last line that says so
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    print(json.dumps(zero_line(
        "bootstrap sentinel: bench died before reporting")), flush=True)
    watchdog = threading.current_thread() is threading.main_thread()
    if watchdog:
        old = signal.signal(signal.SIGALRM, alarm)
        signal.alarm(budget_s)
    try:
        r = run_bench(n_carriers=n_carriers, steps=steps,
                      frontend=frontend, mode=mode, device=dev)
    except Exception as e:
        # no ladder: any failed chain, a kernel that does not build or
        # launch included, ends the run with this line and exit 1
        print(json.dumps(zero_line(f"fatal: {type(e).__name__}: {e}"[:300])),
              flush=True)
        traceback.print_exc()
        print(f"# bench failed: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        return 1
    finally:
        if watchdog:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old)
    print(json.dumps(bench_line(r, mode)), flush=True)
    print(summary(r), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
