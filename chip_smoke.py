#!/usr/bin/env python3
"""Smoke test of tetraear_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the checkout's sources and drives the
port's receive paths on the card in phases, one line per result:

  1. the card: name and power limit (nvidia-smi);
  2. build: g++ time of the native frame parser and the voice codec (the
     run fails unless the native parser loads), nvcc time and the
     kernels' register / shared-memory use;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     same inputs at the C=1024 (36.864 MHz) and C=10240 (294.912 MHz)
     geometries, with the error, the tolerance, the times of kernel,
     plain version and (where one exists) the single PyTorch call that
     computes the same function, and the bound: the least time the card
     could take, from the bytes moved and the operations done (integer
     work at the card's integer instruction rates, which a register-only loop
     confirms); then the redesigned kernels at the other geometries the
     paths use: fft2p at nfft 2^14 and 2^18 with and without splice and
     wrap rows, fused_backhalf at C=8 / 2.304 MHz with 0, half and all
     symbols valid, band_synth's three forms at n_band 512, 2048 and
     16384, frame_scan_even at the edge lengths of its planes, the two
     extraction kernels at edge shapes and on three real grids' starts
     (the fleet-aligned rows at C=1024; pairs of n_band 64 on the decode
     element bank, C=2, and on the 61.44 MHz grid, C=2457) with the
     launch alone timed; each extraction wrapper
     is called once under torch.cuda.set_sync_debug_mode("error"), so a
     host synchronisation on its launch path fails the run;
  4. decode small: Pipeline.run_offline on a golden 8-carrier capture at
     2.304 MHz on the card and on the CPU (fused path);
  5. decode fleet: Pipeline.run_offline at C=1024 / 36.864 MHz on the
     fused path, modulated carriers spread over the band;
  6. decode rtl: Pipeline.run_offline with the defaults (2.4 Msps, conv
     frontend, AFC) on the off-air fixture, conv and fft frontends, on
     the card and on the CPU;
  7. decode fleet-afc and fleet-aligned: the classic chain at C=1024 on
     the same 36.864 MHz capture (its CRC-passing frames must equal the
     fused path's) and on a 40.96 MHz capture (aligned grid; default
     synthesis kernel, then the row-extraction kernel), a small run
     through the element-extraction kernel, and the probes: the
     phasor-only synthesis as a pre-pass, fft2p's pass 1 alone taken
     through a plain pass 2, the back half's bit placement alone on a
     fused block's decisions, the elementwise operations, and the serial
     recursion inside one kernel against its host-driven form;
  8. chain: ms/block and the realtime factor of the chained block step
     on a resident noise block, fused (C=1024, C=10240) and classic
     (fleet-afc, fleet-aligned, bench-afc), with launches per block.

Voice: viterbi_decode against its plain version at B = 8192 and 81920
(and the C++ decoder on 256 blocks), at the corner batch sizes, the
call and the launch alone, the floor (B = 1, 2) and every launch of the
voice fleet timed; speech, acelp_decode against its
plain version (PCM and every state leaf) and the C++ decoder at S = 256
and 2048 decoder slots x 4 frames, two calls that carry the state, with
saturating states and frames in some slots, beside the host C++ codec's
time on the same frames (one core and a thread a core), the bound from
the ETSI basic operations the frames need (frame_ops, a counting build
of the C++ codec) and a critical-path floor (the synthesis filter's
clocks a subframe, timed alone by the synth_chain probe), then the call
and the launch alone over 1 to 16896 slots; voice fleet, 16 voice
carriers at C=1024 on the fused path through process_block with host
synthesis (unsplit with sequential synthesis, and split by a checkpoint
with two synthesis threads): every voice carrier's parameters equal to
the encoder's, its PCM equal to a fresh host decoder's, both runs equal,
every viterbi_decode launch held against the plain version on its
inputs; voice fleet device, the same with synthesis on the card
(device_voice=True), unsplit and split equal to host synthesis, every
acelp_decode launch held against the plain version, the synthesis pass
split into the launches' device time and the host's, the largest launch
timed alone; and with 8 decoder slots each evicted carrier's PCM equal
to a host decoder restarted with it; voice rtl, two voice carriers on
the classic chain through run_offline, the card's PCM with host and with
device synthesis equal to the CPU run's.

Beside these: tea, the key search (tea_search) against its plain version
in its three modes at a large deferred decryption and a bruteforce sweep
and at the corners, and again at each deferred search the fused stream
made (one launch a block for both cipher families: the call, the launch
alone, the round trip of upload, launch and fetch, and the floor at
K = B = W = 1); the fleet capture carries TEA1 and
TEA2 carriers, decrypted on every fleet path; stream, the live path
(Pipeline.process_block, a checkpoint after block 2 onto a fresh
Pipeline) fused and classic with two frame workers, each held against
run_offline on the same frame layer; and process_block's time split by
part at C=1024 and C=10240, in process and with 2 and 4 frame workers.

Sharding and the scanners (one card: each mesh is a virtual one, its
entries naming the card and its shards run one after the other, so its
wall time is no scaling figure): sharded conv, the multi-device dry
run's conv rung (runtime/multichip.py) on a 2 x 2 mesh (and over all
cards when there are several), unique frames equal to the transmitted
slots; sharded fft, ShardedFFTDemod at C=1024 on the fleet grid
(36.864 MHz, band_extract) and the fleet-aligned grid (40.96 MHz,
band_extract_rows), 7 carriers modulated: unique frames equal the slots
on the (1, 2), (2, 2) and (4, 2) meshes with equal sync_hits, the
largest soft difference across layouts printed, then the (2, 2) step
timed (ms a mesh step and a shard's front and back, host time, launches,
redundant work); at C=10240 (294.912 MHz, noise) the carrier layouts
checked and the step timed; at 2.304 MHz, C=8, the card equal to the
CPU; nccl one rank, init_distributed with a group of one (its own
process) and the sharded step's all-reduce on NCCL, equal to the run
without a group; voice mesh, DeviceSpeechPool(mesh=) at 1/2/4 over 256
slots, bit-equal to the unsharded pool across calls and a restored
checkpoint, acelp_decode launched once a shard with active rows; crypto
mesh, the dry run's crypto rung on a mesh of 4 (tea_search a shard);
scan wideband, WidebandScanner on a 2.4 Msps capture on the card, equal
to the CPU run, band_synth_y launched, the scan timed.

The tools and profiling (runtime/profiling.py): tools, the port's tools
as a user runs them (their main, as the CLI dispatches them), each on
the card and with --device cpu, the outputs equal: continuous-capture
and decrypt-capture on a 2.4 Msps capture of TEA1 and TEA2 SDS slots
(the classic conv chain: frame_scan_even; each block's deferred search:
tea_search), bruteforce-keys over the encrypted frames continuous-capture
recorded with the 228 common keys (exactly one tea_search launch, the
texts among the candidates), then timed with the common keys and 4,096
seeded ones over 50 frames (the tool's wall time, its key-search call,
the launch alone, the host scoring loop), listen-clear and auto-capture
on the synthetic voice source, verify-codec; profiling, measure_hbm_gbs
at 1 and 4 GiB (the 1 GiB rate kept for this card in
build/tetraear_tpu_torch/), roofline_fraction of the fused chain at
C=1024 and C=10240, voice_roofline at the rate the speech phase measured,
and the Profiler around one fused step at C=1024, whose Chrome trace
must name fft2p, band_synth and fused_backhalf.

The UI and the examples: ui, the PyQt6 window (ui/qt.py over
tests/unit/qt_stub.py, as the machine has no PyQt6) at its users' size,
2.4 Msps in blocks of 130,800 samples (54.5 ms): on_start with its
source redirected to a capture, then the capture thread's run on a
threading.Thread, over the tools' 24-slot SDS capture (TEA1 and TEA2,
auto-decrypt: frame_scan_even, tea_search; the kernel library compiled
anew by the capture thread) and a synthetic-voice capture with REC and
raw FM on (device synthesis: viterbi_decode, acelp_decode), each
against device="cpu" (frames, table cells, PCM, WAVs) with no "error:"
status; process_block's ms a block in the capture thread against the
block's 54.5 ms, the window's slots' share of it, the time to the first
frame; the dashboard (a stub screen) over the synthetic voice source on
a worker thread against the CPU, a draw timed; examples, each of the
port's examples on the card and with --device cpu, outputs and the voice
WAV equal, each one's wall time.

The bench (tetraear_tpu_torch/bench.py): ``python -m tetraear_tpu_torch
bench`` in its own process, as its users run it, at C=1024 and 10240
(both modes), the default C=20480 (both modes, no environment set),
C=40960 (e2e; the nfft cap runs half-size blocks of 2^26) and C=1024
with BENCH_NO_FUSED=1 (the classic chain): each last line parses, has
no "degraded", rt_factor > 0 and the expected e2e variant; then in this
process each chain at C=1024 (two steps) and the fused chain at C=20480
and C=40960 (one step) on the kernels and again on the plain versions
(cuda_kernels._route answering "cpu"), nhit, nok and pacc equal and the
voice chain's PCM bit-equal, the kernel launches a step of each chain,
and the Profiler's busy share of the e2e and voice chains at C=1024 and
C=20480.

Every decode phase sets the kernels' launch counts to 0 just before it
drives its path and reads them just after; a kernel of that path that
was never launched fails the run.

The last two lines are one JSON object of kernel results and the
result line {"ok": true, "device": {...}}.  Any failed phase exits
non-zero before the result line; so does a machine without a CUDA
device, and a directory without the tetraear_tpu_torch package.

Two other modes print no result line and exit non-zero:

    python3 chip_smoke.py --profile [DIR]   # the Profiler's breakdown
                                       # of the chained steps and the
                                       # sharded FFT step, written
                                       # to DIR (default profile_out/)
                                       # with each Chrome trace
    python3 chip_smoke.py --rehearse   # the phases' control flow on the
                                       # CPU at a tiny size (plain
                                       # versions; nothing is built)
    python3 chip_smoke.py --nccl-one-rank  # the nccl one rank phase's
                                       # own process (one JSON line)
    python3 chip_smoke.py --only ui,examples,bench  # those phases
                                       # alone after the build, a JSON
                                       # line each
    python3 chip_smoke.py --parent DIR # each redesigned kernel whose
                                       # earlier source DIR holds
                                       # (band_extract.cu, tea.cu,
                                       # viterbi.cu, beside common.cuh) in
                                       # turns with this checkout's on the
                                       # same inputs: launch alone and
                                       # call, one JSON line a case
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PK = "tetraear_tpu/dsp/pallas_kernels.py"
CSRC = "tetraear_tpu_torch/dsp/csrc/"

# name -> (source, file:line of the TPU kernel it replaces)
KERNELS = {
    "fft2p": (CSRC + "fft2p.cu", PK + ":1603"),
    "fft2p_pass1": (CSRC + "fft2p.cu", "perf/fft2p_stage_probe.py:103"),
    "band_synth": (CSRC + "band_synth.cu", PK + ":325"),
    "fused_backhalf": (CSRC + "backhalf.cu", PK + ":1013"),
    "band_synth_y": (CSRC + "band_synth.cu", PK + ":284"),
    "band_synth_ph": (CSRC + "band_synth.cu", PK + ":306"),
    "frame_scan_even": (CSRC + "frame_scan.cu", PK + ":1203"),
    "band_extract_rows": (CSRC + "band_extract.cu", PK + ":107"),
    "band_extract": (CSRC + "band_extract.cu", PK + ":56"),
    "bit_place": (CSRC + "probes.cu", "perf/place_probe.py:70"),
    "ops_probe": (CSRC + "probes.cu", "perf/mosaic_ops_probe.py:31"),
    "iir_recursion": (CSRC + "probes.cu", "perf/scan_overhead_probe.py:135"),
    # the reference's key search is XLA, no Pallas kernel: its rounds
    "tea_search": (CSRC + "tea.cu", "tetraear_tpu/crypto/batch.py:87"),
    # the reference's speech channel decoder is XLA too: its lax.scan
    "viterbi_decode": (CSRC + "viterbi.cu",
                       "tetraear_tpu/voice/jviterbi.py:72"),
    # and its speech decoder: lax.scans over samples around basicops
    "acelp_decode": (CSRC + "speech.cu",
                     "tetraear_tpu/voice/jspeech.py:564"),
}
FUSED_KERNELS = ("fft2p", "band_synth", "fused_backhalf")

FS_SMALL = 2.304e6
FS_RTL = 2.4e6
FS_FLEET = 36.864e6
FS_ALIGNED = 40.96e6
FS_BENCH = 294.912e6
# the widest unaligned grid with n_band no multiple of 128 (64)
FS_ELEMENT = 61.44e6
NFFT_ELEMENT = 32768
RTL_OFFSETS = (12_500.0, -287_500.0)
FIXTURE = ROOT / "tests" / "fixtures" / "offair_2carrier.cs16"

# the card's peaks, one definition (tetraear_tpu_torch/runtime/profiling.py:
# one H100 SXM's memory rate and float32 rate outside the tensor cores, the
# integer instruction rates a clock an SM, 132 SMs); main replaces
# SM_CLOCK_HZ with the clock nvidia-smi reports as clocks.max.sm.  A
# directory without the package stops in main.
if (ROOT / "tetraear_tpu_torch").is_dir():
    sys.path.insert(0, str(ROOT))
    from tetraear_tpu_torch.runtime.profiling import (  # noqa: E402
        FP32_OPS_PER_S, HBM_BYTES_PER_S, ISSUE_PER_CLK_SM, LOGIC_PER_CLK_SM,
        N_SMS, QUARTER_PER_CLK_SM, SM_CLOCK_HZ)

DEV = "cuda"            # "cpu" in the rehearsal
REHEARSE = False


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def grid(c: int) -> list:
    """C carriers on the 25 kHz grid centred on the capture (bench.py)."""
    return [(i - c // 2) * 25_000 + 12_500.0 for i in range(c)]


def event_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean device time of fn() over reps launches (CUDA events; the
    host clock in the rehearsal).  ``queued``: the card first sleeps ~10
    ms while the host queues the launches, so that launches shorter than
    their host work are timed back to back on the card."""
    import torch
    fn()
    if DEV == "cpu":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sync() -> None:
    import torch
    if DEV != "cpu":
        torch.cuda.synchronize()


def max_err(a, b) -> tuple:
    """(max |a - b|, RMS of b) in float64."""
    a = a.double()
    b = b.double()
    return (a - b).abs().max().item(), b.pow(2).mean().sqrt().item()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(in_out_bytes: int, ops: float, logic: float = 0.0,
          quarter: float = 0.0, issue: float = 0.0) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations, whichever
    is larger.  ``ops`` are float32 operations at the float32 rate,
    ``logic`` 32-bit integer logic operations and ``quarter`` population
    counts and conversions, each at its own instruction rate; the three run in
    different pipes, so the slowest of them is what the operations need.
    ``issue`` are 32-bit integer instructions that may go to either
    integer-capable pipe, at the SM's issue rate.
    ``fp32_rate_ms`` keeps the earlier yardstick beside it: every
    operation at the float32 rate."""
    t_bytes = in_out_bytes / HBM_BYTES_PER_S * 1e3
    per_ms = N_SMS * SM_CLOCK_HZ * 1e-3
    t_ops = max(ops / FP32_OPS_PER_S * 1e3,
                logic / (LOGIC_PER_CLK_SM * per_ms),
                quarter / (QUARTER_PER_CLK_SM * per_ms),
                issue / (ISSUE_PER_CLK_SM * per_ms))
    total = ops + logic + quarter + issue
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(in_out_bytes), "ops": float(total),
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "fp32_rate_ms": max(t_bytes, total / FP32_OPS_PER_S * 1e3)}


def no_sync(what: str, fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"), so that a
    call that synchronises the host with the card fails the run."""
    import torch
    if DEV == "cpu":
        return fn()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        fail(f"{what}: the call synchronises ({e})")
    finally:
        torch.cuda.set_sync_debug_mode("default")


def extract_random(c: int, nfft_: int, nb: int, planes, rng) -> list:
    """(name, what, source, plan, starts on the card, gather) of both
    extraction forms on random in-range starts at one geometry, the first
    and last slices and odd starts included: rows over ``planes`` (2,
    (nfft + n_band) / 128, 128), pairs over the first nfft + n_band pairs
    of its rows; each set of starts made into a plan once on the host."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    dev = planes.device
    p = nb // 128
    r_rows = planes.shape[1]
    rs = rng.integers(0, r_rows - p + 1, c).astype(np.int32)
    rs[0], rs[-1] = 0, r_rows - p
    plan = ck.ExtractPlan("rows", rs, p, r_rows)
    rs = torch.from_numpy(rs).to(dev)
    pl_idx = torch.arange(2, device=dev)[None, :, None]
    row_idx = (rs.long()[:, None, None]
               + torch.arange(p, device=dev)[None, None, :])
    out = [("band_extract_rows", f"band_extract_rows C={c}", planes, plan,
            rs, lambda: planes[pl_idx, row_idx])]
    flat = planes.reshape(2, -1)[:, :nfft_ + nb]
    x_ext = torch.stack([flat[0], flat[1]], dim=1).contiguous()
    st = rng.integers(0, nfft_ + 1, c).astype(np.int32)
    st[0], st[1], st[-2], st[-1] = 0, 1, nfft_ - 1, nfft_
    plan = ck.ExtractPlan("pairs", st, nb, nfft_ + nb)
    st = torch.from_numpy(st).to(dev)
    idx = st.long()[:, None] + torch.arange(nb, device=dev)[None, :]
    out.append(("band_extract", f"band_extract C={c}", x_ext, plan, st,
                lambda: x_ext[idx]))
    return out


# the C libraries of earlier sources of the kernels a PR redesigns
# (--parent DIR), each timed in turns with this checkout's kernel:
# {source name: ctypes.CDLL}
PARENT = {}
PARENT_SOURCES = ("band_extract.cu", "tea.cu", "viterbi.cu")


def build_parent(parent: Path) -> dict:
    """Each of PARENT_SOURCES that ``parent`` holds (beside the
    ``common.cuh`` it includes), built alone with nvcc, all started
    together.  Their C entries are the earlier ones:
    tt_band_extract_rows(planes, plane_len, row_start, out, P, C, stream)
    and tt_band_extract(x, start, out, n_band, C, stream), the starts
    int32 on the card (PRs 2-8); tt_tea(mode, tea1, v0, v1, kw,
    key_words, K, B, W, out, stream), one family a launch (PRs 5-9);
    tt_viterbi(soft, ordered, bfi, B, pos, sign, crc, stream), the tables
    copied from host memory on every call (PRs 6-9)."""
    import ctypes
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    out_dir = ck.BUILD_DIR.parent / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = [n for n in PARENT_SOURCES if (parent / n).is_file()]
    procs = {n: subprocess.Popen(
        [ck._nvcc(), *ck._flags(n), "-shared", "-o",
         str(out_dir / f"lib{Path(n).stem}.so"), str(parent / n)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in names}
    libs = {}
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            fail(f"nvcc of {parent / n}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{Path(n).stem}.so"))
        if n == "band_extract.cu":
            lib.tt_band_extract_rows.argtypes = [vp, cl, vp, vp, ci, ci, vp]
            lib.tt_band_extract.argtypes = [vp, vp, vp, ci, ci, vp]
            lib.tt_band_extract_rows.restype = lib.tt_band_extract.restype \
                = ci
        elif n == "tea.cu":
            lib.tt_tea.argtypes = [ci, ci, vp, vp, vp, ci, ci, ci, ci, vp,
                                   vp]
            lib.tt_tea.restype = ci
        else:
            lib.tt_viterbi.argtypes = [vp] * 3 + [ci] + [vp] * 4
            lib.tt_viterbi.restype = ci
        libs[n] = lib
    say(f"parent: built {names} from {parent}")
    return libs


def turns(parent_fn, this_fn, reps: int, queued: bool = True) -> dict:
    """Device times in turns on the same inputs: earlier, this, this,
    earlier (event_ms, launches queued behind a sleep of the card)."""
    t = [event_ms(f, reps, queued=queued)
         for f in (parent_fn, this_fn, this_fn, parent_fn)]
    return {"parent_ms": [t[0], t[3]], "this_ms": t[1:3]}


def parent_turns(what: str, src, plan, starts, want, launch,
                 reps: int) -> dict:
    """The earlier kernel (PARENT's band_extract.cu) on the same inputs:
    equal to the
    plain version; its launch alone queued in turns with ``launch``
    (earlier, this, this, earlier), and its call as its wrapper made it
    (the starts' torch.aminmax read on the host, then the launch)."""
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    out = torch.empty_like(want)
    stream = ck._stream(src.device)
    if plan.form == "rows":
        fn = PARENT["band_extract.cu"].tt_band_extract_rows
        args = (ck._ptr(src), plan.n_rows * 128, ck._ptr(starts),
                ck._ptr(out), plan.span, len(plan.starts), stream)
    else:
        fn = PARENT["band_extract.cu"].tt_band_extract
        args = (ck._ptr(src), ck._ptr(starts), ck._ptr(out), plan.span,
                len(plan.starts), stream)

    def parent_launch():
        if fn(*args):
            fail(f"{what}: the earlier kernel's launch failed")

    def parent_call():
        lo, hi = (int(v) for v in torch.aminmax(starts))
        if lo < 0 or hi + plan.span > plan.n_rows:
            fail(f"{what}: starts out of range")
        parent_launch()

    parent_launch()
    if not torch.equal(out, want):
        fail(f"{what}: the earlier kernel differs from the plain version")
    t = [event_ms(f, reps, queued=True)
         for f in (parent_launch, launch, launch, parent_launch)]
    return {"parent_launch_ms": [t[0], t[3]], "turn_launch_ms": t[1:3],
            "parent_call_ms": event_ms(parent_call, reps)}


def extract_result(what: str, src, plan, starts, gather, reps: int,
                   xreps: int) -> dict:
    """One extraction kernel (by the plan's form) on ``src``: bit-equal to
    its plain version and to the single-call gather, one call without a
    synchronisation; times of the call, the launch alone (the C entry
    through ctypes, plan uploaded and output allocated before, launches
    queued behind a sleep of the card), the plain version and the gather;
    the bound from the distinct source bytes read once plus the output
    and the starts; with --parent, the earlier kernel's times
    (parent_turns)."""
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    rows = plan.form == "rows"
    call = ck.band_extract_rows if rows else ck.band_extract
    plain = ck.band_extract_rows_plain if rows else ck.band_extract_plain
    got = call(src, plan, plan.span)
    want = plain(src, starts, plan.span)
    if not torch.equal(got, want):
        fail(f"{what}: differs from the plain version")
    if not torch.equal(gather(), want):
        fail(f"{what}: the single-call gather differs")
    no_sync(what, lambda: call(src, plan, plan.span))
    turns = {}
    if DEV == "cpu":
        launch_ms = event_ms(lambda: call(src, plan, plan.span), 1)
    else:
        fn, args = ck.extract_entry(plan, src, got)
        stream = ck._stream(src.device)

        def launch():
            if fn(*args, stream):
                fail(f"{what}: the launch failed")
        launch_ms = event_ms(launch, xreps, queued=True)
        if "band_extract.cu" in PARENT:
            turns = parent_turns(what, src, plan, starts, want, launch, xreps)
        if not torch.equal(got, want):
            fail(f"{what}: the launches alone left another output")
    return {
        "max_abs_err": 0.0, "tol": 0.0,
        "ms": event_ms(lambda: call(src, plan, plan.span), xreps),
        "launch_ms": launch_ms,
        "plain_ms": event_ms(lambda: plain(src, starts, plan.span), reps),
        "library_ms": event_ms(gather, xreps),
        "source_bytes": plan.source_bytes,
        **bound(plan.source_bytes + plan.out_bytes + nbytes(starts), 0.0),
        **turns}


def scan_rows(c: int, n: int, rng):
    """(c, n) uint8 bit rows: random bits, with CRC-valid golden slots at
    even offsets in every fourth row and both training sequences planted
    in every other row."""
    import numpy as np
    from tetraear_tpu_torch.dsp import framescan
    from tetraear_tpu_torch.ref import golden
    rows = rng.integers(0, 2, (c, n)).astype(np.uint8)
    stream = golden.build_stream(
        [golden.sds_text_payload("SCAN ME")] * (n // 510 + 2), seed=5)
    offs = 2 * rng.integers(0, 200, c)
    for r in range(0, c, 4):
        seg = stream[:n - offs[r]]
        rows[r, offs[r]:offs[r] + len(seg)] = seg
    pats = framescan._PATTERNS.astype(np.uint8)
    pos = rng.integers(0, n - 22, c)
    for r in range(1, c, 2):
        rows[r, pos[r]:pos[r] + 22] = pats[r % 4 // 2]
    return rows


def phase_kernels(fs: float, c: int, seed: int, reps: int,
                  nfft: int | None = None) -> dict:
    """Each kernel vs its plain version at one geometry."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp import probes
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod

    bank = CarrierBankDemod(fs=fs, freqs_hz=grid(c), frontend="fft",
                            nfft=nfft)
    ch = bank.channelizer
    fused = FusedRx(bank, DEV)
    rng = np.random.default_rng(seed)
    dev = torch.device(DEV)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    res = {}
    n1, n2 = ch.fft2p_n1, ch.fft2p_n2
    nfft_, nb = ch.nfft, ch.n_band
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
    win_c = torch.complex(win[0].reshape(-1), win[1].reshape(-1))
    res["fft2p"] = {
        "max_abs_err": max(err, err0), "tol": tol,
        "ms": event_ms(lambda: ck.fft2p_planes_spliced(*args1), reps),
        "plain_ms": event_ms(lambda: ck.fft2p_plain(*args1), reps),
        "library_ms": event_ms(lambda: torch.fft.fft(win_c), reps),
        **bound(nbytes(tail_p, x3, got), 5.0 * nfft_ * math.log2(nfft_)),
        # the same two CUDA functions on the unspliced window (o2 = 0)
        "unspliced_ms": event_ms(
            lambda: ck.fft2p_planes_spliced(*args1b), reps),
        "unspliced_plain_ms": event_ms(lambda: ck.fft2p_plain(*args1b),
                                       reps)}
    if not max(err, err0) <= tol:
        fail(f"fft2p C={c}: max err {max(err, err0):.3e} > {tol:.3e}")
    planes = ref
    del got, win, win_c

    # pass 1 alone against its plain version; pass 2's time is the rest
    g_k = ck.fft2p_pass1(*args1[:4])
    g_p = ck.fft2p_pass1_plain(*args1[:4])
    err_g, rms_g = max_err(g_k, g_p)
    tol_g = 1e-4 * rms_g
    if not err_g <= tol_g:
        fail(f"fft2p_pass1 C={c}: max err {err_g:.3e} > {tol_g:.3e}")
    plan = ck.fft2p_plan(n1, n2)
    res["fft2p_pass1"] = {
        "max_abs_err": err_g, "tol": tol_g,
        "ms": event_ms(lambda: ck.fft2p_pass1(*args1[:4]), reps),
        "plain_ms": event_ms(lambda: ck.fft2p_pass1_plain(*args1[:4]),
                             reps),
        "library_ms": None,
        **bound(nbytes(tail_p, x3, g_k),
                nfft_ * (5.0 * math.log2(plan.la) + 6.0))}
    del g_k, g_p

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
    synth_in = nbytes(planes, fused.h1_planes, fused.row_start,
                      fused.d_shift)
    synth_ops = c * 5.0 * nb * math.log2(nb)
    res["band_synth"] = {
        "max_abs_err": err_y, "tol": tol_y, "phasor_err": err_ph,
        "phasor_tol": tol_ph,
        "ms": event_ms(lambda: ck.band_synth(*args2), reps),
        "plain_ms": event_ms(lambda: ck.band_synth_plain(*args2), reps),
        "library_ms": None,
        **bound(synth_in + nbytes(y_k, ph_k), synth_ops)}
    if not (err_y <= tol_y and err_ph <= tol_ph):
        fail(f"band_synth C={c}: y err {err_y:.3e} (tol {tol_y:.3e}), "
             f"phasor err {err_ph:.3e} (tol {tol_ph:.3e})")

    # the y-only and phasor-only variants, the full kernel's tolerances
    y_only = ck.band_synth_y(*args2[:-1])
    ph_only = ck.band_synth_ph(*args2)
    e_y, _ = max_err(y_only, y_p)
    e_ph, _ = max_err(ph_only, ph_p)
    if not (e_y <= tol_y and e_ph <= tol_ph):
        fail(f"band_synth variants C={c}: y-only err {e_y:.3e} (tol "
             f"{tol_y:.3e}), phasor-only err {e_ph:.3e} (tol {tol_ph:.3e})")
    if DEV != "cpu" and not (torch.equal(y_only, y_k)
                             and torch.equal(ph_only, ph_k)):
        fail(f"band_synth variants C={c}: not bit-equal to the full kernel")
    res["band_synth_y"] = {
        "max_abs_err": e_y, "tol": tol_y,
        "ms": event_ms(lambda: ck.band_synth_y(*args2[:-1]), reps),
        "plain_ms": event_ms(
            lambda: ck.band_synth_plain(*args2[:-1], None), reps),
        "library_ms": None, **bound(synth_in + nbytes(y_only), synth_ops)}
    res["band_synth_ph"] = {
        "max_abs_err": e_ph, "tol": tol_ph,
        "ms": event_ms(lambda: ck.band_synth_ph(*args2), reps),
        "plain_ms": res["band_synth"]["plain_ms"], "library_ms": None,
        **bound(synth_in + nbytes(ph_only), synth_ops)}
    del y_k, y_only

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
    n_pos = out_k[0].shape[1] * 64
    res["fused_backhalf"] = {
        "max_abs_err": worst, "tol": 1e-6,
        "ms": event_ms(lambda: ck.fused_backhalf(*args3), reps),
        "plain_ms": event_ms(
            lambda: ck.fused_backhalf_plain(*args3,
                                            ck.z_rows_for(fused.p)), reps),
        "library_ms": None,
        **bound(nbytes(*[a for a in args3 if isinstance(a, torch.Tensor)],
                       *out_k),
                c * 40.0 * nb, *(c * n_pos * v for v in scan_ops(8)))}
    bt_probe = state["bit_tail"]
    del out_k, out_p, y_p, args3, g

    # standalone frame scan: rows of 1200 + 2 k_max bits
    n_bits = ck.TAILBITS + 2 * bank.k_max
    rows = torch.from_numpy(scan_rows(c, n_bits, rng)).to(dev)
    corr_k, err_k = ck.frame_scan_even(rows)
    corr_p, err_p = ck.frame_scan_even_plain(rows)
    if corr_k.shape != corr_p.shape or err_k.shape != err_p.shape:
        fail(f"frame_scan_even C={c}: plane shapes {tuple(corr_k.shape)} "
             f"{tuple(err_k.shape)}")
    if not (torch.equal(corr_k, corr_p) and torch.equal(err_k, err_p)):
        fail(f"frame_scan_even C={c}: planes differ from the plain "
             f"version (corr {max_err(corr_k, corr_p)[0]:.3e}, crc_err "
             f"{(err_k != err_p).sum().item()} positions)")
    if float(corr_k.max()) != 1.0 or int(err_k.min()) > 2:
        fail(f"frame_scan_even C={c}: planted slots not found")
    res["frame_scan_even"] = {
        "max_abs_err": 0.0, "tol": 0.0,
        "ms": event_ms(lambda: ck.frame_scan_even(rows), reps),
        "plain_ms": event_ms(lambda: ck.frame_scan_even_plain(rows), reps),
        "library_ms": None,
        **bound(nbytes(rows, corr_k, err_k), 0.0,
                *(c * corr_k.shape[1] * v for v in scan_ops(16)))}
    del rows, corr_k, corr_p, err_k, err_p

    # band extraction: random in-range starts; at C=1024 a launch is
    # short beside the spread of a 10-launch mean, so the call, the launch
    # and the gather are timed over 100 launches there
    xreps = 100 if c <= 1024 else reps
    for name, what, src, plan, starts, gather in extract_random(
            c, nfft_, nb, planes, rng):
        res[name] = extract_result(what, src, plan, starts, gather, reps,
                                   xreps)

    # the placement probe: random decisions of k_max - 2 .. k_max valid
    # symbols on the carried tail of the state above
    ns = 128 * fused.sy
    z_rows = ck.z_rows_for(fused.p)
    n_val = rng.integers(bank.k_max - 2, bank.k_max + 1, c)
    hard = rng.integers(0, 4, (c, ns)).astype(np.uint8)
    hard[np.arange(ns)[None, :] >= n_val[:, None]] = 0
    hard = torch.from_numpy(hard).to(dev)
    dsel = torch.from_numpy((n_val - (bank.k_max - 2)).astype(np.int32)
                            ).to(dev)
    args4 = (hard, bt_probe, dsel, bank.k_max, z_rows)
    z_k, bt2_k = probes.bit_place(*args4)
    z_p, bt2_p = probes.bit_place_plain(*args4)
    if not (torch.equal(z_k, z_p) and torch.equal(bt2_k, bt2_p)):
        fail(f"bit_place C={c}: {(z_k != z_p).sum().item()} words of z and "
             f"{(bt2_k != bt2_p).sum().item()} tail bits differ")
    res["bit_place"] = {
        "max_abs_err": 0.0, "tol": 0.0,
        "ms": event_ms(lambda: probes.bit_place(*args4), reps),
        "plain_ms": event_ms(lambda: probes.bit_place_plain(*args4), reps),
        "library_ms": None,
        **bound(nbytes(hard, bt_probe, dsel, z_k, bt2_k), 0.0,
                c * (4.0 * ns + 6.0 * 128 * bt_probe.shape[1]))}
    del hard, z_k, z_p, bt2_k, bt2_p, bt_probe, state

    res["ops_probe"] = check_ops_probe(reps)

    # the serial recursion: one subframe of 60 samples, four rows a carrier
    a_iir, x_iir = iir_inputs(4 * c, 60, rng)
    y_k, m_k = probes.iir_recursion(a_iir, x_iir)
    y_p, m_p = probes.iir_recursion_plain(a_iir, x_iir)
    if not (torch.equal(y_k, y_p) and torch.equal(m_k, m_p)):
        fail(f"iir_recursion B={4 * c}: {(y_k != y_p).sum().item()} samples "
             f"differ from the host-driven recursion")
    res["iir_recursion"] = {
        "max_abs_err": 0.0, "tol": 0.0,
        "ms": event_ms(lambda: probes.iir_recursion(a_iir, x_iir), reps),
        "plain_ms": event_ms(
            lambda: probes.iir_recursion_plain(a_iir, x_iir), min(reps, 3)),
        "library_ms": None,
        **bound(nbytes(a_iir, x_iir, y_k, m_k),
                IIR_OPS * x_iir.shape[0] * x_iir.shape[1])}
    del y_k, y_p, m_k, m_p
    sync()
    for name, r in res.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        say(f"kernel {name} C={c}: max_abs_err {r['max_abs_err']:.3e} "
            f"(tol {r['tol']:.3e}), kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library call {lib}, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes {r['bytes_ms']:.4f} ms, {r['ops']:.3e} "
            f"ops {r['ops_ms']:.4f} ms; every operation at the float32 "
            f"rate: {r['fp32_rate_ms']:.4f} ms)")
    for name in ("band_extract_rows", "band_extract"):
        r = res[name]
        say(f"kernel {name} C={c}: the launch alone {r['launch_ms']:.4f} "
            f"ms (the call {r['ms']:.4f}); {r['source_bytes']} distinct "
            f"source bytes")
    r = res["fft2p"]
    say(f"kernel fft2p C={c}, unspliced window (o2 = 0): kernel "
        f"{r['unspliced_ms']:.4f} ms, plain {r['unspliced_plain_ms']:.4f} "
        f"ms; same bound, library call and error limit")
    say(f"kernel fft2p C={c}, by pass: pass 1 "
        f"{res['fft2p_pass1']['ms']:.4f} ms (fft2p_pass1, timed alone); "
        f"pass 2 about {r['ms'] - res['fft2p_pass1']['ms']:.4f} ms (not "
        f"timed: fft2p less fft2p_pass1, a difference of two means); "
        f"plan {plan}")
    return res


# 32-bit integer instructions of one TEA half round (csrc/tea.cu), the
# fewest its expression compiles to: TEA2 a shift-add (LEA) for each key
# term, the sum term, the three-input exclusive-or (inverted) and one
# three-input addition for the subtraction, 5; TEA1 two shifts, the
# three-input exclusive-or with the sum, the addition of v, the exclusive-or
# with key + sum (inverted) and the subtraction, 6 (key + sum held).  64
# half rounds an 8-byte block, at the issue rate (bound's ``issue``)
TEA_INSTR_PER_BLOCK = {"TEA1": 64 * 6.0, "TEA2": 64 * 5.0}
# (name, keys, payloads) of the two fixed sizes: a large deferred
# decryption (16 keys a family, 4096 pending frames) and a bruteforce
# sweep; the deferred launches the stream phase makes are held apart
# (phase_tea_path)
TEA_SIZES = (("deferred", 16, 4096), ("bruteforce", 65536, 256))
TEA_KEY_BYTES = {"TEA1": 10, "TEA2": 16}


def tea_out(mode: int, k: int, b: int, w: int, dev):
    import torch
    if mode == 1:
        return torch.empty((k, b), dtype=torch.int32, device=dev)
    if mode == 2:
        return torch.empty((b, 8 * w), dtype=torch.uint8, device=dev)
    return torch.empty((k, b, 8 * w), dtype=torch.uint8, device=dev)


def tea_launch(mode: int, v0, v1, kw1, kw2, out, what: str):
    """This checkout's tea_search launch alone (the C entry through ctypes,
    output allocated before) as a function."""
    from tetraear_tpu_torch.crypto import batch as tb
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    args = tb.kernel_args(mode, v0, v1, kw1, kw2, out)
    if DEV == "cpu":                 # the rehearsal: nothing is built
        return lambda: None
    fn = ck.build().tt_tea
    args = (*args, ck._stream(v0.device))

    def launch():
        if fn(*args):
            fail(f"{what}: the launch failed")
    return launch


def parent_tea(mode: int, v0, v1, kw, tea1: bool, what: str) -> tuple:
    """The earlier tea.cu (one family a launch) on the same inputs:
    (its output, its launch alone, its call as its wrapper made it: the
    checks, torch.empty, the launch)."""
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    lib = PARENT["tea.cu"]
    b, w = v0.shape
    k = kw.shape[0]
    n_kw = 5 if tea1 else 4
    stream = ck._stream(v0.device)
    out = tea_out(mode, k, b, w, v0.device)

    def run(o):
        if lib.tt_tea(mode, int(tea1), ck._ptr(v0), ck._ptr(v1),
                      ck._ptr(kw), n_kw, k, b, w, ck._ptr(o), stream):
            fail(f"{what}: the earlier kernel's launch failed")

    def call():
        ck._check(v0, "v0", (b, w), torch.int32)
        ck._check(v1, "v1", (b, w), torch.int32)
        ck._check(kw, "key_words", (k, n_kw), torch.int32)
        o = tea_out(mode, k, b, w, v0.device)
        run(o)
        return o
    run(out)
    return out, lambda: run(out), call


def tea_modes(what: str, v0, v1, kw, kb, tea1: bool, outs: dict,
              reps: int) -> dict:
    """tea_search's three modes on one family: the call and the launch
    alone; with --parent, the earlier kernel's output equal to this one's
    and its launch in turns with this launch."""
    from tetraear_tpu_torch.crypto import batch as tb
    calls = {0: lambda: tb.tea_decrypt(v0, v1, kw, tea1),
             1: lambda: tb.tea_search(v0, v1, kw, tea1),
             2: lambda: tb.tea_decrypt_pairs(v0, v1, kb, tea1)}
    res = {}
    for mode, name in ((0, "decrypt"), (1, "search"), (2, "pairs")):
        key = kb if mode == 2 else kw
        fam = (key, None) if tea1 else (None, key)
        launch = tea_launch(mode, v0, v1, *fam, outs[mode], what)
        r = {"ms": event_ms(calls[mode], reps),
             "launch_ms": event_ms(launch, max(reps, 20), queued=True)}
        if "tea.cu" in PARENT and DEV != "cpu":
            import torch
            out, p_launch, p_call = parent_tea(mode, v0, v1, key, tea1,
                                               f"{what} {name}")
            if not torch.equal(out, outs[mode]):
                fail(f"{what} {name}: the earlier kernel differs")
            r.update(turns(p_launch, launch, max(reps, 20)),
                     parent_call_ms=event_ms(p_call, reps))
        res[name] = r
    return res


def phase_tea(seed: int, reps: int, int_rates: dict) -> dict:
    """tea_search against its plain version at both sizes, TEA1 and TEA2,
    32-byte payloads: scores, plaintexts and the best-key pairs bit-equal,
    a few pairs checked against TEADecryptor; each mode's call and launch
    alone (and with --parent the earlier kernel's in turns).  Returns
    {size_alg: result} (the search mode's numbers, the others beside)."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.crypto import batch as tb
    from tetraear_tpu_torch.crypto.tea import TEADecryptor
    rng = np.random.default_rng(seed)
    res = {}
    for size, k, b in TEA_SIZES:
        if REHEARSE:
            k, b = min(k, 8), min(b, 16)
        for alg in ("TEA1", "TEA2"):
            pay = rng.integers(0, 256, (b, 32), dtype=np.uint8)
            keys = rng.integers(0, 256, (k, TEA_KEY_BYTES[alg]),
                                dtype=np.uint8)
            # a payload no key decodes scores the same under many keys:
            # plant a printable plaintext under key 3 in payload 0
            pay[0] = np.frombuffer(TEADecryptor(
                keys[3].tobytes(), alg).encrypt(b"\x82TEA KEY SEARCH CHECK "
                                                b"0123456789"), np.uint8)
            v0, v1, kw, tea1, _ = tb._device_words(pay, keys, alg, DEV)
            s_k = tb.tea_search(v0, v1, kw, tea1)
            s_p = tb.tea_search_plain(v0, v1, kw, tea1)
            d_k = tb.tea_decrypt(v0, v1, kw, tea1)
            d_p = tb.tea_decrypt_plain(v0, v1, kw, tea1)
            best = torch.argmax(s_k, dim=0)
            kb = kw[best].contiguous()
            q_k = tb.tea_decrypt_pairs(v0, v1, kb, tea1)
            q_p = tb.tea_decrypt_pairs_plain(v0, v1, kb, tea1)
            if not (torch.equal(s_k, s_p) and torch.equal(d_k, d_p)
                    and torch.equal(q_k, q_p)):
                fail(f"tea_search {size} {alg} K={k} B={b}: scores "
                     f"{(s_k != s_p).sum().item()}, plaintext bytes "
                     f"{(d_k != d_p).sum().item()}, best-key bytes "
                     f"{(q_k != q_p).sum().item()} differ from the plain "
                     f"version")
            if int(best[0]) != 3:
                fail(f"tea_search {size} {alg}: payload 0's best key is "
                     f"{int(best[0])}, not the planted 3")
            d_host = d_k.cpu().numpy()
            for ki, bi in ((0, 0), (3, 0), (k - 1, b - 1), (k // 2, b // 3)):
                want = TEADecryptor(keys[ki].tobytes(), alg).decrypt(
                    pay[bi].tobytes())
                if d_host[ki, bi].tobytes() != want:
                    fail(f"tea_search {size} {alg}: key {ki} payload {bi} "
                         f"differs from TEADecryptor")
            del d_p, d_host, q_p
            modes = tea_modes(f"tea_search {size} {alg}", v0, v1, kw, kb,
                              tea1, {0: d_k, 1: s_k, 2: q_k}, reps)
            n_blocks = k * b * 4
            r = {"max_abs_err": 0.0, "tol": 0.0, "keys": k, "payloads": b,
                 "bytes_per_payload": 32,
                 "ms": modes["search"]["ms"],
                 "launch_ms": modes["search"]["launch_ms"],
                 "decrypt_ms": modes["decrypt"]["ms"],
                 "decrypt_launch_ms": modes["decrypt"]["launch_ms"],
                 "pairs_ms": modes["pairs"]["ms"],
                 "pairs_launch_ms": modes["pairs"]["launch_ms"],
                 "modes": modes,
                 "plain_ms": event_ms(
                     lambda: tb.tea_search_plain(v0, v1, kw, tea1),
                     min(reps, 2)),
                 "library_ms": None,
                 **bound(nbytes(v0, v1, kw, s_k), 0.0,
                         issue=TEA_INSTR_PER_BLOCK[alg] * n_blocks)}
            # the same instructions at the three-input addition rate the
            # rate loop reads (one pipe): no lower bound, a yardstick
            r["add_rate_read_ms"] = (TEA_INSTR_PER_BLOCK[alg] * n_blocks
                                     / int_rates["add_per_s"] * 1e3)
            r["decrypt_bound_ms"] = bound(
                nbytes(v0, v1, kw) + k * b * 32, 0.0,
                issue=TEA_INSTR_PER_BLOCK[alg] * n_blocks)["bound_ms"]
            r["pairs_bound_ms"] = bound(
                nbytes(v0, v1, kb) + b * 32, 0.0,
                issue=TEA_INSTR_PER_BLOCK[alg] * b * 4)["bound_ms"]
            del v0, v1, kw, kb, s_k, s_p, d_k, q_k
            res[f"{size}_{alg}"] = r
            par = "".join(
                f"; earlier {m} launch {v['parent_ms'][0]:.4f}, "
                f"{v['parent_ms'][1]:.4f} (this {v['this_ms'][0]:.4f}, "
                f"{v['this_ms'][1]:.4f}), its call {v['parent_call_ms']:.4f}"
                for m, v in modes.items() if "parent_ms" in v)
            say(f"kernel tea_search {size} {alg} K={k} B={b} L=32: scores, "
                f"plaintexts and best-key pairs bit-equal to the plain "
                f"version, spot pairs equal to TEADecryptor; search call "
                f"{r['ms']:.4f} ms / launch {r['launch_ms']:.4f}, decrypt "
                f"{r['decrypt_ms']:.4f} / {r['decrypt_launch_ms']:.4f} "
                f"(bound {r['decrypt_bound_ms']:.4f}), pairs "
                f"{r['pairs_ms']:.4f} / {r['pairs_launch_ms']:.4f} (bound "
                f"{r['pairs_bound_ms']:.5f}), plain search "
                f"{r['plain_ms']:.4f} ms, library call none, bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bytes']} "
                f"bytes, {r['ops']:.3e} integer instructions at "
                f"{ISSUE_PER_CLK_SM:.0f} a clock an SM; at the addition "
                f"rate read, one pipe: {r['add_rate_read_ms']:.4f} ms)"
                f"{par}")
    sync()
    return res


# (K1, K2, B, W) of the corner launches: one key, one payload, one block,
# W 9, odd B, one family pending, the live path's largest shape
TEA_CORNERS = ((1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 9), (0, 3, 17, 9),
               (5, 0, 33, 1), (1, 2, 171, 9), (13, 12, 1072, 8))


def check_tea_corners(seed: int) -> int:
    """tea_search at the corners (TEA_CORNERS): the fused decrypt, and each
    family's search and pairs modes, bit-equal to the plain versions.
    Returns the number of launches checked."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.crypto import batch as tb
    rng = np.random.default_rng(seed)
    n = 0
    for k1, k2, b, w in TEA_CORNERS:
        pay = rng.integers(0, 256, (b, 8 * w), dtype=np.uint8)
        v0, v1, kw1, kw2 = tb._upload(
            [*tb._payload_to_words(pay),
             tb._keys_to_words_tea1(rng.integers(0, 256, (k1, 10),
                                                 dtype=np.uint8)),
             tb._keys_to_words_tea2(rng.integers(0, 256, (k2, 16),
                                                 dtype=np.uint8))], DEV)
        what = f"tea_search corner K={k1}+{k2} B={b} W={w}"
        got = tb.tea_decrypt_fused(v0, v1, kw1, kw2)
        if not torch.equal(got, tb.tea_decrypt_fused_plain(v0, v1, kw1,
                                                           kw2)):
            fail(f"{what}: the fused decrypt differs from the plain version")
        n += 1
        for kw, tea1 in ((kw1, True), (kw2, False)):
            if not kw.shape[0]:
                continue
            kb = kw[torch.arange(b, device=kw.device) % kw.shape[0]]
            kb = kb.contiguous()
            if not (torch.equal(tb.tea_search(v0, v1, kw, tea1),
                                tb.tea_search_plain(v0, v1, kw, tea1))
                    and torch.equal(
                        tb.tea_decrypt_pairs(v0, v1, kb, tea1),
                        tb.tea_decrypt_pairs_plain(v0, v1, kb, tea1))):
                fail(f"{what}: the search or pairs mode differs from the "
                     f"plain version ({'TEA1' if tea1 else 'TEA2'})")
            n += 2
    sync()
    say(f"kernel tea_search corners: {n} launches (the fused decrypt, each "
        f"family's search and pairs) at (K1, K2, B, W) in {TEA_CORNERS} "
        f"bit-equal to the plain versions")
    return n


def tea_entry(tea: dict, path: list, counts: dict, floor: dict) -> dict:
    """The kernels line's tea_search entry: the fused decrypt launch at
    the largest deferred search of the fused stream (the mode and shape
    the path runs) as its numbers; every launch of the path, the floor and
    the two fixed sizes (three modes) beside them."""
    src, replaces = KERNELS["tea_search"]
    r = max(path, key=lambda p: p["items"])
    entry = {"name": "tea_search", "route": "cuda", "source": src,
             "replaces": replaces, "launches": counts["tea_search"],
             "max_abs_err": max(p["max_abs_err"] for p in path),
             "ms": r["ms"], "launch_ms": r["launch_ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None,
             "floor_ms": floor["launch_ms"],
             "shape": f"K={r['keys1']}+{r['keys2']} B={r['payloads']} "
                      f"L={r['length']}, TEA1 and TEA2 in one decrypt "
                      f"launch (the deferred search of a block of the "
                      f"fused stream)",
             "path_launches": path, "floor": floor}
    for key, v in tea.items():
        entry[key] = {k: v[k] for k in (
            "keys", "payloads", "ms", "launch_ms", "decrypt_ms",
            "decrypt_launch_ms", "pairs_ms", "pairs_launch_ms", "plain_ms",
            "bound_ms", "bound_by", "decrypt_bound_ms", "pairs_bound_ms",
            "add_rate_read_ms", "bytes", "ops")}
    return entry


def record_tea_calls(calls: list):
    """Wrap crypto.batch.tea_decrypt_families, which batch_decrypt_frames
    calls once a block for its pending frames (both cipher families), so
    that the inputs of each deferred search land in ``calls`` as
    (payloads, TEA1 keys, TEA2 keys); returns the function that undoes
    the wrap."""
    import numpy as np
    from tetraear_tpu_torch.crypto import batch as tb
    orig = tb.tea_decrypt_families

    def recording(payloads, tea1_keys, tea2_keys, device=None):
        calls.append((np.array(payloads, np.uint8), list(tea1_keys),
                      list(tea2_keys)))
        return orig(payloads, tea1_keys, tea2_keys, device=device)

    tb.tea_decrypt_families = recording

    def undo():
        tb.tea_decrypt_families = orig
    return undo


def wall_ms(fn, reps: int) -> float:
    """Mean host wall time of fn() (which ends in a fetch) over reps, after
    one warm-up call."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def tea_floor(reps: int) -> dict:
    """The fused decrypt's launch alone at K = 1, B = 1, W = 1 (TEA2): one
    block's 64 half rounds plus a launch, the latency floor; with
    --parent the earlier kernel's in turns."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.crypto import batch as tb
    rng = np.random.default_rng(3)
    v0, v1, kw1, kw2 = tb._upload(
        [*tb._payload_to_words(rng.integers(0, 256, (1, 8), np.uint8)),
         np.zeros((0, 5), np.uint32),
         tb._keys_to_words_tea2(rng.integers(0, 256, (1, 16), np.uint8))],
        DEV)
    out = tb.tea_decrypt_fused(v0, v1, kw1, kw2)
    launch = tea_launch(0, v0, v1, None, kw2, out, "tea_search floor")
    r = {"shape": "K=1 B=1 W=1 TEA2",
         "launch_ms": event_ms(launch, max(reps, 50), queued=True)}
    if "tea.cu" in PARENT and DEV != "cpu":
        p_out, p_launch, _ = parent_tea(0, v0, v1, kw2, False,
                                        "tea_search floor")
        if not torch.equal(p_out, out):
            fail("tea_search floor: the earlier kernel differs")
        r.update(turns(p_launch, launch, max(reps, 50)))
    say(f"kernel tea_search floor (K=1 B=1 W=1): launch alone "
        f"{r['launch_ms']:.5f} ms"
        + (f"; earlier {r['parent_ms']}, this {r['this_ms']} in turns"
           if "parent_ms" in r else ""))
    return r


def phase_tea_path(calls: list, reps: int,
                   label: str = "a deferred search of the stream") -> list:
    """tea_search on the inputs of each deferred search a stream made
    (``record_tea_calls``): the fused decrypt it ran there (one launch,
    both families) and each family's search mode bit-equal to their plain
    versions, a few pairs equal to TEADecryptor, the fused call without a
    synchronisation; the call, the launch alone, the plain version and the
    bound, and the deferred decryption's device round trip
    (tea_decrypt_families: one upload, the launch, one fetch; host wall).
    With --parent, the earlier kernel on the same inputs: its two launches
    (one a family) in turns with the fused one, and its round trip as its
    wrapper made it (a family: three uploads, the launch, a fetch) in
    turns with this one.  Returns one result a search."""
    import torch
    from tetraear_tpu_torch.crypto import batch as tb
    from tetraear_tpu_torch.crypto.tea import TEADecryptor
    if not calls:
        fail("tea path: the stream made no deferred key search")
    res = []
    for pay, keys1, keys2 in calls:
        v0, v1, kw1, kw2 = tb._upload(
            [*tb._payload_to_words(pay),
             tb._keys_to_words_tea1(tb._key_matrix(keys1, 10)),
             tb._keys_to_words_tea2(tb._key_matrix(keys2, 16))], DEV)
        (b, w), k1, k2 = v0.shape, len(keys1), len(keys2)
        what = f"tea path K={k1}+{k2} B={b} L={8 * w}"
        d_k = tb.tea_decrypt_fused(v0, v1, kw1, kw2)
        d_p = tb.tea_decrypt_fused_plain(v0, v1, kw1, kw2)
        if not torch.equal(d_k, d_p):
            fail(f"{what}: {(d_k != d_p).sum().item()} plaintext bytes "
                 f"differ from the plain version")
        for kw, tea1 in ((kw1, True), (kw2, False)):
            if kw.shape[0] and not torch.equal(
                    tb.tea_search(v0, v1, kw, tea1),
                    tb.tea_search_plain(v0, v1, kw, tea1)):
                fail(f"{what}: the search mode's scores differ from the "
                     f"plain version")
        d_host = d_k.cpu().numpy()
        keys = [(k, "TEA1") for k in keys1] + [(k, "TEA2") for k in keys2]
        for ki, bi in ((0, 0), (k1 + k2 - 1, b - 1), (k1, b // 2),
                       ((k1 + k2) // 2, b // 3)):
            key, alg = keys[min(ki, len(keys) - 1)]
            want = TEADecryptor(bytes(key), alg).decrypt(pay[bi].tobytes())
            if d_host[min(ki, len(keys) - 1), bi].tobytes() != want:
                fail(f"{what}: key {ki} payload {bi} differs from "
                     f"TEADecryptor")
        no_sync(what, lambda: tb.tea_decrypt_fused(v0, v1, kw1, kw2))
        launch = tea_launch(0, v0, v1, kw1, kw2, d_k, what)
        r = {"keys1": k1, "keys2": k2, "payloads": b, "length": 8 * w,
             "items": (k1 + k2) * b * w, "max_abs_err": 0.0,
             "ms": event_ms(lambda: tb.tea_decrypt_fused(v0, v1, kw1, kw2),
                            reps),
             "launch_ms": event_ms(launch, max(reps, 50), queued=True),
             "plain_ms": event_ms(
                 lambda: tb.tea_decrypt_fused_plain(v0, v1, kw1, kw2), 2),
             "round_trip_ms": wall_ms(
                 lambda: tb.tea_decrypt_families(pay, keys1, keys2, DEV),
                 reps),
             **bound(nbytes(v0, v1, kw1, kw2, d_k), 0.0,
                     issue=(TEA_INSTR_PER_BLOCK["TEA1"] * k1
                            + TEA_INSTR_PER_BLOCK["TEA2"] * k2) * b * w)}
        if "tea.cu" in PARENT and DEV != "cpu":
            r.update(parent_tea_path(pay, keys1, keys2, v0, v1, kw1, kw2,
                                     d_k, launch, what, reps))
        res.append(r)
        say(f"kernel tea_search on {label}, "
            f"K={k1}+{k2} B={b} L={8 * w}, one launch: plaintexts and "
            f"scores bit-equal to the plain version, spot pairs equal to "
            f"TEADecryptor, no synchronisation; call {r['ms']:.4f} ms, "
            f"launch alone {r['launch_ms']:.4f}, plain {r['plain_ms']:.4f} "
            f"ms, library call none, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']}; the round trip (upload, launch, fetch) "
            f"{r['round_trip_ms']:.4f} ms"
            + (f"; earlier: launches {r['parent_ms']} (this "
               f"{r['this_ms']}) in turns, its calls "
               f"{r['parent_call_ms']:.4f}, its round trip "
               f"{r['parent_round_trip_ms']} (this "
               f"{r['this_round_trip_ms']}) in turns"
               if "parent_ms" in r else ""))
    sync()
    return res


def parent_tea_path(pay, keys1, keys2, v0, v1, kw1, kw2, d_k, launch,
                    what: str, reps: int) -> dict:
    """The earlier tea.cu on one deferred search: a launch a family, their
    outputs equal to the fused one's; both launches in turns with the
    fused launch, both calls; its round trip as its wrapper made it (for
    each family: payload words and key words uploaded as three tensors,
    the launch, the fetch) in turns with tea_decrypt_families."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.crypto import batch as tb
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    parts, launches, p_calls = [], [], []
    for kw, tea1 in ((kw1, True), (kw2, False)):
        if kw.shape[0]:
            out, p_launch, p_call = parent_tea(0, v0, v1, kw, tea1, what)
            parts.append(out)
            launches.append(p_launch)
            p_calls.append(p_call)
    if not torch.equal(torch.cat(parts), d_k):
        fail(f"{what}: the earlier kernel differs from the fused launch")

    def both_launches():
        for f in launches:
            f()

    def both_calls():
        for f in p_calls:
            f()

    def parent_round_trip():
        dev = v0.device
        got = []
        for keys, alg in ((keys1, "TEA1"), (keys2, "TEA2")):
            if not keys:
                continue
            tea1 = alg == "TEA1"
            w0, w1 = tb._payload_to_words(pay)
            kwh = (tb._keys_to_words_tea1(tb._key_matrix(keys, 10)) if tea1
                   else tb._keys_to_words_tea2(tb._key_matrix(keys, 16)))
            t = [torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                                  .view(np.int32)).to(dev)
                 for a in (w0, w1, kwh)]
            o = tea_out(0, len(keys), *w0.shape, dev)
            lib = PARENT["tea.cu"]
            if lib.tt_tea(0, int(tea1), *(ck._ptr(x) for x in t),
                          5 if tea1 else 4, len(keys), *w0.shape,
                          ck._ptr(o), ck._stream(dev)):
                fail(f"{what}: the earlier kernel's launch failed")
            got.append(o.cpu().numpy())
        return got

    def this_round_trip():
        return tb.tea_decrypt_families(pay, keys1, keys2, DEV)

    if not np.array_equal(np.concatenate(parent_round_trip()),
                          this_round_trip()):
        fail(f"{what}: the earlier round trip's plaintexts differ")
    t = [wall_ms(f, reps) for f in (parent_round_trip, this_round_trip,
                                     this_round_trip, parent_round_trip)]
    return {**turns(both_launches, launch, max(reps, 50)),
            "parent_call_ms": event_ms(both_calls, reps),
            "parent_round_trip_ms": [t[0], t[3]],
            "this_round_trip_ms": t[1:3]}


def ops_inputs() -> dict:
    """Operation -> (a, b) of the elementwise probe: 1024 values over
    (0.1, 6) and a second operand for the (8, 128) operations, a
    (128, 64) ramp and a column for the layout idioms."""
    import numpy as np
    import torch
    x = np.linspace(0.1, 6.0, 8 * 128, dtype=np.float32).reshape(8, 128)
    y = (x * 0.5 + 0.3).astype(np.float32)
    a = np.arange(128 * 64, dtype=np.float32).reshape(128, 64)
    col = np.arange(128, dtype=np.float32)
    x, y, a, col = (torch.from_numpy(v).to(DEV) for v in (x, y, a, col))
    from tetraear_tpu_torch.dsp import probes
    return {op: ((a if op in ("bcast_col", "iota_sel_mm", "scalar_red_row")
                  else x),
                 (y if op in ("mod", "arctan2")
                  else col if op == "bcast_col" else None))
            for op in probes.OPS}


def check_ops_probe(reps: int) -> dict:
    """Every operation of the elementwise probe against the PyTorch
    operation: bit for bit where the operation is exact, the float
    functions within 2e-6 of max(1, |reference|), the reduction within
    1e-5 of its value.  Times are means over the twelve launches; the
    plain version of an operation is the single PyTorch call."""
    from tetraear_tpu_torch.dsp import probes
    inputs = ops_inputs()
    worst, worst_rel, tol, moved, ops = 0.0, 0.0, 0.0, 0, 0.0
    for op, (a, b) in inputs.items():
        got = probes.ops_probe(op, a, b)
        ref = probes.ops_probe_plain(op, a, b)
        if got.shape != ref.shape:
            fail(f"ops_probe {op}: shape {tuple(got.shape)}")
        err = (got.double() - ref.double()).abs()
        scale = ref.double().abs().clamp(min=1.0)
        rel = (err / scale).max().item()
        exact = probes.OPS[op][2]
        limit = 0.0 if exact else 1e-5 if op == "scalar_red_row" else 2e-6
        if not rel <= limit:
            fail(f"ops_probe {op}: differs from the PyTorch operation by "
                 f"{rel:.3e} of max(1, |reference|) (limit {limit:.1e})")
        if op != "scalar_red_row":       # its sums are of the order 1e11
            worst = max(worst, err.max().item())
            tol = max(tol, limit * scale.max().item())
        worst_rel = max(worst_rel, rel)
        moved += nbytes(a, got) + (nbytes(b) if b is not None else 0)
        ops += a.numel()
    n_ops = len(inputs)

    def run(fn):
        for op, (a, b) in inputs.items():
            fn(op, a, b)

    plain_ms = event_ms(lambda: run(probes.ops_probe_plain), reps) / n_ops
    return {"max_abs_err": worst, "tol": tol,
            "max_rel_err": worst_rel,
            "ms": event_ms(lambda: run(probes.ops_probe), reps) / n_ops,
            "plain_ms": plain_ms, "library_ms": plain_ms,
            **bound(moved / n_ops, ops / n_ops)}


def iir_inputs(b: int, n: int, rng) -> tuple:
    """(a (b, 10), x (n, b)) int32 on the device: coefficients within
    2000 and excitation within 3000, a stable synthesis filter's range."""
    import numpy as np
    import torch
    a = rng.integers(-2000, 2000, (b, 10)).astype(np.int32)
    x = rng.integers(-3000, 3000, (n, b)).astype(np.int32)
    return torch.from_numpy(a).to(DEV), torch.from_numpy(x).to(DEV)


def check_band_synth_sizes(rng) -> None:
    """band_synth's three forms at n_band 512, 2048 and 16384 (and the
    smallest, 128): five carriers with row_start and d_shift at their
    extremes, drop 0 and a multiple of P, each form within the full
    kernel's tolerances of the plain version and bit-equal to it."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp.channelizer import synth_tables
    dev = torch.device(DEV)
    worst = {}
    for n_band in (128, 512, 2048, 16384):
        p = n_band // 128
        n_rolls, r_rows = 7, 3 * p + 11
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        planes = to_dev(rng.standard_normal((2, r_rows, 128))
                        .astype(np.float32))
        h1 = to_dev(rng.standard_normal((2, n_rolls, p, 128))
                    .astype(np.float32))
        rs = to_dev(np.array([0, r_rows - p, 5, 1, r_rows - p - 1],
                             np.int32))
        ds = to_dev(np.array([0, n_rolls - 1, 3, n_rolls - 1, 0], np.int32))
        tabs = tuple(to_dev(t) for t in synth_tables(n_band))
        for drop in (0, 2 * p) if p % 4 == 0 else (None,):
            args = (planes, h1, rs, ds, *tabs, p)
            y_p, ph_p = ck.band_synth_plain(*args, drop)
            y_only = ck.band_synth_y(*args)
            err_y, rms_y = max_err(y_only, y_p)
            errs = [err_y / rms_y]
            ok = err_y <= 1e-5 * rms_y
            if drop is not None:
                y_k, ph_k = ck.band_synth(*args, drop)
                ph_only = ck.band_synth_ph(*args, drop)
                power = y_p.double().pow(2).sum(dim=(1, 2, 3)).max().item()
                err_ph, _ = max_err(ph_k, ph_p)
                errs.append(err_ph / power)
                ok = (ok and err_ph <= 2e-5 * power
                      and (DEV == "cpu" or (torch.equal(y_only, y_k)
                                            and torch.equal(ph_only, ph_k))))
            if not ok:
                fail(f"band_synth n_band {n_band}, drop {drop}: y err / RMS, "
                     f"phasor err / band power {errs} (tol 1e-5, 2e-5), or "
                     f"the forms are not bit-equal")
            worst[n_band] = max(worst.get(n_band, 0.0), errs[0])
    say("kernel band_synth x3 at n_band 128 (y only), 512, 2048, 16384: "
        "row_start and d_shift at their extremes, drop 0 and 2 P, within "
        "1e-5 of y's RMS and 2e-5 of the band power, the forms bit-equal; "
        "worst y err / RMS " + ", ".join(f"{k}: {v:.2e}"
                                         for k, v in worst.items()))


# (form, span, source rows, starts or a count of random starts): sorted,
# unsorted, duplicate, disjoint and overlapping starts, wrap rows, odd
# starts, an odd n_band, C = 1 and C = 2 (the element path's size)
EXTRACT_SHAPES = (
    ("rows", 8, 40, [0, 3, 17, 32]), ("rows", 8, 40, [32, 31, 0, 30, 30]),
    ("rows", 8, 40, [32]), ("rows", 8, 40, [0, 32]),
    ("rows", 64, 2000, 300), ("rows", 128, 4224, 50),
    ("pairs", 64, 1088, [0, 2, 512, 1024]),
    ("pairs", 64, 1088, [1, 3, 511, 1023]), ("pairs", 64, 1088, [5]),
    ("pairs", 64, 1088, [0, 1]), ("pairs", 64, 1088, [7, 7, 7, 6]),
    ("pairs", 63, 1087, [0, 1, 512, 1023]), ("pairs", 2, 1088, [1, 3, 1086]),
    ("pairs", 8192, 2 ** 18 + 8192, 200), ("pairs", 64, 2 ** 15 + 64, 2457))


def check_extract_shapes(rng) -> None:
    """Both extraction kernels bit-equal to their plain versions at
    EXTRACT_SHAPES."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    dev = torch.device(DEV)
    for form, span, n_rows, starts in EXTRACT_SHAPES:
        if isinstance(starts, int):
            starts = rng.integers(0, n_rows - span + 1, starts)
        starts = np.asarray(starts, np.int32)
        shape = (2, n_rows, 128) if form == "rows" else (n_rows, 2)
        src = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
        plan = ck.ExtractPlan(form, starts, span, n_rows)
        rows = form == "rows"
        got = (ck.band_extract_rows if rows else ck.band_extract)(
            src, plan, span)
        want = (ck.band_extract_rows_plain if rows else
                ck.band_extract_plain)(
            src, torch.from_numpy(starts).to(dev), span)
        if not torch.equal(got, want):
            fail(f"band_extract {form}: span {span} of {n_rows} rows, "
                 f"C={len(starts)}: differs from the plain version")
    say(f"kernels band_extract_rows, band_extract: {len(EXTRACT_SHAPES)} "
        f"shapes (C = 1 to 2457, spans 2 to 8192, odd starts and n_band, "
        f"duplicates, wrap rows) equal to the plain versions")


def phase_extract_grids(seed: int) -> dict:
    """The extraction kernels on real channel grids' starts: the rows form
    on the fleet-aligned bank's row starts (C=1024, 40.96 MHz); the pairs
    form, which runs where n_band is no multiple of 128, on the decode
    element bank's (C=2, 2.4 MHz, nfft 1024, n_band 64: its launch a
    block) and on the largest C such a bank admits (the 25 kHz grid
    filling 61.44 MHz, nfft 32768, n_band 64: C = 2457).  Equality, call,
    launch alone, gather and bound as in phase_kernels; a list of results
    a kernel."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp.channelizer import FFTChannelizer
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    rng = np.random.default_rng(seed)
    dev = torch.device(DEV)
    res = {"band_extract_rows": [], "band_extract": []}
    for shape, ch in (
            ("C=1024 fs=40.96MHz aligned", FFTChannelizer(
                FS_ALIGNED, grid(1024), kernel_synth=False,
                kernel_extract=True)),
            ("C=2 fs=2.4MHz nfft=1024 n_band=64 (decode element)",
             CarrierBankDemod(fs=FS_RTL, freqs_hz=list(RTL_OFFSETS),
                              frontend="fft", afc=True,
                              nfft=1024).channelizer),
            (f"C={int(FS_ELEMENT // 25_000)} fs={FS_ELEMENT / 1e6:g}MHz "
             f"nfft={NFFT_ELEMENT} n_band=64", FFTChannelizer(
                 FS_ELEMENT, grid(int(FS_ELEMENT // 25_000)),
                 nfft=NFFT_ELEMENT))):
        plan = ch.extract_plan
        if plan.form == "pairs" and plan.span % 128 == 0:
            fail(f"band_extract grid {shape}: n_band {plan.span}")
        starts = torch.from_numpy(plan.starts).to(dev)
        if plan.form == "rows":
            name = "band_extract_rows"
            src = torch.from_numpy(rng.standard_normal(
                (2, plan.n_rows, 128)).astype(np.float32)).to(dev)
            idx = (starts.long()[:, None, None]
                   + torch.arange(plan.span, device=dev)[None, None, :])
            pl_idx = torch.arange(2, device=dev)[None, :, None]

            def gather(src=src, pl_idx=pl_idx, idx=idx):
                return src[pl_idx, idx]
        else:
            name = "band_extract"
            src = torch.from_numpy(rng.standard_normal(
                (plan.n_rows, 2)).astype(np.float32)).to(dev)
            idx = (starts.long()[:, None]
                   + torch.arange(plan.span, device=dev)[None, :])

            def gather(src=src, idx=idx):
                return src[idx]
        r = extract_result(f"{name} grid {shape}", src, plan, starts, gather,
                           10, 100)
        r["shape"] = shape
        res[name].append(r)
        say(f"kernel {name} on the {shape} grid: equal to the plain "
            f"version; call {r['ms']:.4f} ms, launch {r['launch_ms']:.4f}, "
            f"gather {r['library_ms']:.4f}, plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.5f} ({r['source_bytes']} distinct "
            f"source bytes)")
    return res


def check_frame_scan_edges(rng) -> None:
    """frame_scan_even at the edge lengths of its planes (22: one sync
    position, no CRC position; 229 to 233 around the first CRC position;
    odd lengths; 1426; 5266, the fleet row) on 37 rows: all zeros, all
    ones, a golden frame at the first and at the last CRC position,
    random bits; both planes bit-identical to the plain version."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp import framescan
    from tetraear_tpu_torch.ref import golden
    dev = torch.device(DEV)
    frame = golden.build_stream([golden.sds_text_payload("EDGE")] * 2,
                                seed=9)
    lengths = (22, 23, 229, 230, 231, 233, 1426, 5266, 5267)
    for n in lengths:
        rows = rng.integers(0, 2, (37, n)).astype(np.uint8)
        rows[0], rows[1] = 0, 1
        _, pc_n = framescan.plane_dims(n)
        if pc_n > 0:
            last = 2 * (pc_n - 1)
            seg = frame[:n]
            rows[2, :len(seg)] = seg
            rows[3, last:] = frame[:n - last]
        rows_d = torch.from_numpy(rows).to(dev)
        corr_k, err_k = ck.frame_scan_even(rows_d)
        corr_p, err_p = ck.frame_scan_even_plain(rows_d)
        if not (corr_k.shape == corr_p.shape and err_k.shape == err_p.shape
                and torch.equal(corr_k, corr_p)
                and torch.equal(err_k, err_p)):
            fail(f"frame_scan_even n={n}: planes {tuple(corr_k.shape)} "
                 f"{tuple(err_k.shape)} differ from the plain version")
        if n >= 510 and not (int(err_k[2, 0]) <= 2
                             and int(err_k[3, pc_n - 1]) <= 2
                             and int(err_k[0].min()) == 99
                             and int(err_k[1].min()) == 99):
            fail(f"frame_scan_even n={n}: planted frames or degenerate "
                 f"rows not seen")
    say(f"kernel frame_scan_even at n = {', '.join(map(str, lengths))}: 37 "
        f"rows (zeros, ones, a frame at the first and the last position, "
        f"random) bit-identical to the plain version")


def phase_int_rate() -> dict:
    """The card's integer instruction rates from a register-only loop, beside
    the figures the bounds use."""
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp import probes
    dev = torch.device(DEV)
    small = torch.empty(1024, dtype=torch.int32, device=dev)
    for kind in probes.INT_RATE_KINDS:
        got = probes.int_rate(kind, 5, small).cpu()
        if not torch.equal(got, probes.int_rate_plain(kind, 5, 1024)):
            fail(f"int_rate {kind}: differs from the plain version")
    n, iters = (1024, 8) if DEV == "cpu" else (N_SMS * 2048 * 4, 4096)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    ck.reset_launches()
    rates = {}
    for kind in probes.INT_RATE_KINDS:
        ms = event_ms(lambda: probes.int_rate(kind, iters, out), 3)
        rates[kind] = 8.0 * iters * n / (ms * 1e-3)
    sync()
    counts = dict(ck.launches)
    need_launched("integer rates", counts, ("int_rate",))
    per_s = N_SMS * SM_CLOCK_HZ
    say(f"integer rates: three-input logic {rates['logic'] / 1e12:.2f} T/s "
        f"and three-input additions {rates['add'] / 1e12:.2f} T/s (the "
        f"bounds use {LOGIC_PER_CLK_SM * per_s / 1e12:.2f}: 64 a clock an "
        f"SM, {N_SMS} SMs, {SM_CLOCK_HZ / 1e6:.0f} MHz), population counts "
        f"{rates['popc'] / 1e12:.2f} T/s each with an exclusive-or (the "
        f"bounds use {QUARTER_PER_CLK_SM * per_s / 1e12:.2f}: 16 a clock)")
    return {"logic_per_s": rates["logic"], "add_per_s": rates["add"],
            "popc_per_s": rates["popc"],
            "sm_clock_hz": SM_CLOCK_HZ,
            "bound_logic_per_s": LOGIC_PER_CLK_SM * per_s,
            "bound_quarter_per_s": QUARTER_PER_CLK_SM * per_s}


def phase_kernels_extra(seed: int) -> None:
    """The redesigned kernels at the other geometries the paths use:
    fft2p at nfft 2^14 (128 x 128) and 2^18 (512 x 512) with and
    without splice and wrap rows; fused_backhalf at C=8 / 2.304 MHz with
    no, half and all symbols valid; band_synth's three forms at the
    other band lengths; frame_scan_even at its planes' edge lengths."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    rng = np.random.default_rng(seed)
    dev = torch.device(DEV)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    for n1, n2 in ((128, 128), (512, 512)):
        for o2, wrap in ((0, 0), (0, 2), (8, 0), (64, 2)):
            args = (randn(2, o2, n1), randn(2, n2 - o2, n1), n1, n2, wrap)
            ref = ck.fft2p_plain(*args)
            err, rms = max_err(ck.fft2p_planes_spliced(*args), ref)
            g_p = ck.fft2p_pass1_plain(*args[:4])
            err_g, rms_g = max_err(ck.fft2p_pass1(*args[:4]), g_p)
            if not (err <= 1e-4 * rms and err_g <= 1e-4 * rms_g):
                fail(f"fft2p {n1} x {n2}, o2 {o2}, wrap {wrap}: max err "
                     f"{err:.3e} (tol {1e-4 * rms:.3e}), pass 1 "
                     f"{err_g:.3e} (tol {1e-4 * rms_g:.3e})")
        say(f"kernel fft2p {n1} x {n2}: o2 0, 8, 64 and wrap 0, 2 within "
            f"1e-4 of the RMS of the plain versions (last: {err:.3e} of "
            f"{rms:.3e}, pass 1 {err_g:.3e} of {rms_g:.3e})")

    bank = CarrierBankDemod(fs=FS_SMALL, freqs_hz=grid(8), frontend="fft")
    fused = FusedRx(bank, DEV)
    ns = 128 * fused.sy
    state = fused.init_state()
    state["bank"]["timing"]["tail"] = randn(8, 4, 2)
    state["bank"]["prev_sym"] = randn(8, 2)
    state["bit_tail"][:, :, :] = torch.from_numpy(
        rng.integers(0, 2, (8, 10, 128)).astype(np.float32)).to(dev)
    state["bit_tail"].view(8, -1)[:, ck.TAILBITS:] = 0.0
    rot = (torch.ones(8, device=dev), torch.zeros(8, device=dev))
    g = fused.glue(randn(8, 1, 128), rot, state)
    for nv in (0, ns // 2, ns):
        g["sc"][:, 4] = float(nv)
        args = fused.backhalf_args(randn(8, 2, 128, fused.p), g, state)
        out_k = ck.fused_backhalf(*args)
        out_p = ck.fused_backhalf_plain(*args, ck.z_rows_for(fused.p))
        for name, a, b in zip(("corr", "err", "soft", "bt2", "last",
                               "misc"), out_k, out_p):
            e, _ = max_err(a, b)
            exact = name in ("corr", "err", "bt2")
            if (exact and e != 0.0) or e > 1e-6:
                fail(f"fused_backhalf C=8, {nv} valid symbols: {name} "
                     f"differs by {e:.3e}")
    say(f"kernel fused_backhalf C=8 at {FS_SMALL / 1e6:g} MHz: 0, "
        f"{ns // 2} and {ns} valid symbols equal to the plain version")
    check_band_synth_sizes(rng)
    check_frame_scan_edges(rng)
    check_extract_shapes(rng)


# Integer operations of the scan (csrc/scan.cuh) a position, as (logic,
# quarter-rate) counts, a three-input logic operation counted as one and
# population counts and the int-to-float conversion at a quarter of its
# rate.  Every position: the sync test (funnel shift, mask, 2 xor, min,
# subtraction; 2 counts), the verdict (2 compares and their or, xor,
# select; 1 count), the conversion and its multiply, two stores.  A
# position evaluated in full: 9 loads, 8 funnel shifts, the data view's
# ones (8 and, 8 add; 8 counts), 16 syndrome rows folded over 8 words
# (and-xor) each with a count and its bit put in place, the three words of
# leaving and entering bits.  A position slid from the last: the step
# matrix (shift, 2 tests, 2 xor) and 8 bits each a test, an xor and an
# add.  A run of k positions is one in full and k - 1 slid.
SCAN_EACH = (15.0, 4.0)
SCAN_FULL = (8 + 9 + 16 + 128 + 16 * 2 + 9 + 7.0, 8 + 16.0)
SCAN_SLIDE = (5 + 8 * 3.0, 0.0)


def scan_ops(k: int) -> tuple:
    """(logic, quarter-rate) operations a position in runs of k."""
    return tuple(e + (f + (k - 1) * sl) / k
                 for e, f, sl in zip(SCAN_EACH, SCAN_FULL, SCAN_SLIDE))


# operations of one sample of one row of the serial recursion
# (csrc/probes.cu): the shift pair, ten multiplies each with a saturating
# subtraction (widen, subtract, two clamps), the output's shift and sign
# extension, ten register moves, load and store
IIR_OPS = 2 + 10 * 6 + 2 + 10 + 2.0


def frames_key(frames: list) -> list:
    return [(f["carrier"], f["stream_symbol"], bool(f.get("burst_crc")),
             f.get("sds_message")) for f in frames]


def crc_texts(frames: list, carriers) -> list:
    """CRC-passing frames of the given carriers, in order."""
    keep = set(carriers)
    return [k for k in frames_key(frames) if k[2] and k[0] in keep]


def run_pipeline(source, fs: float, offsets, device: str,
                 blocks_per_dispatch: int, **cfg) -> tuple:
    """Pipeline.run_offline with launch counts taken around the run;
    returns (frames, stats, pipe, launches)."""
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    frames = []
    cfg.setdefault("validate", False)
    cfg.setdefault("voice", False)
    pipe = Pipeline(PipelineConfig(sample_rate=fs,
                                   carrier_offsets_hz=tuple(offsets),
                                   device=device, **cfg),
                    on_frame=frames.append)
    ck.reset_launches()
    stats = pipe.run_offline(source,
                             blocks_per_dispatch=blocks_per_dispatch)
    sync()
    return frames, stats, pipe, dict(ck.launches)


def array_source(iq, fs):
    from tetraear_tpu_torch.golden import ArraySource
    return ArraySource(iq, fs)


# the receive phases run with voice off, as they did before the voice
# chain was ported, so that their numbers stay comparable
FUSED_CFG = dict(frontend="fft", carrier_afc=False, auto_decrypt=False,
                 voice=False)


def need_launched(phase: str, counts: dict, names) -> None:
    """Fail unless every named kernel was launched in the run whose
    counts these are (on the card; the rehearsal launches none)."""
    if DEV == "cpu":
        return
    missing = [n for n in names if counts.get(n, 0) == 0]
    if missing:
        fail(f"{phase}: never launched {missing}; launches {counts}")


def phase_decode_small() -> None:
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.golden import fleet_capture
    offsets = grid(8)
    bl = CarrierBankDemod(fs=FS_SMALL, freqs_hz=offsets,
                          frontend="fft").block_len
    iq = fleet_capture(FS_SMALL, offsets, range(8), 3 * bl, seed=7,
                       text="SMALL")
    f_gpu, _, pipe, counts = run_pipeline(
        array_source(iq, FS_SMALL), FS_SMALL, offsets, DEV, 2, **FUSED_CFG)
    if pipe.runner.fused is None:
        fail("decode small: not on the fused path")
    need_launched("decode small", counts, FUSED_KERNELS)
    f_cpu, _, _, _ = run_pipeline(
        array_source(iq, FS_SMALL), FS_SMALL, offsets, "cpu", 2, **FUSED_CFG)
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


def check_fleet_texts(phase: str, frames: list, active: list) -> None:
    """Every modulated carrier's SDS text comes back on its own carrier
    and on no other.  Idle carriers carry noise, where the soft CRC
    (<= 2 bit errors) passes by chance as in the reference."""
    good = {f["carrier"] for f in frames
            if f.get("burst_crc")
            and f.get("sds_message") == f"[TXT] FLEET {f['carrier']}"}
    if good != set(active):
        fail(f"{phase}: SDS text on carriers {sorted(good)}, expected "
             f"{active}")
    wrong = [f for f in frames if f.get("burst_crc")
             and str(f.get("sds_message", "")).startswith("[TXT] FLEET")
             and f.get("sds_message") != f"[TXT] FLEET {f['carrier']}"]
    if wrong:
        fail(f"{phase}: {len(wrong)} texts on the wrong carrier")


# encrypted carriers of the fleet captures: carrier -> (cipher, common
# key), each pair one that the reference's key-plan order decodes to the
# carrier's own text (an earlier common key can score higher on another
# carrier's plaintext)
ENCRYPTED = {
    1024: {256: ("TEA1", "0123456789ABCDEF0123"),
           597: ("TEA1", "FEDCBA9876543210FEDC"),
           85: ("TEA2", "0123456789ABCDEF0123456789ABCDEF"),
           939: ("TEA2", "FEDCBA9876543210FEDCBA9876543210")},
    8: {6: ("TEA1", "0123456789ABCDEF0123"),
        7: ("TEA2", "FEDCBA9876543210FEDCBA9876543210")},
}


def fleet_setup(fs: float, c: int, nfft: int | None, n_blocks: int,
                seed: int, encrypted: bool = False) -> dict:
    """Offsets, modulated carriers, encrypted carriers and capture of a
    fleet decode."""
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.golden import fleet_capture
    offsets = grid(c)
    enc = ({ci: (cipher, bytes.fromhex(key))
            for ci, (cipher, key) in ENCRYPTED[c].items()}
           if encrypted else {})
    active = ([5, 170, 341, 512, 683, 854, 1019] if c == 1024
              else [0, 2, 4, 5] if encrypted
              else sorted({(c - 1) * i // 6 for i in range(7)}))
    bl = CarrierBankDemod(fs=fs, freqs_hz=offsets, frontend="fft",
                          nfft=nfft).block_len
    t0 = time.time()
    iq = fleet_capture(fs, offsets, active, n_blocks * bl, seed=seed,
                       encrypted=enc)
    say(f"capture at {fs / 1e6:g} MHz: {len(active)} of {c} carriers "
        f"modulated, {len(enc)} of them TEA-encrypted "
        f"({', '.join(f'{ci} {v[0]}' for ci, v in sorted(enc.items()))}), "
        f"over {n_blocks} blocks, made in {time.time() - t0:.1f} s")
    return {"fs": fs, "offsets": offsets, "active": active,
            "encrypted": enc, "iq": iq, "block_len": bl}


def check_enc_texts(phase: str, frames: list, encrypted: dict) -> int:
    """Every encrypted carrier's SDS text comes back decrypted on its own
    carrier and on no other; returns the decrypted frames."""
    from tetraear_tpu_torch.golden import secret_text
    good = {}
    for f in frames:
        if f.get("burst_crc") and f.get("decrypted"):
            good.setdefault(f["carrier"], []).append(f.get("sds_message"))
    for ci in encrypted:
        want = "[TXT] " + secret_text(ci)[1:].rstrip(b"\0").decode()
        if want not in good.get(ci, []):
            fail(f"{phase}: carrier {ci}'s encrypted text not decrypted "
                 f"({good.get(ci, [])[:3]})")
    wrong = [f for f in frames if str(f.get("sds_message", "")).startswith(
        "[TXT] SECRET ") and f.get("sds_message") != f"[TXT] SECRET {f['carrier']}"]
    if wrong:
        fail(f"{phase}: {len(wrong)} decrypted texts on the wrong carrier")
    return sum(len(v) for ci, v in good.items() if ci in encrypted)


def phase_decode_fleet(c: int, setup: dict) -> tuple:
    """The fused path at fleet size, encrypted carriers decrypted by the
    deferred key search; returns (launches, frames)."""
    fs, offsets, active = setup["fs"], setup["offsets"], setup["active"]
    t0 = time.time()
    frames, stats, pipe, counts = run_pipeline(
        array_source(setup["iq"], fs), fs, offsets, DEV, 2,
        **dict(FUSED_CFG, auto_decrypt=True))
    wall = time.time() - t0
    if pipe.runner.fused is None:
        fail("decode fleet: not on the fused path")
    need_launched("decode fleet", counts, FUSED_KERNELS + ("tea_search",))
    check_fleet_texts("decode fleet", frames, active)
    n_dec = check_enc_texts("decode fleet", frames, setup["encrypted"])
    say(f"decode fleet C={c}: {stats.frames} frames, {stats.crc_pass} CRC "
        f"pass, SDS text on carriers {active}, {n_dec} decrypted on the "
        f"encrypted carriers; launches {counts}; wall {wall:.2f} s incl. "
        f"first-call setup")
    return counts, frames


def phase_decode_rtl() -> dict:
    """The upstream deployment: the defaults on the off-air fixture."""
    from tetraear_tpu_torch.runtime.sources import FileIQSource
    launches = {}
    for frontend, kernels in (("conv", ("frame_scan_even",)),
                              ("fft", ("frame_scan_even", "band_synth_y"))):
        runs = {}
        for device in (DEV, "cpu"):
            frames, stats, pipe, counts = run_pipeline(
                FileIQSource(FIXTURE, sample_rate=FS_RTL), FS_RTL,
                RTL_OFFSETS, device, 16, frontend=frontend, validate=True)
            runs[device] = (frames, stats, counts)
            if pipe.runner.fused is not None or not pipe.bank.afc:
                fail(f"decode rtl {frontend}: expected the classic chain "
                     f"with AFC")
        frames, stats, counts = runs[DEV]
        need_launched(f"decode rtl {frontend}", counts, kernels)
        if frames_key(frames) != frames_key(runs["cpu"][0]):
            fail(f"decode rtl {frontend}: card frames ({len(frames)}) "
                 f"differ from the CPU run ({len(runs['cpu'][0])})")
        texts = [(f["carrier"], f.get("sds_message")) for f in frames]
        n_clear = texts.count((0, "[TXT] FIXTURE CAPTURE OK"))
        n_dec = texts.count((1, "[TXT] SECRET FIX MSG"))
        if stats.crc_pass < 16 or n_clear < 8 or n_dec < 8:
            fail(f"decode rtl {frontend}: crc_pass {stats.crc_pass}, "
                 f"clear texts {n_clear}, decrypted texts {n_dec}")
        say(f"decode rtl {frontend}: block {pipe.block_len}, "
            f"{stats.blocks} blocks, {stats.frames} frames, "
            f"{stats.crc_pass} CRC pass, {n_clear} clear + {n_dec} "
            f"decrypted SDS texts, equal to the CPU run; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        launches[frontend] = counts
        # the dense-plane fetch (sparse_hits=False) selects the same frames
        dense, _, pipe, _ = run_pipeline(
            FileIQSource(FIXTURE, sample_rate=FS_RTL), FS_RTL, RTL_OFFSETS,
            DEV, 16, frontend=frontend, validate=True, sparse_hits=False)
        if pipe.runner.sparse or frames_key(dense) != frames_key(frames):
            fail(f"decode rtl {frontend}: the dense-plane run's frames "
                 f"differ from the sparse run's")
    say("decode rtl: dense-plane runs equal to the sparse runs")
    return launches


def run_runner(iq, bank, device: str, blocks_per_dispatch: int = 2,
               **opts) -> tuple:
    """DecodeRunner.run with launch counts taken around the run."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.frame.batch import BatchedFrameDecoder
    from tetraear_tpu_torch.runtime.stream import DecodeRunner
    runner = DecodeRunner(
        bank, BatchedFrameDecoder(bank.n_carriers, auto_decrypt=True,
                                  device=device),
        blocks_per_dispatch=blocks_per_dispatch, device=device, **opts)
    ck.reset_launches()
    out = runner.run(iq)
    sync()
    return out["frames"], runner, dict(ck.launches)


def phase_decode_fleet_afc(c: int, setup: dict, fused_frames: list,
                           nfft: int | None, workers: int = 0) -> tuple:
    """The classic chain (AFC on) beside the fused one, same capture: its
    CRC-passing frames on the modulated carriers equal the fused path's.
    With the in-process frame layer and no decryption; or, with
    ``workers``, on the worker-sharded layer with the encrypted carriers
    decrypted (the reference of the classic stream phase, which runs
    that layer: the two layers reassemble differently on noise carriers,
    because scoring candidate plaintexts feeds the MAC parsers of the
    decoders that score).  Returns (launches, frames)."""
    fs, offsets, active = setup["fs"], setup["offsets"], setup["active"]
    name = "decode fleet-afc" + ("-workers" if workers else "")
    kernels = ("frame_scan_even", "band_synth_y")
    t0 = time.time()
    frames, stats, pipe, counts = run_pipeline(
        array_source(setup["iq"], fs), fs, offsets, DEV, 2,
        frontend="fft", carrier_afc=True, auto_decrypt=bool(workers),
        frame_workers=workers)
    pipe.close()
    wall = time.time() - t0
    if pipe.runner.fused is not None:
        fail(f"{name}: expected the classic chain")
    if nfft is None and not pipe.bank.channelizer.quantized:
        fail(f"{name}: expected the quantized extraction")
    need_launched(name, counts,
                  kernels + (("tea_search",) if workers else ()))
    check_fleet_texts(name, frames, active)
    if workers:
        check_enc_texts(name, frames, setup["encrypted"])
    got, want = crc_texts(frames, active), crc_texts(fused_frames, active)
    if got != want:
        fail(f"{name}: {len(got)} CRC-passing frames on the "
             f"modulated carriers, the fused path has {len(want)}; first "
             f"difference {next((a, b) for a, b in zip(got + [None], want + [None]) if a != b)}")
    say(f"{name} C={c}: {stats.frames} frames, {stats.crc_pass} "
        f"CRC pass, {len(got)} on the modulated carriers, equal to the "
        f"fused path's"
        + (f" ({workers} frame workers, encrypted carriers decrypted)"
           if workers else "")
        + f"; launches { {k: v for k, v in counts.items() if v} }; wall "
        f"{wall:.2f} s")
    return counts, frames


def stream_pipeline(setup: dict, workers: int, on_frame, on_audio=None,
                    **cfg):
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    cfg.setdefault("voice", False)
    return Pipeline(PipelineConfig(
        sample_rate=setup["fs"], carrier_offsets_hz=tuple(setup["offsets"]),
        device=DEV, detect_gate=False, validate=False,
        frame_workers=workers, **cfg), on_frame=on_frame, on_audio=on_audio)


def phase_stream(name: str, c: int, setup: dict, offline: list,
                 kernels, workers: int = 0, tea_calls: list | None = None,
                 **cfg) -> tuple:
    """The live path on a fleet capture: Pipeline.process_block block by
    block, save_checkpoint after block 2, the rest on a fresh Pipeline
    after load_checkpoint.  Its frame list must equal run_offline's on
    the same capture (``offline``), the encrypted carriers' texts come
    back decrypted, and every kernel of the path (the key search too)
    was launched.  ``tea_calls`` collects the inputs of each deferred
    key search (record_tea_calls).  Returns (launches, wall s)."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    path = ROOT / "build" / f"chip_smoke_{name}.npz"
    path.parent.mkdir(exist_ok=True)
    bl = setup["block_len"]
    blocks = [setup["iq"][i * bl:(i + 1) * bl]
              for i in range(len(setup["iq"]) // bl)]
    frames = []
    undo = record_tea_calls(tea_calls) if tea_calls is not None else None
    ck.reset_launches()
    t0 = time.time()
    pipe = stream_pipeline(setup, workers, frames.append, **cfg)
    try:
        for b in blocks[:2]:
            pipe.process_block(b)
        pipe.save_checkpoint(path)
    finally:
        pipe.close()
    pipe = stream_pipeline(setup, workers, frames.append, **cfg)
    try:
        pipe.load_checkpoint(path)
        for b in blocks[2:]:
            pipe.process_block(b)
        sync()
        counts = dict(ck.launches)
        wall = time.time() - t0
        sharded = type(pipe.batch).__name__
    finally:
        pipe.close()
        if undo is not None:
            undo()
    path.unlink()
    need_launched(f"stream {name}", counts, tuple(kernels) + ("tea_search",))
    if frames_key(frames) != frames_key(offline):
        diff = next((a, b) for a, b in zip(frames_key(frames) + [None],
                                           frames_key(offline) + [None])
                    if a != b)
        fail(f"stream {name}: {len(frames)} frames from process_block and a "
             f"checkpoint, run_offline gave {len(offline)}; first "
             f"difference {diff}")
    check_fleet_texts(f"stream {name}", frames, setup["active"])
    n_dec = check_enc_texts(f"stream {name}", frames, setup["encrypted"])
    say(f"stream {name} C={c}: process_block over {len(blocks)} blocks, "
        f"checkpoint after block 2 onto a fresh Pipeline ({sharded}"
        f"{f', {workers} workers' if workers else ''}): {len(frames)} "
        f"frames equal to run_offline's, {n_dec} decrypted on the "
        f"encrypted carriers; launches "
        f"{ {k: v for k, v in counts.items() if v} }; wall {wall:.2f} s "
        f"incl. setup")
    return counts, wall


def process_block_split(pipe, blocks: list, n_frame: int | None = None,
                        n_whole: int | None = None) -> dict:
    """ms a block of Pipeline.process_block's parts on fresh host blocks,
    each ended by a synchronise: the complex64 block copied to the card,
    its split into the back half's layout there (DecodeRunner.split, the
    layout step of DecodeRunner.ingest), the device block step, fetch +
    frame layer (on the first ``n_frame`` timed blocks only); then
    process_block itself on the first ``n_whole``; and, beside them,
    what the JAX package's ingest would cost instead: the host conversion
    (kernels.c2p_np / c2r_np) and the copy of its float32 result.
    blocks[0] is a warm-up."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import kernels
    runner = pipe.runner
    parts = {k: [] for k in ("host_to_device", "card_split", "block_step",
                             "frame_layer", "process_block",
                             "host_conversion", "host_conversion_copy")}
    timed = blocks[1:]
    n_frame = len(timed) if n_frame is None else n_frame
    n_whole = len(timed) if n_whole is None else n_whole
    pipe.process_block(blocks[0])          # warm-up: first-call setup
    sync()
    for i, b in enumerate(timed):
        t0 = time.perf_counter()
        xc = torch.from_numpy(np.require(b[None], np.complex64, ("C", "W")))
        xc = xc.to(pipe.device, copy=True)
        sync()
        t1 = time.perf_counter()
        x = runner.split(xc)[0]
        sync()
        t2 = time.perf_counter()
        ys, pipe.state = runner.step(x, pipe.state)
        sync()
        t3 = time.perf_counter()
        parts["host_to_device"].append((t1 - t0) * 1e3)
        parts["card_split"].append((t2 - t1) * 1e3)
        parts["block_step"].append((t3 - t2) * 1e3)
        if i < n_frame:
            runner.frames_of(runner.fetch(ys))
            parts["frame_layer"].append((time.perf_counter() - t3) * 1e3)
        t0 = time.perf_counter()
        host = (kernels.c2p_np if runner.fused else kernels.c2r_np)(b)
        t1 = time.perf_counter()
        xh = torch.from_numpy(host).to(pipe.device)
        sync()
        t2 = time.perf_counter()
        parts["host_conversion"].append((t1 - t0) * 1e3)
        parts["host_conversion_copy"].append((t2 - t1) * 1e3)
        if not torch.equal(xh, x):
            fail("process_block split: the card's split differs from the "
                 "host conversion")
        del x, xc, xh, host
    for b in timed[:n_whole]:
        t0 = time.perf_counter()
        pipe.process_block(b)
        sync()
        parts["process_block"].append((time.perf_counter() - t0) * 1e3)
    return {k: sum(v) / len(v) for k, v in parts.items()} | {
        "blocks": len(timed), "frame_layer_blocks": n_frame,
        "process_block_blocks": n_whole, "block_ms": pipe.block_len
        / pipe.config.sample_rate * 1e3,
        "block_mbytes": pipe.block_len * 8 / 1e6}


def phase_process_block_timing(name: str, setup: dict | None, fs: float,
                               c: int, n_blocks: int, seed: int,
                               chain_ms: float | None,
                               n_frame: int | None = None,
                               n_whole: int | None = None,
                               workers: int = 0) -> dict:
    """process_block ms/block on fresh host blocks (the capture's, or
    noise when ``setup`` is None), split by part, beside the resident
    chained step; the frame layer and process_block itself on the first
    ``n_frame`` / ``n_whole`` timed blocks (the frame layer's time is the
    host's, and a noise block at C=10240 takes seconds of it), in process
    or on ``workers`` frame workers."""
    import numpy as np
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    pipe = Pipeline(PipelineConfig(
        sample_rate=fs, carrier_offsets_hz=tuple(grid(c)), device=DEV,
        detect_gate=False, validate=False, frame_workers=workers,
        **FUSED_CFG))
    bl = pipe.block_len
    if setup is not None:
        iq = setup["iq"]
        blocks = [iq[i * bl:(i + 1) * bl] for i in range(len(iq) // bl)]
    else:
        rng = np.random.default_rng(seed)
        blocks = []
        for _ in range(n_blocks + 1):
            v = rng.standard_normal(2 * bl, dtype=np.float32)
            blocks.append(v.view(np.complex64))
    try:
        r = process_block_split(pipe, blocks, n_frame, n_whole)
    finally:
        pipe.close()
    r["chain_ms"] = chain_ms
    r["frame_workers"] = workers
    say(f"process_block {name} C={c}"
        + (f" ({workers} frame workers)" if workers else "")
        + f": {r['process_block']:.2f} ms/block "
        f"over {r['process_block_blocks']} fresh host blocks of "
        f"{r['block_mbytes']:.0f} MB ({r['block_ms']:.1f} ms of signal); "
        f"over {r['blocks']} blocks: host-to-device "
        f"{r['host_to_device']:.2f}, split on the card "
        f"{r['card_split']:.2f}, block step {r['block_step']:.2f}, fetch + "
        f"frame layer {r['frame_layer']:.2f} ms (over "
        f"{r['frame_layer_blocks']}); the resident chained step "
        + (f"{chain_ms:.2f} ms" if chain_ms is not None else "not timed")
        + f"; the JAX package's ingest instead: host conversion "
        f"{r['host_conversion']:.2f} and its copy "
        f"{r['host_conversion_copy']:.2f} ms")
    del pipe, blocks
    return r


def phase_decode_fleet_aligned(c: int, nfft: int | None) -> tuple:
    """40.96 MHz: the 25 kHz grid falls on 128-bin starts (aligned).
    Default (synthesis kernel without phasor) through Pipeline, then the
    row-extraction kernel through DecodeRunner on a bank built with the
    extraction keyword; the two frame lists must be equal."""
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    setup = fleet_setup(FS_ALIGNED, c, nfft, 2, seed=13)
    offsets, active, iq = setup["offsets"], setup["active"], setup["iq"]
    frames, stats, pipe, counts = run_pipeline(
        array_source(iq, FS_ALIGNED), FS_ALIGNED, offsets, DEV, 2,
        frontend="fft", carrier_afc=True, auto_decrypt=False)
    ch = pipe.bank.channelizer
    if pipe.runner.fused is not None or not pipe.bank.plan.stages:
        fail("decode fleet-aligned: expected the classic chain with a "
             "resample stage")
    if nfft is None and not (ch.aligned and ch.synth_ok):
        fail(f"decode fleet-aligned: aligned={ch.aligned}")
    need_launched("decode fleet-aligned", counts,
                  ("frame_scan_even", "band_synth_y"))
    check_fleet_texts("decode fleet-aligned", frames, active)
    say(f"decode fleet-aligned C={c}: block {pipe.block_len}, "
        f"{stats.frames} frames, {stats.crc_pass} CRC pass, SDS text on "
        f"carriers {active}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")

    bank = CarrierBankDemod(fs=FS_ALIGNED, freqs_hz=offsets, frontend="fft",
                            afc=True, nfft=nfft, kernel_synth=False,
                            kernel_extract=True)
    if nfft is None and not bank.channelizer.use_extract_rows:
        fail("decode fleet-aligned: the extraction keyword did not take")
    frames_x, _, counts_x = run_runner(iq, bank, DEV)
    if bank.channelizer.use_extract_rows:
        need_launched("decode fleet-aligned (extraction)", counts_x,
                      ("frame_scan_even", "band_extract_rows"))
    if counts_x.get("band_synth_y"):
        fail("decode fleet-aligned (extraction): the synthesis kernel ran")
    if crc_texts(frames_x, active) != crc_texts(frames, active):
        fail("decode fleet-aligned: the extraction run's frames differ "
             "from the default run's")
    say(f"decode fleet-aligned C={c} with the row-extraction kernel: "
        f"{len(frames_x)} frames, equal on the modulated carriers; "
        f"launches { {k: v for k, v in counts_x.items() if v} }")
    return counts, counts_x


def phase_decode_element() -> dict:
    """A small run through the element-extraction branch: an nfft of
    1024 at 2.4 Msps makes n_band = 64, no multiple of 128."""
    import numpy as np
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.runtime.sources import FileIQSource
    with FileIQSource(FIXTURE, sample_rate=FS_RTL) as src:
        iq = np.asarray(src.read_samples(10 ** 7), np.complex64)
    runs = {}
    for device in (DEV, "cpu"):
        bank = CarrierBankDemod(fs=FS_RTL, freqs_hz=list(RTL_OFFSETS),
                                frontend="fft", afc=True, nfft=1024)
        ch = bank.channelizer
        if ch.aligned or ch.quantized or ch.n_band % 128 == 0:
            fail("decode element: not the element-extraction geometry")
        n = len(iq) // bank.block_len * bank.block_len
        runs[device] = run_runner(iq[:n], bank, device, 64)
    frames, _, counts = runs[DEV]
    need_launched("decode element", counts,
                  ("band_extract", "frame_scan_even"))
    if frames_key(frames) != frames_key(runs["cpu"][0]):
        fail("decode element: card frames differ from the CPU run")
    # bins of 2.3 kHz leave a 781 Hz residual on both carriers and the
    # blocks hold 6 symbols each, so the AFC loop locks late: few frames
    n_crc = sum(1 for f in frames if f.get("burst_crc"))
    if n_crc < 4:
        fail(f"decode element: {n_crc} CRC passes")
    say(f"decode element (nfft 1024, n_band 64): {len(frames)} frames, "
        f"{n_crc} CRC pass, equal to the CPU run; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def phase_phasor_probe(fs: float, c: int, nfft: int | None) -> dict:
    """The phasor-only synthesis as a pre-pass of one fused block: the
    timing phasor without the y round trip through device memory."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    bank = CarrierBankDemod(fs=fs, freqs_hz=grid(c), frontend="fft",
                            nfft=nfft)
    fused = FusedRx(bank, DEV)
    ch = bank.channelizer
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal(
        (2, bank.block_len)).astype(np.float32)).to(DEV)
    state = fused.init_state()
    _, ph, _, _ = fused.chan_raw(x, state["bank"]["channelizer"])
    ck.reset_launches()
    tail_p = state["bank"]["channelizer"]["tail"].t().contiguous()
    o2 = ch.overlap // ch.fft2p_n1
    planes = ck.fft2p_planes_spliced(
        tail_p.view(2, o2, ch.fft2p_n1),
        x.reshape(2, ch.fft2p_n2 - o2, ch.fft2p_n1), ch.fft2p_n1,
        ch.fft2p_n2, ch.fft2p_wrap)
    ph_only = ck.band_synth_ph(
        planes, fused.h1_planes, fused.row_start, fused.d_shift, fused.m1c,
        fused.m2re, fused.m2im, fused.twre, fused.twim, ch.synth_rows,
        ch.drop)
    sync()
    counts = dict(ck.launches)
    need_launched("phasor pre-pass", counts, ("fft2p", "band_synth_ph"))
    if not torch.equal(ph_only, ph):
        fail("phasor pre-pass: differs from the fused step's phasor")
    say(f"phasor pre-pass C={c}: band_synth_ph equals the fused step's "
        f"phasor; launches { {k: v for k, v in counts.items() if v} }")
    return counts


def phase_pass1_probe(fs: float, c: int, nfft: int | None) -> dict:
    """The pass-1 probe on one wideband block: fft2p_pass1's G, taken
    through a plain pass 2, must give the planes the whole kernel
    gives, so a fault lies in the pass that disagrees."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    ch = CarrierBankDemod(fs=fs, freqs_hz=grid(c), frontend="fft",
                          nfft=nfft).channelizer
    n1, n2 = ch.fft2p_n1, ch.fft2p_n2
    o2 = ch.overlap // n1
    rng = np.random.default_rng(29)
    win = torch.from_numpy(rng.standard_normal(
        (2, n2, n1)).astype(np.float32)).to(DEV)
    tail_p, x_p = win[:, :o2].contiguous(), win[:, o2:].contiguous()
    ck.reset_launches()
    g = ck.fft2p_pass1(tail_p, x_p, n1, n2)
    planes = ck.fft2p_planes_spliced(tail_p, x_p, n1, n2, ch.fft2p_wrap)
    sync()
    counts = dict(ck.launches)
    need_launched("pass-1 probe", counts, ("fft2p_pass1", "fft2p"))
    err, rms = max_err(ck.fft2p_pass2_plain(g, n1, n2, ch.fft2p_wrap),
                       planes)
    if not err <= 1e-4 * rms:
        fail(f"pass-1 probe C={c}: a plain pass 2 over fft2p_pass1's G "
             f"differs from fft2p by {err:.3e} (tol {1e-4 * rms:.3e})")
    say(f"pass-1 probe C={c}: plain pass 2 over G within {err:.3e} of "
        f"fft2p's planes (tol {1e-4 * rms:.3e}); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def phase_place_probe(fs: float, c: int, nfft: int | None) -> dict:
    """The placement probe on one fused block: from the block's soft
    bits (a decision bit is set where its soft bit is positive) and
    valid counts, bit_place alone must rebuild the carried bit tail the
    fused back half hands on."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp import probes
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    bank = CarrierBankDemod(fs=fs, freqs_hz=grid(c), frontend="fft",
                            nfft=nfft)
    fused = FusedRx(bank, DEV)
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal(
        (2, bank.block_len)).astype(np.float32)).to(DEV)
    state = fused.init_state()
    state["bit_tail"].view(c, -1)[:, :ck.TAILBITS] = torch.from_numpy(
        rng.integers(0, 2, (c, ck.TAILBITS)).astype(np.float32)).to(DEV)
    out, new_state = fused.step(x, state)
    ns = 128 * fused.sy
    n_valid = out["n_valid"]
    flat = out["soft_planes"].transpose(2, 3).reshape(c, 2, ns)
    valid = torch.arange(ns, device=DEV)[None, :] < n_valid[:, None]
    hard = ((2 * (flat[:, 0] > 0) + (flat[:, 1] > 0)) * valid).to(
        torch.uint8).contiguous()
    dsel = torch.clamp(n_valid - (bank.k_max - 2), 0, 2).to(torch.int32)
    ck.reset_launches()
    _, bt2 = probes.bit_place(hard, state["bit_tail"], dsel, bank.k_max,
                              ck.z_rows_for(fused.p))
    sync()
    counts = dict(ck.launches)
    need_launched("placement probe", counts, ("bit_place",))
    if not torch.equal(bt2, new_state["bit_tail"]):
        fail(f"placement probe C={c}: "
             f"{(bt2 != new_state['bit_tail']).sum().item()} bits of the "
             f"carried tail differ from the fused step's")
    say(f"placement probe C={c}: bit_place rebuilds the fused step's "
        f"carried tail from its soft bits ({int(n_valid.min())}-"
        f"{int(n_valid.max())} valid symbols); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def phase_ops_probe() -> dict:
    """The elementwise probe: every operation once, against PyTorch."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp import probes
    inputs = ops_inputs()
    ck.reset_launches()
    got = {op: probes.ops_probe(op, a, b) for op, (a, b) in inputs.items()}
    sync()
    counts = dict(ck.launches)
    need_launched("elementwise probe", counts, ("ops_probe",))
    rels = {}
    for op, (a, b) in inputs.items():
        ref = probes.ops_probe_plain(op, a, b).double()
        rels[op] = ((got[op].double() - ref).abs()
                    / ref.abs().clamp(min=1.0)).max().item()
    bad = {op: r for op, r in rels.items()
           if r > (0.0 if probes.OPS[op][2] else 1e-5)}
    if bad:
        fail(f"elementwise probe: {bad}")
    say("elementwise probe: " + ", ".join(
        f"{op} {'=' if r == 0.0 else format(r, '.1e')}"
        for op, r in rels.items())
        + " (= bit for bit, else the error over max(1, |reference|)); "
        f"launches { {k: v for k, v in counts.items() if v} }")
    return counts


def phase_iir_probe(b: int) -> dict:
    """The serial recursion inside one kernel against the same recursion
    driven from the host, a subframe (60 samples) and a block's worth
    (960) at b rows: what a launch-per-step form costs a sample."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp import probes
    rng = np.random.default_rng(37)
    a, x = iir_inputs(b, 960, rng)
    ck.reset_launches()
    y, m = probes.iir_recursion(a, x)
    sync()
    counts = dict(ck.launches)
    need_launched("recursion probe", counts, ("iir_recursion",))
    y_p, m_p = probes.iir_recursion_plain(a, x)
    if not (torch.equal(y, y_p) and torch.equal(m, m_p)):
        fail(f"recursion probe B={b}: {(y != y_p).sum().item()} of "
             f"{y.numel()} samples differ from the host-driven recursion")
    for n in (60, 960):
        xn = x[:n].contiguous()
        t_k = event_ms(lambda: probes.iir_recursion(a, xn), 5)
        t_p = event_ms(lambda: probes.iir_recursion_plain(a, xn), 2)
        say(f"recursion probe B={b}, {n} samples: in one kernel "
            f"{t_k:.4f} ms ({1e3 * t_k / n:.3f} us a sample), driven from "
            f"the host {t_p:.3f} ms ({1e3 * t_p / n:.1f} us a sample), "
            f"equal outputs")
    say(f"recursion probe: launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def phase_chain(fs: float, c: int, n_blocks: int, seed: int,
                kern: dict, nfft: int | None = None) -> dict:
    """bench.py chain_e2e_fused: FusedRx.step + sparse_hits over
    n_blocks on one resident noise block; fetch a value of the last."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp import framescan
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    bank = CarrierBankDemod(fs=fs, freqs_hz=grid(c), frontend="fft",
                            nfft=nfft)
    fused = FusedRx(bank, DEV)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (2, bank.block_len)).astype(np.float32)).to(DEV)

    def chain(state, n):
        total = None
        for _ in range(n):
            out, state = fused.step(x, state)
            keys, counts = framescan.sparse_hits(out["corr"],
                                                 out["crc_err"])
            total = counts.sum()
        return state, int(total.item())

    state, _ = chain(fused.init_state(), 2)          # warm-up
    sync()
    before = dict(ck.launches)
    t0 = time.time()
    state, hits = chain(state, n_blocks)
    wall = (time.time() - t0) / n_blocks
    rose = {k: ck.launches[k] - before[k] for k in before
            if ck.launches[k] - before[k]}
    if DEV != "cpu" and rose != {k: n_blocks for k in FUSED_KERNELS}:
        fail(f"chain C={c}: kernel launches {rose} for {n_blocks} blocks")
    block_s = bank.block_len / fs
    kern_ms = sum(kern[k]["ms"] for k in FUSED_KERNELS)
    r = {"ms_per_block": wall * 1e3, "rt_factor": block_s / wall,
         "block_ms": block_s * 1e3,
         "split_ms": {**{k: kern[k]["ms"] for k in FUSED_KERNELS},
                      "glue_sparse_launch": wall * 1e3 - kern_ms}}
    say(f"chain C={c}: {r['ms_per_block']:.3f} ms/block for "
        f"{r['block_ms']:.3f} ms of signal, rt_factor "
        f"{r['rt_factor']:.3f}; split {json.dumps(r['split_ms'])}; "
        f"last-block hit count {hits}")
    return r


def classic_chain(fs: float, c: int, nfft: int | None, seed: int):
    """(bank, chain(state, tail, n) -> (state, tail, hits), initial
    state, initial tail) of the classic chained step: block_step_scan +
    sparse_hits on one resident noise block."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import framescan
    from tetraear_tpu_torch.dsp.backhalf import TAILBITS, block_step_scan
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    bank = CarrierBankDemod(fs=fs, freqs_hz=grid(c), frontend="fft",
                            afc=True, nfft=nfft)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (bank.block_len, 2)).astype(np.float32)).to(DEV)

    def chain(state, tail, n):
        total = None
        for _ in range(n):
            scan, state, tail, _, _ = block_step_scan(bank, x, state, tail)
            keys, counts = framescan.sparse_hits(scan["corr"],
                                                 scan["crc_err"])
            total = counts.sum()
        return state, tail, int(total.item())

    tail = torch.zeros((c, TAILBITS), dtype=torch.uint8, device=DEV)
    return bank, chain, bank.init_state(DEV), tail


def phase_chain_classic(name: str, fs: float, c: int, n_blocks: int,
                        seed: int, nfft: int | None = None) -> dict:
    """ms/block and realtime factor of the classic chained step."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    bank, chain, state, tail = classic_chain(fs, c, nfft, seed)
    state, tail, _ = chain(state, tail, 2)            # warm-up
    sync()
    before = dict(ck.launches)
    t0 = time.time()
    state, tail, hits = chain(state, tail, n_blocks)
    wall = (time.time() - t0) / n_blocks
    rose = {k: ck.launches[k] - before[k] for k in before
            if ck.launches[k] - before[k]}
    if DEV != "cpu" and rose != {"band_synth_y": n_blocks,
                                 "frame_scan_even": n_blocks}:
        fail(f"chain classic {name}: kernel launches {rose} for "
             f"{n_blocks} blocks")
    block_s = bank.block_len / fs
    r = {"ms_per_block": wall * 1e3, "rt_factor": block_s / wall,
         "block_ms": block_s * 1e3,
         "kernel_launches_per_block": {k: v // n_blocks
                                       for k, v in rose.items()}}
    say(f"chain classic {name} C={c}: {r['ms_per_block']:.3f} ms/block "
        f"for {r['block_ms']:.3f} ms of signal, rt_factor "
        f"{r['rt_factor']:.3f}; kernel launches per block "
        f"{r['kernel_launches_per_block']}; last-block hit count {hits}")
    return r


# device kernels of a profile by what they do (first match wins)
# ---------------------------------------------------------------------------
# voice: the speech channel decoder (viterbi_decode) and the voice paths
# ---------------------------------------------------------------------------

# integer instructions the speech channel decoder needs a voice block: a
# trellis step takes the eight distinct branch sums of its three received
# values (two additions each) and, for each of the 16 states, two
# additions, a compare, a select and a decision bit; the traceback a
# shift, a mask and a multiply-add a step; then the class-0 signs and
# the CRC over 68 bits a check
V1_OPS_PER_BLOCK = 184 * (8 * 2 + 16 * 5) + 184 * 3 + 102 + 8 * 68.0
# one and ten voice slots a carrier a block at C = 1024 / 10240
V1_SIZES = (8192, 81920)


def viterbi_inputs(b: int, seed: int):
    """(b, 432) int32 soft blocks: speech parameters channel-coded by the
    C++ encoder (+-127) under Gaussian noise of sigma 40, every fourth
    row pure noise, every sixteenth small noise in [-2, 2] (many equal
    path metrics), the last row zeros."""
    import ctypes
    import numpy as np
    from tetraear_tpu_torch import native
    codec = native.codec()
    rng = np.random.default_rng(seed)
    ptr = ctypes.POINTER(ctypes.c_int16)
    base = np.zeros((min(b, 512), 432), np.int32)
    for i in range(len(base)):
        params = np.zeros((2, 138), np.int16)
        params[:, 1:] = rng.integers(0, 2, (2, 137))
        block = np.zeros(690, np.int16)
        codec._LIB.tetra_channel_encode(params.ctypes.data_as(ptr),
                                        block.ctypes.data_as(ptr))
        base[i] = codec.block_soft_bits(block.tobytes())
    soft = np.resize(base, (b, 432)).astype(np.float32)
    soft += 40.0 * rng.standard_normal((b, 432), dtype=np.float32)
    soft = np.clip(np.round(soft), -127, 127).astype(np.int32)
    soft[::4] = rng.integers(-127, 128, soft[::4].shape)
    soft[::16] = rng.integers(-2, 3, soft[::16].shape)
    soft[-1] = 0
    return soft


def cpp_channel_decode(soft) -> tuple:
    """The port's C++ decoder (tetra_channel_decode) on each row:
    ((B, 2, 137) frames, (B,) bfi)."""
    import numpy as np
    from tetraear_tpu_torch import native
    codec = native.codec()
    vp = codec.VoiceProcessor()
    frames, bfi = [], []
    for row in soft:
        block = np.zeros(690, np.int16)
        block[0] = codec.CODEC_HEADER
        pos = 0
        for lo, hi in ((1, 115), (116, 230), (231, 345), (346, 436)):
            block[lo:hi] = row[pos:pos + hi - lo]
            pos += hi - lo
        out = vp.channel_decode(block.tobytes())
        frames.append(out[:, 1:].astype(np.uint8))
        bfi.append(bool(out[0, 0]))
    return np.stack(frames), np.array(bfi)


def check_viterbi(soft_t, what: str, ordered=None, bfi=None) -> None:
    """The kernel's (or the recorded) outputs on ``soft_t`` bit-equal to
    the plain version's on the same card."""
    import torch
    from tetraear_tpu_torch.voice import viterbi
    if ordered is None:
        ordered, bfi = viterbi.decode(soft_t)
    o_p, b_p = viterbi.decode_plain(soft_t)
    if not (torch.equal(ordered, o_p) and torch.equal(bfi, b_p)):
        fail(f"viterbi_decode {what}: {(ordered != o_p).sum().item()} "
             f"ordered bits and {(bfi != b_p).sum().item()} BFI flags "
             f"differ from the plain version")


def viterbi_launch(soft, ordered, bfi, what: str):
    """This checkout's viterbi_decode launch alone (the C entry through
    ctypes, table uploaded and outputs allocated before)."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.voice import viterbi
    if DEV == "cpu":                 # the rehearsal: nothing is built
        return lambda: None
    fn = ck.build().tt_viterbi
    args = (*viterbi.kernel_args(soft, ordered, bfi), ck._stream(soft.device))

    def launch():
        if fn(*args):
            fail(f"{what}: the launch failed")
    return launch


_PARENT_V1_TABLES = None


def parent_viterbi(soft, what: str) -> tuple:
    """The earlier viterbi.cu on ``soft``: (ordered, bfi as bool, its launch
    alone, its call as its wrapper made it: torch.empty twice, the launch
    with the three table copies from host memory, bfi.bool())."""
    global _PARENT_V1_TABLES
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.voice import viterbi
    if _PARENT_V1_TABLES is None:
        _PARENT_V1_TABLES = (viterbi._K_POS.astype(np.int16).reshape(-1),
                             viterbi._SIGNS.astype(np.int8).reshape(-1),
                             np.ascontiguousarray(viterbi._K_CRC.reshape(-1)))
    pos, sign, crc = _PARENT_V1_TABLES
    lib = PARENT["viterbi.cu"]
    b = soft.shape[0]
    stream = ck._stream(soft.device)

    def run(o, f):
        if lib.tt_viterbi(ck._ptr(soft), ck._ptr(o), ck._ptr(f), b,
                          pos.ctypes.data, sign.ctypes.data, crc.ctypes.data,
                          stream):
            fail(f"{what}: the earlier kernel's launch failed")

    def call():
        ck._check(soft, "soft", (b, 432), torch.int32)
        o = torch.empty((b, 286), dtype=torch.uint8, device=soft.device)
        f = torch.empty((b,), dtype=torch.uint8, device=soft.device)
        run(o, f)
        return o, f.bool()
    o = torch.empty((b, 286), dtype=torch.uint8, device=soft.device)
    f = torch.empty((b,), dtype=torch.uint8, device=soft.device)
    run(o, f)
    return o, f.bool(), lambda: run(o, f), call


def viterbi_times(t, ordered, bfi, what: str, reps: int,
                  plain_reps: int = 1) -> dict:
    """viterbi_decode on ``t`` (its outputs ``ordered``, ``bfi`` already
    checked): the call (under no synchronisation once), the launch alone,
    the plain version and the bound; with --parent the earlier kernel's
    outputs equal and its launch in turns with this one, and its call."""
    import torch
    from tetraear_tpu_torch.voice import viterbi
    b = t.shape[0]
    no_sync(what, lambda: viterbi.decode(t))
    launch = viterbi_launch(t, ordered.clone(), bfi.clone(), what)
    r = {"blocks": b, "max_abs_err": 0.0, "tol": 0.0,
         "ms": event_ms(lambda: viterbi.decode(t), reps),
         "launch_ms": event_ms(launch, max(reps, 50), queued=True),
         "plain_ms": event_ms(lambda: viterbi.decode_plain(t), plain_reps),
         "library_ms": None,
         **bound(nbytes(t, ordered, bfi), 0.0,
                 issue=V1_OPS_PER_BLOCK * b)}
    if "viterbi.cu" in PARENT and DEV != "cpu":
        o, f, p_launch, p_call = parent_viterbi(t, what)
        if not (torch.equal(o, ordered) and torch.equal(f, bfi)):
            fail(f"{what}: the earlier kernel differs")
        r.update(turns(p_launch, launch, max(reps, 50)),
                 parent_call_ms=event_ms(p_call, reps))
    return r


def v1_turns_text(r: dict) -> str:
    return (f"; earlier launch {r['parent_ms'][0]:.4f}, "
            f"{r['parent_ms'][1]:.4f} (this {r['this_ms'][0]:.4f}, "
            f"{r['this_ms'][1]:.4f}) in turns, its call "
            f"{r['parent_call_ms']:.4f}" if "parent_ms" in r else "")


def phase_viterbi(seed: int, reps: int) -> dict:
    """viterbi_decode against its plain version at B = 8192 and 81920
    (bit-equal), the first 256 blocks also against the C++ decoder;
    call, launch alone, plain and bound times (with --parent the earlier
    kernel's in turns).  Returns {B: result}."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.voice import viterbi
    res = {}
    for b in V1_SIZES:
        b = 40 if REHEARSE else b
        soft = viterbi_inputs(b, seed)
        t = torch.from_numpy(soft).to(DEV)
        ordered, bfi = viterbi.decode(t)
        check_viterbi(t, f"B={b}", ordered, bfi)
        sub = min(b, 256)
        frames, cbfi = cpp_channel_decode(soft[:sub])
        if not (np.array_equal(viterbi._unbuild(
                ordered[:sub].cpu().numpy()), frames)
                and np.array_equal(bfi[:sub].cpu().numpy(), cbfi)):
            fail(f"viterbi_decode B={b}: differs from the C++ decoder on "
                 f"the first {sub} blocks")
        r = viterbi_times(t, ordered, bfi, f"viterbi_decode B={b}", reps)
        r["bad_frames"] = int(bfi.sum().item())
        res[b] = r
        say(f"kernel viterbi_decode B={b}: ordered bits and BFI bit-equal "
            f"to the plain version, the first {sub} blocks equal to the "
            f"C++ decoder ({r['bad_frames']} bad frames), no "
            f"synchronisation; call {r['ms']:.4f} ms, launch alone "
            f"{r['launch_ms']:.4f}, plain {r['plain_ms']:.4f} ms, library "
            f"call none, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes, {r['ops']:.3e} integer instructions at "
            f"{ISSUE_PER_CLK_SM:.0f} a clock an SM){v1_turns_text(r)}")
        del t, ordered, bfi
    sync()
    return res


def viterbi_floor(seed: int, reps: int) -> dict:
    """viterbi_decode's latency floor: the launch alone at B = 1 (one
    half-warp's chain) and B = 2 (one warp's pair), bit-equal to the
    plain version; with --parent the earlier kernel's in turns.  Returns
    {B: result}."""
    import torch
    from tetraear_tpu_torch.voice import viterbi
    floor = {}
    for b in (1, 2):
        t = torch.from_numpy(viterbi_inputs(b, seed)).to(DEV)
        ordered, bfi = viterbi.decode(t)
        check_viterbi(t, f"B={b}", ordered, bfi)
        floor[b] = viterbi_times(t, ordered, bfi,
                                 f"viterbi_decode floor B={b}", reps)
        say(f"kernel viterbi_decode floor B={b}: bit-equal; launch alone "
            f"{floor[b]['launch_ms']:.5f} ms, call {floor[b]['ms']:.4f}"
            f"{v1_turns_text(floor[b])}")
    sync()
    return floor


# batch sizes of the corner launches: one block, one warp, odd B, the
# CTA sizes' edges (cta_warps at 132 SMs)
V1_CORNERS = (1, 2, 3, 17, 171, 528, 529, 1057)


def check_viterbi_corners(seed: int) -> int:
    """viterbi_decode at the corner batch sizes (V1_CORNERS) bit-equal to
    its plain version; returns the number of launches checked."""
    import torch
    for b in V1_CORNERS:
        t = torch.from_numpy(viterbi_inputs(b, seed + b)).to(DEV)
        check_viterbi(t, f"corner B={b}")
    sync()
    say(f"kernel viterbi_decode corners: B in {V1_CORNERS} bit-equal to the "
        f"plain version")
    return len(V1_CORNERS)


def phase_viterbi_path(calls: list, reps: int) -> list:
    """viterbi_decode on the input of each launch a voice stream made
    (record_viterbi_calls; its outputs already held against the plain
    version): the call, the launch alone, the plain version, the bound;
    with --parent the earlier kernel in turns.  Returns one result a
    launch."""
    if not calls:
        fail("viterbi path: the voice stream made no launch")
    res = []
    for soft, ordered, bfi in calls:
        what = f"viterbi_decode voice fleet launch B={len(soft)}"
        check_viterbi(soft, what, ordered, bfi)
        r = viterbi_times(soft, ordered, bfi, what, reps)
        res.append(r)
        say(f"kernel {what}: bit-equal, no synchronisation; call "
            f"{r['ms']:.4f} ms, launch alone {r['launch_ms']:.4f}, plain "
            f"{r['plain_ms']:.4f} ms, library call none, bound "
            f"{r['bound_ms']:.6f} ms by {r['bound_by']}{v1_turns_text(r)}")
    sync()
    return res


def viterbi_entry(vit: dict, floor: dict, path: list,
                  voice_fleet: dict) -> dict:
    """The kernels line's viterbi_decode entry: the largest launch of the
    voice fleet (the main path's shape) as its numbers; every launch of
    the path, the floor (B = 1, 2) and B = 8192 / 81920 beside them."""
    src, replaces = KERNELS["viterbi_decode"]
    r = max(path, key=lambda p: p["blocks"])
    keys = ("ms", "launch_ms", "plain_ms", "bound_ms", "bound_by", "bytes",
            "ops")
    return {"name": "viterbi_decode", "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": voice_fleet["launches"]["viterbi_decode"],
            "max_abs_err": 0.0, "ms": r["ms"], "launch_ms": r["launch_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "floor_ms": floor[1]["launch_ms"],
            "floor_ms_b2": floor[2]["launch_ms"],
            "bound_bytes": r["bytes"], "bound_ops": r["ops"],
            "shape": f"B={r['blocks']} voice blocks of 432 soft bits (the "
                     f"largest launch of the voice fleet)",
            "path_launches": [{k: p[k] for k in ("blocks", *keys)}
                              for p in path],
            **{f"b{b}": {k: v[k] for k in keys} for b, v in vit.items()},
            "path_batches": voice_fleet["result"]["viterbi_batches"]}


def record_viterbi_calls(calls: list):
    """Wrap voice.viterbi.decode so that each launch's input and outputs
    land in ``calls`` (copies on the card); returns the undo."""
    from tetraear_tpu_torch.voice import viterbi
    orig = viterbi.decode

    def recording(soft):
        ordered, bfi = orig(soft)
        calls.append((soft.clone(), ordered.clone(), bfi.clone()))
        return ordered, bfi

    viterbi.decode = recording

    def undo():
        viterbi.decode = orig
    return undo


# V2: slots x frames of the two sizes (F = 4 frames a call, two calls
# that carry the state); 2048 is the fleet size of the reference's voice
# bench (BENCH_MODE=voice)
V2_SIZES = (256, 2048)
V2_FRAMES = 4
V2_CORNERS = ((255, (31, 30, 0)), (196, (30, 15, 31)), (197, (0, 30, 1)),
              (0, (15, 31, 30)), (255, (30, 0, 31)))


def speech_inputs(s: int, n: int, seed: int) -> tuple:
    """(s, n, 138) int32 frames and (s, n) bool valid: random bits with
    about one BFI in 8, every 16th slot a pitch-lag corner stream (t0 =
    143 with frac = +1, the index 196 / 197 boundary, t0 = 19 with frac
    = +1, and t0 = 144 followed by BFI frames that keep it), every 16th
    from slot 8 the largest gains (speech_state gives those slots
    saturating states), every 8th a first frame and a run of BFI, every
    32nd all BFI, and 5% holes in valid."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.voice import acelp_tables as T
    from tetraear_tpu_torch.voice import speech
    rng = np.random.default_rng(seed)
    fr = rng.integers(0, 2, (s, n, 138)).astype(np.int32)
    fr[:, :, 0] = rng.random((s, n)) < 0.125
    g_max = int(np.argmax(np.asarray(T.T_QUA_ENER).reshape(-1, 2)[:, 1]))
    for k, r in enumerate(range(0, s, 16)):
        p1, deltas = V2_CORNERS[k % len(V2_CORNERS)]
        prm = np.zeros((n, 24), np.int64)
        prm[:, 1:] = [rng.integers(0, 1 << int(nb)) for nb in T.BITNO]
        prm[:, 4] = p1
        prm[:, 9], prm[:, 14], prm[:, 19] = deltas
        prm[1::2, 0] = p1 == 255 and deltas[2] == 31
        fr[r] = speech.prm2bits(prm)
    for k, r in enumerate(range(8, s, 16)):
        prm = speech.bits2prm(torch.from_numpy(fr[r])).numpy()
        prm[:, [8, 13, 18, 23]] = g_max
        prm[:, 4] = (0, 123, 121)[k % 3]
        fr[r] = speech.prm2bits(prm)
    fr[3::8, 0, 0] = 1
    fr[3::8, 1:4, 0] = 1
    fr[5::32, :, 0] = 1
    valid = rng.random((s, n)) > 0.05
    return fr, valid


def speech_state(s: int):
    """Fresh decoders on the card, with a saturation corner every 16th
    slot from slot 8, in turn: the excitation history at +-32767 (the
    interpolation's sums leave int32), clustered LSPs (an LPC with large
    coefficients: the filters' sums leave int32), the synthesis memory at
    +-32767; the predicted energies at their caps."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.voice import speech
    st = [x.numpy() for x in speech.init_state(s, "cpu")]

    def alt(n):
        return np.where(np.arange(n) % 2 == 0, 32767, -32768)
    for k, r in enumerate(range(8, s, 16)):
        if k % 3 != 2:
            st[0][r] = alt(speech.EXC_LEN)
        if k % 3 != 0:
            st[1][r] = st[2][r] = 0x2000 + 8 * np.arange(10)[::-1]
        if k % 3 != 1:
            st[3][r] = alt(10)
        st[6][r], st[7][r] = 0x1B00, 0x1900
    return speech.SpeechState(*(torch.from_numpy(x).to(DEV) for x in st))


def cpp_speech(frames, valid, threads: int = 1, state=None) -> tuple:
    """Each slot's valid frames through its own C++ decoder
    (tetra_speech_decode_many), fresh or set to the slot's row of
    ``state`` (SpeechState), on one thread or on ``threads`` threads that
    take every threads-th slot each: ((s, n, 240) int32 PCM with zeros
    where not valid, wall seconds)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from tetraear_tpu_torch import native
    lib = native.codec()._LIB
    ptr = ctypes.POINTER(ctypes.c_int16)
    out = np.zeros(frames.shape[:2] + (240,), np.int32)
    inputs = [np.ascontiguousarray(frames[i][valid[i]].astype(np.int16))
              for i in range(len(frames))]
    rows = None if state is None else np.concatenate(
        [x.cpu().numpy().reshape(len(frames), -1) for x in state],
        axis=1).astype(np.int16)

    def one(i):
        fr = inputs[i]
        pcm = np.zeros((len(fr), 240), np.int16)
        dec = lib.tetra_speech_decoder_new()
        try:
            if rows is not None:
                row = np.ascontiguousarray(rows[i])
                lib.tetra_speech_decoder_set_state(
                    dec, row.ctypes.data_as(ptr))
            if len(fr) and lib.tetra_speech_decode_many(
                    dec, fr.ctypes.data_as(ptr), len(fr),
                    pcm.ctypes.data_as(ptr)):
                raise RuntimeError(f"C++ decoder failed on slot {i}")
        finally:
            lib.tetra_speech_decoder_free(dec)
        return pcm

    def share(k):
        return [one(i) for i in range(k, len(frames), threads)]

    t0 = time.perf_counter()
    if threads > 1:
        with ThreadPoolExecutor(threads) as pool:
            parts = list(pool.map(share, range(threads)))
        pcms = [parts[i % threads][i // threads] for i in range(len(frames))]
    else:
        pcms = [one(i) for i in range(len(frames))]
    wall = time.perf_counter() - t0
    for i, pcm in enumerate(pcms):
        out[i][valid[i]] = pcm
    return out, wall


def check_speech(what: str, st, fr, valid) -> tuple:
    """The kernel's state and PCM for one call equal the plain version's
    on the same card; returns (new state, PCM)."""
    import torch
    from tetraear_tpu_torch.voice import speech
    new, pcm = speech.decode_block(st, fr, valid)
    new_p, pcm_p = speech.decode_block_plain(st, fr, valid)
    bad = [n for n, a, b in zip(speech.SpeechState._fields, new, new_p)
           if not torch.equal(a, b)]
    if bad or not torch.equal(pcm, pcm_p):
        fail(f"acelp_decode {what}: {(pcm != pcm_p).sum().item()} PCM "
             f"samples and the state leaves {bad} differ from the plain "
             f"version")
    return new, pcm


def record_speech_calls(calls: list):
    """Wrap voice.speech.decode_block so that each launch the pool makes
    lands in ``calls`` as (state before, frames, valid, rows, new state,
    PCM, (start, end) CUDA events around the call or None); returns the
    undo.  The wrapper changes no state it is given, so the tensors are
    kept as they are."""
    import torch
    from tetraear_tpu_torch.voice import speech
    orig = speech.decode_block

    def recording(state, frames, valid, rows=None):
        ev = None
        if DEV == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        new, pcm = orig(state, frames, valid, rows)
        if ev is not None:
            ev[1].record()
        calls.append((state, frames, valid, rows, new, pcm, ev))
        return new, pcm

    speech.decode_block = recording

    def undo():
        speech.decode_block = orig
    return undo


def reset_before(calls: list, i: int) -> int:
    """How many slots the pool reset (evicted) between launch i - 1 and
    launch i: the rows whose state launch i got differs from what launch
    i - 1 left."""
    import torch
    if i == 0:
        return 0
    prev, before = calls[i - 1][4], calls[i][0]
    differ = torch.zeros(len(before.old_t0), dtype=torch.bool,
                         device=before.old_t0.device)
    for a, b in zip(prev, before):
        differ |= (a != b).reshape(len(differ), -1).any(dim=1)
    return int(differ.sum())


def check_pool_launch(what: str, call) -> float:
    """One acelp_decode launch of the pool against the plain version on
    the same inputs: the PCM and every state leaf of the launch's rows,
    and every other row of the bank unchanged.  Returns the plain
    version's ms."""
    import torch
    from tetraear_tpu_torch.voice import speech
    before, frames, valid, rows, new, pcm = call[:6]
    idx = rows.to(before.old_t0.device).long()
    sub0 = speech.SpeechState(*(x[idx] for x in before))
    sync()
    t0 = time.perf_counter()
    sub, pcm_p = speech.decode_block_plain(sub0, frames, valid)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rest = torch.ones(len(before.old_t0), dtype=torch.bool,
                      device=idx.device)
    rest[idx] = False
    bad = [n for n, a, b, p in zip(speech.SpeechState._fields, new, before,
                                   sub)
           if not torch.equal(a[idx], p) or not torch.equal(a[rest],
                                                            b[rest])]
    if bad or not torch.equal(pcm, pcm_p):
        fail(f"acelp_decode {what} (A={len(idx)} of {len(rest)} slots, "
             f"F={frames.shape[1]}): {(pcm != pcm_p).sum().item()} PCM "
             f"samples and the state leaves {bad} differ from the plain "
             f"version on the launch's rows or changed other rows")
    return plain_ms


# the kernel alone at more slot counts: one slot, a warp, a warp on each
# SM, four warps on each SM
V2_SWEEP = (1, 32, 132 * 32, 132 * 128)


# ---------------------------------------------------------------------------
# the ETSI basic operations the speech decoder needs for given frames
# ---------------------------------------------------------------------------
#
# A counting build of the port's C++ codec (voice/csrc) adds one for each
# basic operator the decoder calls; an operator called inside another
# counts with it.  The sources stay as they are: build_opcount copies them
# into build/opcount/, puts a counter at the head of every basic operator
# of the copy's etsi_dsp.h (ETSI_OP) and compiles the copy with g++ into
# libtetracodec_count.so.  frame_ops runs it over a bank's frames, each
# slot from its own state, and returns every frame's count: the work the
# frames need whatever implements it, from which acelp_decode's bound is
# taken (tests/test_torch_speechops.py holds the counts per frame).

VOICE_CSRC = ROOT / "tetraear_tpu_torch" / "voice" / "csrc"
OPCOUNT_LIB = ROOT / "build" / "opcount" / "libtetracodec_count.so"
_OPCOUNT_SOURCES = ("channel.cpp", "etsi_acelp_dec.cpp", "etsi_acelp_enc.cpp",
                    "etsi_speech_api.cpp")
# the basic operators of etsi_dsp.h (the helpers built on them, Load_sh
# and the rest, count through the operators they call)
ETSI_OPERATORS = ("add", "sub", "abs_s", "negate", "extract_h",
                  "extract_l", "L_mult", "L_mult0", "mult", "mult_r",
                  "L_add", "L_sub", "L_mac", "L_msu", "L_mac0", "L_msu0",
                  "L_negate", "L_deposit_h", "L_deposit_l", "L_abs", "shr",
                  "shl", "L_shr", "L_shl", "L_shr_r", "round_w", "norm_s",
                  "norm_l", "div_s")
_OPCOUNT_COUNTER = """
/* the counting build: etsi::ops counts the basic operators called
 * from outside any other one */
extern thread_local unsigned long long ops;
extern thread_local int op_depth;
struct OpScope {
  OpScope() { if (op_depth++ == 0) ops++; }
  ~OpScope() { op_depth--; }
};
#define ETSI_OP OpScope etsi_op_scope_
"""
_OPCOUNT_EXPORTS = """#include "etsi_dsp.h"
namespace etsi {
thread_local unsigned long long ops = 0;
thread_local int op_depth = 0;
}
extern "C" unsigned long long tetra_speech_ops(void) { return etsi::ops; }
extern "C" void tetra_speech_ops_reset(void) { etsi::ops = 0; }
"""


def counting_header(text: str) -> str:
    """etsi_dsp.h with the counter: ETSI_OP at the head of each operator
    of ETSI_OPERATORS (each defined once), the counter's declarations at the
    head of the namespace."""
    for name in ETSI_OPERATORS:
        pat = re.compile(r"(inline \w+ " + name + r"\([^)]*\) \{)")
        found = [m for m in pat.finditer(text)]
        if len(found) != 1:
            raise RuntimeError(f"etsi_dsp.h: {len(found)} definitions of "
                               f"{name}, one expected")
        text = pat.sub(r"\1 ETSI_OP;", text)
    head = "namespace etsi {\n"
    if text.count(head) != 1:
        raise RuntimeError("etsi_dsp.h: no single 'namespace etsi {'")
    return text.replace(head, head + _OPCOUNT_COUNTER)


def build_opcount() -> Path:
    """The counting library, built unless newer than every source of
    voice/csrc (under a file lock, as the port's native.build does)."""
    import fcntl
    import shutil
    import tempfile
    newest = max(p.stat().st_mtime for p in VOICE_CSRC.iterdir()
                 if p.is_file())
    if OPCOUNT_LIB.exists() and OPCOUNT_LIB.stat().st_mtime >= newest:
        return OPCOUNT_LIB
    OPCOUNT_LIB.parent.mkdir(parents=True, exist_ok=True)
    with open(OPCOUNT_LIB.parent / ".lock_count", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if OPCOUNT_LIB.exists() and OPCOUNT_LIB.stat().st_mtime >= newest:
            return OPCOUNT_LIB
        tmp = Path(tempfile.mkdtemp(prefix="count",
                                    dir=OPCOUNT_LIB.parent))
        try:
            for p in VOICE_CSRC.iterdir():
                if p.is_file():
                    shutil.copy(p, tmp / p.name)
            (tmp / "etsi_dsp.h").write_text(
                counting_header((VOICE_CSRC / "etsi_dsp.h").read_text()))
            (tmp / "etsi_opcount.cpp").write_text(_OPCOUNT_EXPORTS)
            out = tmp / OPCOUNT_LIB.name
            r = subprocess.run(
                ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o",
                 str(out), *(str(tmp / s) for s in _OPCOUNT_SOURCES),
                 str(tmp / "etsi_opcount.cpp")],
                capture_output=True, text=True, timeout=600)
            if r.returncode:
                raise RuntimeError(f"building {OPCOUNT_LIB.name} failed:\n"
                                   f"{r.stderr}")
            os.replace(out, OPCOUNT_LIB)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return OPCOUNT_LIB


_OPCOUNT_LIB = None


def _opcount_lib():
    import ctypes
    global _OPCOUNT_LIB
    if _OPCOUNT_LIB is None:
        lib = ctypes.CDLL(str(build_opcount()))
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.tetra_speech_decoder_new.restype = ctypes.c_void_p
        lib.tetra_speech_decoder_free.argtypes = [ctypes.c_void_p]
        lib.tetra_speech_decoder_set_state.argtypes = [ctypes.c_void_p,
                                                       i16p]
        lib.tetra_speech_decoder_state_size.restype = ctypes.c_int
        lib.tetra_speech_decode.argtypes = [ctypes.c_void_p, i16p, i16p]
        lib.tetra_speech_decode.restype = ctypes.c_int
        lib.tetra_speech_ops.restype = ctypes.c_ulonglong
        _OPCOUNT_LIB = lib
    return _OPCOUNT_LIB


def frame_ops(state, frames, valid):
    """(S, F) int64: the basic operations the decoder runs on each valid
    frame (0 where not valid), each slot's frames in order from its row
    of ``state`` (the eight SpeechState leaves, (S, ...) arrays or
    tensors).  frames: (S, F, 138) [BFI + 137 serial bits]; valid:
    (S, F) bool.  Post_Process (x2) counts with its frame."""
    import ctypes
    import numpy as np
    lib = _opcount_lib()
    i16p = ctypes.POINTER(ctypes.c_int16)
    rows = np.concatenate([np.asarray(x).reshape(len(x), -1)
                           for x in state], axis=1).astype(np.int16)
    if rows.shape[1] * 2 != lib.tetra_speech_decoder_state_size():
        raise ValueError(f"state: {rows.shape[1]} words a slot, the C++ "
                         f"decoder's state is "
                         f"{lib.tetra_speech_decoder_state_size() // 2}")
    frames = np.ascontiguousarray(np.asarray(frames), dtype=np.int16)
    valid = np.asarray(valid, bool)
    out = np.zeros(valid.shape, np.int64)
    pcm = np.zeros(240, np.int16)
    dec = lib.tetra_speech_decoder_new()
    try:
        for s in range(len(frames)):
            row = np.ascontiguousarray(rows[s])
            lib.tetra_speech_decoder_set_state(dec, row.ctypes.data_as(i16p))
            for f in np.nonzero(valid[s])[0]:
                lib.tetra_speech_ops_reset()
                if lib.tetra_speech_decode(dec,
                                           frames[s, f].ctypes.data_as(i16p),
                                           pcm.ctypes.data_as(i16p)):
                    raise RuntimeError(f"the counting decoder failed on "
                                       f"slot {s} frame {f}")
                out[s, f] = lib.tetra_speech_ops()
    finally:
        lib.tetra_speech_decoder_free(dec)
    return out


def v2_work(state, fr, valid) -> dict:
    """acelp_decode's bound and floor for one call: the ETSI basic
    operations the call's frames need (frame_ops, the counting build of
    the C++ decoder, each slot from its own state), each charged as one
    integer instruction at ISSUE_PER_CLK_SM a clock an SM, beside the
    bytes the call must move: each valid frame and every valid flag
    read, the PCM written, and for each slot with a valid frame its
    state read and written once, of old_exc the EXC_OFF history words
    read and EXC_OFF + L_FRAME written; and the critical-path floor, the
    busiest slot's valid subframes at synth_floor()'s SM clocks a
    subframe, measured in this run."""
    import numpy as np
    from tetraear_tpu_torch.voice import speech
    fr, valid = np.asarray(fr), np.asarray(valid)
    ops = frame_ops([x.cpu().numpy() for x in state], fr, valid)
    n_frames = int(valid.sum())
    busiest = int(valid.sum(axis=1).max()) if valid.size else 0
    s, n = valid.shape
    live = int(valid.any(axis=1).sum())
    words = sum(x[0].numel() for x in state[1:])
    io = 4 * (n_frames * fr.shape[2] + s * n * speech.L_FRAME
              + live * (2 * words + 2 * speech.EXC_OFF + speech.L_FRAME))
    io += valid.size
    r = bound(io, 0.0, issue=float(ops.sum()))
    floor = synth_floor()
    r.update(etsi_ops=int(ops.sum()),
             etsi_ops_per_frame=float(ops.sum()) / max(n_frames, 1),
             floor_ms=busiest * 4 * floor["cycles_per_subframe"]
             / SM_CLOCK_HZ * 1e3, floor_frames=busiest)
    return r


_SYNTH_FLOOR = {}


def synth_floor(reps: int = 5) -> dict:
    """The floor's yardstick, measured once a run: probes.synth_chain,
    acelp_decode's synthesis filter alone on one lane, over 64 subframes
    (16 frames) of LPC of a decoder's size and inputs whose reordered
    pass holds (the common case), held against its plain version; the
    least SM clocks a subframe of ``reps`` launches.  0 in the
    rehearsal (no clock on the plain route)."""
    if _SYNTH_FLOOR:
        return _SYNTH_FLOOR
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import probes
    rng = np.random.default_rng(17)
    n = probes.SYNTH_CHAIN_MAX
    a = rng.integers(-3000, 3001, (n, 11)).astype(np.int32)
    a[:, 0] = 4096
    x = rng.integers(-1000, 1001, (n, 60)).astype(np.int32)
    mem = rng.integers(-2000, 2001, 10).astype(np.int32)
    ta, tx, tm = (torch.from_numpy(v).to(DEV) for v in (a, x, mem))
    want = probes.synth_chain_plain(*(torch.from_numpy(v)
                                      for v in (a, x, mem)))
    cyc = []
    for _ in range(reps):
        y, m, c = probes.synth_chain(ta, tx, tm)
        if not (torch.equal(y.cpu(), want[0]) and
                torch.equal(m.cpu(), want[1])):
            fail("synth_chain: differs from the plain Syn_Filt")
        cyc.append(int(c.item()))
    _SYNTH_FLOOR.update(subframes=n, cycles=min(cyc),
                        cycles_per_subframe=min(cyc) / n,
                        cycles_per_sample=min(cyc) / (n * 60))
    say(f"probe synth_chain: equal to the plain Syn_Filt over {n} "
        f"subframes; {min(cyc)} SM clocks on one lane (least of {reps}), "
        f"{_SYNTH_FLOOR['cycles_per_subframe']:.0f} a subframe, "
        f"{_SYNTH_FLOOR['cycles_per_sample']:.1f} a sample")
    return _SYNTH_FLOOR


def acelp_kernel_ms(state, frames, valid, rows, reps: int) -> float:
    """acelp_decode's own time: tt_acelp launched as it is (no state
    copy, no checks) on a copy of the state, which the launches carry on,
    CUDA events over ``reps`` launches after one; the host clock over
    the wrapper's plain route in the rehearsal."""
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.voice import speech
    st = speech.SpeechState(*(x.clone() for x in state))
    if DEV == "cpu":
        return event_ms(lambda: speech.decode_block(st, frames, valid, rows),
                        1)
    lib = ck.build()
    dev = frames.device
    rows = (torch.arange(len(st.old_t0), dtype=torch.int32, device=dev)
            if rows is None else rows.to(dev))
    pcm = torch.empty(frames.shape[:2] + (speech.L_FRAME,),
                      dtype=torch.int32, device=dev)
    args = (ck._ptr(frames), ck._ptr(valid), ck._ptr(rows), len(rows),
            frames.shape[1], *(ck._ptr(x) for x in st), ck._ptr(pcm),
            speech._K_TAB.ctypes.data, ck._stream(dev))

    def launch():
        if lib.tt_acelp(*args):
            fail("acelp_decode: the launch failed")
    return event_ms(launch, reps)


def phase_speech(seed: int, reps: int) -> dict:
    """acelp_decode at S = 256 and 2048 slots x F = 4 frames: two calls
    that carry the state (saturation corners in speech_state's slots),
    each held against the plain version (PCM and every state leaf) and
    both against the C++ decoder on every slot; kernel, plain, host C++
    (one core, and a thread a core) and bound times of one call (the
    bound from the ETSI operations of the call's own frames), the
    critical-path floor (synth_floor's clocks), and one slot's call and
    launch.  Then the call and the launch alone over V2_SWEEP slots.
    Returns {S: result, "sweep_ms": ..., "sweep_kernel_ms": ...}."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.voice import speech
    res = {}
    threads = os.cpu_count() or 1
    for s in V2_SIZES:
        s = 16 * s // 256 if REHEARSE else s
        n = V2_FRAMES
        fr, valid = speech_inputs(s, 2 * n, seed + s)
        t_fr = torch.from_numpy(fr).to(DEV)
        t_v = torch.from_numpy(valid).to(DEV)
        st0 = speech_state(s)
        calls = [(t_fr[:, :n].contiguous(), t_v[:, :n].contiguous()),
                 (t_fr[:, n:].contiguous(), t_v[:, n:].contiguous())]
        st, pcms = st0, []
        for k, (f_k, v_k) in enumerate(calls):
            st, pcm = check_speech(f"S={s} call {k + 1}", st, f_k, v_k)
            pcms.append(pcm)
        got = torch.cat(pcms, dim=1).cpu().numpy()
        want, _ = cpp_speech(fr, valid, threads, st0)
        if not np.array_equal(got, want):
            bad = np.nonzero((got != want).any(axis=(1, 2)))[0]
            fail(f"acelp_decode S={s}: slots {bad[:8].tolist()} (of "
                 f"{len(bad)}) differ from the C++ decoder over two calls")
        f1, v1 = calls[0]
        _, one_core = cpp_speech(fr[:, :n], valid[:, :n], 1, st0)
        _, multi = cpp_speech(fr[:, :n], valid[:, :n], threads, st0)
        st1 = speech.init_state(1, DEV)
        v_one = torch.ones_like(v1[:1])
        r = {"max_abs_err": 0.0, "tol": 0.0, "slots": s, "frames": n,
             "decoded_frames": int(valid[:, :n].sum()),
             "bfi_frames": int((fr[:, :n, 0] != 0)[valid[:, :n]].sum()),
             "ms": event_ms(lambda: speech.decode_block(st0, f1, v1), reps),
             "kernel_ms": acelp_kernel_ms(st0, f1, v1, None, reps),
             "plain_ms": event_ms(
                 lambda: speech.decode_block_plain(st0, f1, v1), 1),
             "host_ms": one_core * 1e3, "host_threads": threads,
             "host_threads_ms": multi * 1e3,
             "latency_ms": event_ms(lambda: speech.decode_block(
                 st1, f1[:1].contiguous(), v_one), reps),
             "latency_kernel_ms": acelp_kernel_ms(
                 st1, f1[:1].contiguous(), v_one, None, reps),
             "library_ms": None,
             **v2_work(st0, fr[:, :n], valid[:, :n])}
        res[s] = r
        say(f"kernel acelp_decode S={s} F={n}: PCM and state bit-equal to "
            f"the plain version over two calls, every slot equal to the C++ "
            f"decoder, saturation corners included ({r['decoded_frames']} "
            f"frames a call, {r['bfi_frames']} BFI); {r['ms']:.4f} ms a call "
            f"({r['kernel_ms']:.4f} ms the launch alone), plain "
            f"{r['plain_ms']:.1f} ms, host C++ {r['host_ms']:.2f} ms on one "
            f"core and {r['host_threads_ms']:.2f} ms on {threads} threads, "
            f"library call none, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({r['etsi_ops']} ETSI basic operations, "
            f"{r['etsi_ops_per_frame']:.0f} a frame, as integer instructions "
            f"at {ISSUE_PER_CLK_SM:.0f} a clock an SM), critical-path floor "
            f"{r['floor_ms']:.4f} ms (the busiest slot's subframes at the "
            f"synth_chain probe's clocks), one slot {r['latency_ms']:.4f} ms "
            f"a call, {r['latency_kernel_ms']:.4f} ms the launch ({n} "
            f"frames)")
        del t_fr, t_v, st0, st, calls
    sweep, sweep_kernel = {}, {}
    for s in V2_SWEEP:
        s = min(s, 64) if REHEARSE else s
        fr, valid = speech_inputs(s, V2_FRAMES, seed + 1)
        t_fr = torch.from_numpy(fr).to(DEV)
        t_v = torch.ones(valid.shape, dtype=torch.bool, device=DEV)
        st0 = speech.init_state(s, DEV)
        sweep[s] = event_ms(lambda: speech.decode_block(st0, t_fr, t_v),
                            reps)
        sweep_kernel[s] = acelp_kernel_ms(st0, t_fr, t_v, None, reps)
    say(f"kernel acelp_decode, F={V2_FRAMES} every frame valid, a call "
        f"(the launch alone): "
        + ", ".join(f"S={s} {ms:.4f} ({sweep_kernel[s]:.4f}) ms"
                    for s, ms in sweep.items()))
    res["sweep_ms"] = sweep
    res["sweep_kernel_ms"] = sweep_kernel
    sync()
    return res


def live_launch(call, plain_ms: float, reps: int) -> dict:
    """The live launch shape: one recorded pool launch of the voice fleet
    (its rows of the bank, F frames a row) replayed on the kernel alone,
    beside the plain version's time on it (check_pool_launch), the host
    C++ codec's on the same frames from the same states (one core), the
    bound of its ETSI operations and the floor."""
    import torch
    from tetraear_tpu_torch.voice import speech
    before, frames, valid, rows = call[:4]
    idx = rows.to(before.old_t0.device).long()
    sub = speech.SpeechState(*(x[idx] for x in before))
    fr, v = frames.cpu().numpy(), valid.cpu().numpy()
    _, host = cpp_speech(fr, v, 1, sub)
    r = {"rows": int(len(idx)), "bank": int(len(before.old_t0)),
         "frames": int(frames.shape[1]), "decoded_frames": int(v.sum()),
         "ms": event_ms(lambda: speech.decode_block(before, frames, valid,
                                                    rows), reps),
         "kernel_ms": acelp_kernel_ms(before, frames, valid, rows, reps),
         "plain_ms": plain_ms, "host_ms": host * 1e3,
         **v2_work(sub, fr, v)}
    return r


def acelp_entry(sp: dict, voice_dev: dict) -> dict:
    """The kernels line's acelp_decode entry: S = 256 as its numbers,
    S = 2048 and the live launch beside them."""
    src, replaces = KERNELS["acelp_decode"]
    (s1, r1), (s2, r2) = sorted((s, r) for s, r in sp.items()
                                if isinstance(s, int))
    live = voice_dev["result"]["live_launch"]
    return {"name": "acelp_decode", "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": voice_dev["launches"]["acelp_decode"],
            "max_abs_err": 0.0, "ms": r1["ms"], "plain_ms": r1["plain_ms"],
            "bound_ms": r1["bound_ms"], "bound_by": r1["bound_by"],
            "library_ms": None, "bound_bytes": r1["bytes"],
            "bound_ops": r1["ops"], "etsi_ops": r1["etsi_ops"],
            "floor_ms": r1["floor_ms"],
            "shape": f"S={s1} slots x F={r1['frames']} frames",
            "host_ms": r1["host_ms"],
            "host_threads_ms": r1["host_threads_ms"],
            "latency_ms": r1["latency_ms"],
            "latency_kernel_ms": r1["latency_kernel_ms"],
            "floor_cycles_per_subframe":
                synth_floor()["cycles_per_subframe"],
            f"ms_s{s2}": r2["ms"], f"plain_ms_s{s2}": r2["plain_ms"],
            f"bound_ms_s{s2}": r2["bound_ms"],
            f"bound_by_s{s2}": r2["bound_by"],
            f"floor_ms_s{s2}": r2["floor_ms"],
            f"host_ms_s{s2}": r2["host_ms"],
            f"host_threads_ms_s{s2}": r2["host_threads_ms"],
            f"latency_ms_s{s2}": r2["latency_ms"],
            f"latency_kernel_ms_s{s2}": r2["latency_kernel_ms"],
            "kernel_ms": r1["kernel_ms"],
            f"kernel_ms_s{s2}": r2["kernel_ms"],
            "live": {k: live[k] for k in (
                "rows", "bank", "frames", "ms", "kernel_ms", "plain_ms",
                "host_ms",
                "bound_ms", "bound_by", "floor_ms", "etsi_ops")},
            "sweep_ms": sp["sweep_ms"],
            "sweep_kernel_ms": sp["sweep_kernel_ms"],
            "path_calls": voice_dev["result"]["pool_call_sizes"]}


class VoiceLog:
    """What a voice Pipeline synthesized, by carrier: the channel decoder
    output each voice candidate was synthesized from (the batched
    decoder's, or the host C++ decoder's where the frame took the host
    path), each PCM chunk with its frame's stream symbol, and the time
    spent in Pipeline._try_voice (host synthesis)."""

    def __init__(self):
        from tetraear_tpu_torch import native
        self.codec = native.codec()
        self.vp = self.codec.VoiceProcessor()      # stateless calls only
        self.params: dict = {}
        self.audio: dict = {}
        self.synth_s = 0.0
        self.pass_s = 0.0
        self.pool_items: list = []
        self.pool_fresh: list = []
        self.pool_calls: list = []
        self._last = None

    def attach(self, pipe) -> None:
        orig = pipe._try_voice
        orig_pass = pipe._synth_voice

        def hooked(frame):
            if pipe._is_voice_candidate(frame):
                p = self._params_of(frame)
                if p is not None:
                    self.params.setdefault(frame["carrier"], []).append(
                        (frame["stream_symbol"], p))
            t0 = time.perf_counter()
            orig(frame)
            self.synth_s += time.perf_counter() - t0

        def hooked_pass(frames):
            t0 = time.perf_counter()
            orig_pass(frames)
            self.pass_s += time.perf_counter() - t0

        pipe._try_voice = hooked
        pipe._synth_voice = hooked_pass
        pool = pipe._voice_device
        if pool is not None:
            # each item the pool synthesizes, and whether its carrier had
            # no slot (a fresh decoder) when it came
            orig_slot, orig_synth = pool._slot_for, pool.synthesize

            def slot_for(carrier, reset):
                self.pool_fresh.append(carrier not in pool._map)
                return orig_slot(carrier, reset)

            def synthesize(items):
                self.pool_items.extend(items)
                self.pool_calls.append(len(items))
                return orig_synth(items)

            pool._slot_for = slot_for
            pool.synthesize = synthesize

    def _params_of(self, frame):
        if "_voice_params" in frame:
            return frame["_voice_params"].copy()
        soft = frame.get("soft_symbols")
        if soft is None:
            return None
        if frame.get("stolen"):
            half = self.codec.stolen_soft_bits(soft)
            return (None if half is None
                    else self.vp.channel_decode_stolen(half))
        block = self.codec.build_codec_block(soft)
        return None if block is None else self.vp.channel_decode(block)

    def on_audio(self, audio) -> None:
        self._last = audio

    def on_frame(self, frame) -> None:
        if frame.get("has_voice"):
            self.audio.setdefault(frame["carrier"], []).append(
                (frame["stream_symbol"], self._last))
        self._last = None


def voice_carriers(c: int) -> dict:
    """carrier -> stolen_every of the voice fleet: 16 carriers spread
    over the band, two of them stealing every fourth slot (four carriers,
    one stealing, in the rehearsal's C=8)."""
    if c < 16:
        return {1: 0, 3: 4, 5: 0, 6: 0}
    voiced = [round(i * (c - 1) / 15) for i in range(16)]
    return {ci: (4 if i in (3, 10) else 0) for i, ci in enumerate(voiced)}


def voice_stream_run(setup: dict, split: bool, threads: int,
                     calls: list | None = None,
                     speech_calls: list | None = None, **extra) -> tuple:
    """process_block over the voice capture, unsplit or with a checkpoint
    after block 2 onto a fresh Pipeline, host synthesis unless ``extra``
    says device_voice=True; the viterbi_decode and acelp_decode launches
    land in ``calls`` and ``speech_calls`` where given.  Returns
    (VoiceLog, launches, process_block ms of each block, stats)."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    bl = setup["block_len"]
    blocks = [setup["iq"][i * bl:(i + 1) * bl]
              for i in range(len(setup["iq"]) // bl)]
    log = VoiceLog()
    cfg = dict(FUSED_CFG, voice=True, voice_threads=threads,
               device_voice=False)
    cfg.update(extra)
    path = ROOT / "build" / "chip_smoke_voice.npz"
    path.parent.mkdir(exist_ok=True)
    undos = ([record_viterbi_calls(calls)] if calls is not None else []) + (
        [record_speech_calls(speech_calls)] if speech_calls is not None
        else [])
    ms = []
    ck.reset_launches()
    pipe = stream_pipeline(setup, 0, log.on_frame, log.on_audio, **cfg)
    log.attach(pipe)
    try:
        for i, b in enumerate(blocks):
            if split and i == 2:
                pipe.save_checkpoint(path)
                pipe.close()
                pipe = stream_pipeline(setup, 0, log.on_frame,
                                       log.on_audio, **cfg)
                log.attach(pipe)
                pipe.load_checkpoint(path)
            t0 = time.perf_counter()
            pipe.process_block(b)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = dict(ck.launches)
        stats = pipe.stats
    finally:
        pipe.close()
        for undo in undos:
            undo()
    if split:
        path.unlink()
    return log, counts, ms, stats


def phase_voice_fleet(c: int, nfft: int | None, n_blocks: int,
                      seed: int) -> dict:
    """The fused path at fleet size with voice carriers, through
    process_block: every voice carrier's synthesized parameters equal the
    encoder's slot for slot, its PCM equals a fresh host decoder's on
    those parameters in order, the checkpoint-split run with two
    synthesis threads equals the unsplit sequential one, and every
    viterbi_decode launch of the run equals the plain version on its
    inputs."""
    import numpy as np
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.golden import VOICE_HEAD_SYMS, fleet_capture
    fs = FS_SMALL if REHEARSE else FS_FLEET
    offsets = grid(c)
    voice = voice_carriers(c)
    bl = CarrierBankDemod(fs=fs, freqs_hz=offsets, frontend="fft",
                          nfft=nfft).block_len
    t0 = time.time()
    iq, params = fleet_capture(fs, offsets, [], n_blocks * bl, seed=seed,
                               voice=voice)
    setup = {"fs": fs, "offsets": offsets, "iq": iq, "block_len": bl}
    made = time.time() - t0
    calls = []
    t0 = time.time()
    # host synthesis: the reference run of phase_voice_fleet_device
    log, counts, ms, stats = voice_stream_run(setup, False, 0, calls)
    wall = time.time() - t0
    log2, counts2, _, stats2 = voice_stream_run(setup, True, 2)
    need_launched("voice fleet", counts,
                  FUSED_KERNELS + ("viterbi_decode",))
    need_launched("voice fleet split", counts2, ("viterbi_decode",))
    for i, (soft, ordered, bfi) in enumerate(calls):
        check_viterbi(soft, f"voice fleet launch {i} (B={len(soft)})",
                      ordered, bfi)
    slots_in = int(n_blocks * bl / fs * 36_000 / 510)
    decoded = {}
    for ci, stolen in voice.items():
        got = log.params.get(ci, [])
        slots = [(sym - VOICE_HEAD_SYMS + 127) // 255 for sym, _ in got]
        bad = [s for s, (_, p) in zip(slots, got)
               if not 0 <= s < len(params[ci])
               or not np.array_equal(p, params[ci][s])]
        if bad or len(set(slots)) != len(slots):
            fail(f"voice fleet: carrier {ci}'s decoded parameters differ "
                 f"from the encoder's at slots {bad[:5]} (of {slots})")
        if len(got) < 2 * slots_in // 3:
            fail(f"voice fleet: carrier {ci} decoded {len(got)} of about "
                 f"{slots_in} slots")
        vp = log.codec.VoiceProcessor()
        want = [a for a in (vp.decode_params(p) for _, p in got) if len(a)]
        pcm = [a for _, a in log.audio.get(ci, [])]
        if len(pcm) != len(want) or not all(
                np.array_equal(a, b) for a, b in zip(pcm, want)):
            fail(f"voice fleet: carrier {ci}'s PCM ({len(pcm)} chunks) "
                 f"differs from a fresh host decoder on its parameters "
                 f"({len(want)} chunks)")
        pcm2 = log2.audio.get(ci, [])
        if [s for s, _ in pcm2] != [s for s, _ in log.audio[ci]] or not all(
                np.array_equal(a, b) for (_, a), (_, b)
                in zip(pcm2, log.audio[ci])):
            fail(f"voice fleet: carrier {ci}'s PCM from the checkpoint-"
                 f"split run with 2 synthesis threads differs from the "
                 f"unsplit sequential run")
        if stolen and not any(p[0, 0] for _, p in got):
            fail(f"voice fleet: carrier {ci} decoded no stolen slot")
        decoded[ci] = len(got)
    idle_cands = sum(len(v) for ci, v in log.params.items()
                     if ci not in voice)
    idle_voice = sum(len(v) for ci, v in log.audio.items()
                     if ci not in voice)
    sizes = [len(s) for s, _, _ in calls]
    steady = ms[1:] or ms
    r = {"carriers": c, "voice_carriers": len(voice),
         "stolen_carriers": sum(1 for v in voice.values() if v),
         "blocks": len(ms), "slots_per_carrier": slots_in,
         "decoded_slots": decoded, "voice_frames": stats.voice_frames,
         "stolen_frames": stats.stolen_frames,
         "voice_frames_split": stats2.voice_frames,
         "viterbi_batches": sizes, "idle_voice_candidates": idle_cands,
         "idle_voice_chunks": idle_voice,
         "process_block_ms": ms,
         "process_block_ms_steady": sum(steady) / len(steady),
         "host_synthesis_ms_per_block": log.synth_s * 1e3 / len(ms),
         "capture_s": made, "wall_s": wall}
    say(f"voice fleet C={c}: {len(voice)} voice carriers "
        f"({r['stolen_carriers']} stealing every 4th slot) over "
        f"{len(ms)} blocks: decoded slots {sorted(decoded.values())} of "
        f"about {slots_in}, every one equal to the encoder's parameters, "
        f"PCM equal to a fresh host decoder's, the split run with 2 "
        f"synthesis threads equal to the unsplit one; {stats.voice_frames} "
        f"voice frames ({stats.stolen_frames} stolen); viterbi_decode "
        f"launches of B={sizes}, each equal to the plain version; "
        f"{idle_cands} voice candidates on idle carriers "
        f"({idle_voice} synthesized to audio); process_block "
        f"{r['process_block_ms_steady']:.2f} ms/block after the first, "
        f"host synthesis {r['host_synthesis_ms_per_block']:.2f} ms/block; "
        f"launches { {k: v for k, v in counts.items() if v} }; capture "
        f"made in {made:.1f} s")
    return {"result": r, "launches": counts, "setup": setup, "log": log,
            "stats": stats, "calls": calls}


def same_voice(a, b) -> bool:
    """Two VoiceLogs' audio: the same carriers, frames (stream symbols)
    and PCM."""
    import numpy as np
    return sorted(a.audio) == sorted(b.audio) and all(
        [s for s, _ in a.audio[c]] == [s for s, _ in b.audio[c]]
        and all(np.array_equal(x, y) for (_, x), (_, y)
                in zip(a.audio[c], b.audio[c])) for c in a.audio)


def check_evictions(log) -> int:
    """Each carrier's audio in a device-voice run equals a host decoder's
    that restarts fresh whenever the pool gave the carrier a slot anew
    (its first use, or after its slot was evicted); returns the number of
    restarts after a first use."""
    import numpy as np
    decs, want, seen, restarts = {}, {}, set(), 0
    for (ci, params), fresh in zip(log.pool_items, log.pool_fresh):
        if fresh:
            decs[ci] = log.codec.VoiceProcessor()
            restarts += ci in seen
            seen.add(ci)
        slots = np.asarray(params).reshape(-1, 2, params.shape[-1])
        want.setdefault(ci, []).extend(
            a for a in decs[ci].decode_params_many(slots) if len(a))
    for ci in set(want) | set(log.audio):
        got = [a for _, a in log.audio.get(ci, [])]
        exp = want.get(ci, [])
        if len(got) != len(exp) or not all(
                np.array_equal(x, y) for x, y in zip(got, exp)):
            fail(f"voice fleet device: carrier {ci}'s PCM ({len(got)} "
                 f"chunks) differs from a host decoder restarted at each "
                 f"new slot ({len(exp)} chunks)")
    return restarts


def voice_diff(a, b) -> int:
    """The audio chunks (carrier, stream symbol) two VoiceLogs do not
    share: in one only, or with other PCM."""
    import numpy as np
    ka = {(c, sym): x for c, v in a.audio.items() for sym, x in v}
    kb = {(c, sym): x for c, v in b.audio.items() for sym, x in v}
    return len(ka.keys() ^ kb.keys()) + sum(
        not np.array_equal(ka[k], kb[k]) for k in ka.keys() & kb.keys())


def phase_voice_fleet_device(fleet: dict) -> dict:
    """The voice fleet with speech synthesis on the card
    (device_voice=True).  With a decoder slot for every carrier (idle
    carriers' noise gives voice candidates on hundreds of carriers, and
    an evicted carrier restarts from a fresh decoder where the host keeps
    its state): unsplit and split by a checkpoint after block 2 onto a
    fresh Pipeline, each equal to the host-synthesis run of
    phase_voice_fleet (audio by carrier and frame, has_voice, voice and
    stolen frame counts), every acelp_decode launch of the unsplit run
    equal to the plain version on its inputs.  With the default slots
    (what a user on the card gets) and with 8 slots, where each
    carrier's PCM equals a host decoder's restarted whenever the pool
    gave it a slot anew, and launches after evictions are held against
    the plain version too."""
    from tetraear_tpu_torch.api import PipelineConfig
    setup, host, h_stats = fleet["setup"], fleet["log"], fleet["stats"]
    every = dict(device_voice=True,
                 device_voice_slots=len(setup["offsets"]))
    sp_calls = []
    log, counts, ms, stats = voice_stream_run(setup, False, 0,
                                              speech_calls=sp_calls, **every)
    log2, counts2, ms2, stats2 = voice_stream_run(setup, True, 0, **every)
    need_launched("voice fleet device", counts,
                  FUSED_KERNELS + ("viterbi_decode", "acelp_decode"))
    need_launched("voice fleet device split", counts2, ("acelp_decode",))
    if not REHEARSE and counts["acelp_decode"] < len(ms):
        fail(f"voice fleet device: acelp_decode launched "
             f"{counts['acelp_decode']} times in {len(ms)} voice blocks")
    plain = [check_pool_launch(f"voice fleet device launch {i}", call)
             for i, call in enumerate(sp_calls)]
    # the synthesis pass split: the acelp_decode calls' device time
    # (CUDA events around each, the state copy and table upload
    # included) and the rest, host work (packing, copies, the PCM fetch)
    sync()
    kernel_ms = sum(c[6][0].elapsed_time(c[6][1]) for c in sp_calls
                    if c[6] is not None)
    big = max(range(len(sp_calls)), key=lambda i: len(sp_calls[i][3]))
    live = live_launch(sp_calls[big], plain[big], reps=5)
    # the split run's stats count the blocks after the restore only: its
    # audio by frame (has_voice) is what is compared
    if (stats.voice_frames, stats.stolen_frames) != (
            h_stats.voice_frames, h_stats.stolen_frames):
        fail(f"voice fleet device: {stats.voice_frames} voice / "
             f"{stats.stolen_frames} stolen frames, host synthesis "
             f"{h_stats.voice_frames} / {h_stats.stolen_frames}")
    for name, lg in (("unsplit", log), ("split", log2)):
        if not same_voice(lg, host):
            fail(f"voice fleet device ({name}): the audio by carrier and "
                 f"frame differs from host synthesis")
    if check_evictions(log):
        fail("voice fleet device: a carrier was evicted with a slot for "
             "every carrier")
    speakers = len({ci for ci, _ in log.pool_items})
    n_checked = len(sp_calls)
    r = {"blocks": len(ms), "process_block_ms": ms,
         "process_block_ms_split": ms2,
         "synthesis_pass_ms_per_block": log.pass_s * 1e3 / len(ms),
         "synthesis_kernel_ms_per_block": kernel_ms / len(ms),
         "synthesis_host_ms_per_block":
             (log.pass_s * 1e3 - kernel_ms) / len(ms),
         "live_launch": live,
         "try_voice_ms_per_block": log.synth_s * 1e3 / len(ms),
         "voice_frames": stats.voice_frames,
         "stolen_frames": stats.stolen_frames,
         "acelp_launches": counts["acelp_decode"],
         "pool_items": len(log.pool_items),
         "pool_call_sizes": log.pool_calls,
         "pool_call_frames": [c[1].shape[1] for c in sp_calls],
         "speaking_carriers": speakers}
    steady = ms[1:] or ms
    r["process_block_ms_steady"] = sum(steady) / len(steady)
    del sp_calls
    # fewer slots than speaking carriers: the default, and 8 (2 in the
    # rehearsal's 4 voice carriers); the launches held against the plain
    # version are the first and the first after an eviction
    default = PipelineConfig.device_voice_slots
    for name, slots in (("default", default), ("few", 2 if REHEARSE else 8)):
        cfg = {} if name == "default" else {"device_voice_slots": slots}
        sp_calls = []
        lg, cn, ms_n, st_n = voice_stream_run(
            setup, False, 0, speech_calls=sp_calls, device_voice=True,
            **cfg)
        need_launched(f"voice fleet device {slots} slots", cn,
                      ("acelp_decode",))
        restarts = check_evictions(lg)
        if name == "few" and not restarts:
            fail(f"voice fleet device {slots} slots: no carrier was "
                 f"evicted")
        resets = [reset_before(sp_calls, i) for i in range(len(sp_calls))]
        after = next((i for i, k in enumerate(resets) if k), None)
        if restarts and after is None:
            fail(f"voice fleet device {slots} slots: {restarts} restarts "
                 f"but no launch found after a slot reset")
        for i in sorted({0} | ({after} if after is not None else set())):
            check_pool_launch(f"voice fleet device {slots} slots launch "
                              f"{i} ({resets[i]} slots reset before it)",
                              sp_calls[i])
        n_checked += 1 + (after is not None and after != 0)
        steady_n = ms_n[1:] or ms_n
        r[name] = {"slots": slots, "restarts": restarts,
                   "acelp_launches": cn["acelp_decode"],
                   "voice_frames": st_n.voice_frames,
                   "stolen_frames": st_n.stolen_frames,
                   "chunks_unlike_host": voice_diff(lg, host),
                   "chunks": sum(len(v) for v in lg.audio.values()),
                   "launch_checked_after_reset": after,
                   "process_block_ms": ms_n,
                   "process_block_ms_steady": sum(steady_n) / len(steady_n)}
        del sp_calls
    d, f = r["default"], r["few"]
    say(f"voice fleet device: {stats.voice_frames} voice frames "
        f"({stats.stolen_frames} stolen), audio, has_voice and counts equal "
        f"to host synthesis, unsplit and split after block 2; "
        f"{counts['acelp_decode']} acelp_decode launches over {len(ms)} "
        f"blocks (carriers a call {log.pool_calls}, frames a call "
        f"{r['pool_call_frames']}, {speakers} carriers in all, "
        f"{len(setup['offsets'])} slots); {n_checked} pool launches equal "
        f"to the plain version on their rows, the rest of the bank "
        f"unchanged; "
        + "; ".join(
            f"{x['slots']} slots: {x['restarts']} restarts after eviction, "
            f"each carrier's PCM equal to a host decoder restarted with it "
            f"({x['voice_frames']} voice frames, {x['chunks_unlike_host']} "
            f"of {x['chunks']} chunks unlike host synthesis), process_block "
            f"{x['process_block_ms_steady']:.2f} ms/block after the first"
            for x in (d, f))
        + f"; process_block {r['process_block_ms_steady']:.2f} ms/block "
        f"after the first (host synthesis "
        f"{fleet['result']['process_block_ms_steady']:.2f}), synthesis pass "
        f"{r['synthesis_pass_ms_per_block']:.2f} ms/block, of it "
        f"acelp_decode calls {r['synthesis_kernel_ms_per_block']:.2f} and "
        f"host "
        f"{r['synthesis_host_ms_per_block']:.2f} (host synthesis "
        f"{fleet['result']['host_synthesis_ms_per_block']:.2f}); the largest "
        f"launch (A={live['rows']} of {live['bank']} slots, F={live['frames']}"
        f") {live['ms']:.4f} ms a call ({live['kernel_ms']:.4f} ms the "
        f"launch alone), plain {live['plain_ms']:.1f} ms, host "
        f"C++ {live['host_ms']:.2f} ms on one core, bound "
        f"{live['bound_ms']:.4f} ms by {live['bound_by']}, floor "
        f"{live['floor_ms']:.4f} ms (synth_chain's clocks); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return {"result": r, "launches": counts}


def phase_voice_rtl() -> dict:
    """The classic chain (conv frontend, AFC) on a two-carrier voice
    capture at 2.4 Msps, one stealing, through run_offline on the card
    and on the CPU: the same PCM chunks, sample for sample."""
    import numpy as np
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.golden import speech
    from tetraear_tpu_torch.ref import golden
    n = 12 if REHEARSE else 20
    a = golden.golden_voice_iq(speech(n, 57, 0), fs=FS_RTL, seed=15,
                               stolen_every=5)
    b = golden.golden_voice_iq(speech(n, 44, 1), fs=FS_RTL, seed=16)
    m = min(len(a), len(b))
    t = np.arange(m) / FS_RTL
    iq = (a[:m] * np.exp(-2j * np.pi * 250e3 * t)
          + b[:m] * np.exp(2j * np.pi * 250e3 * t)).astype(np.complex64)
    runs = {}
    for name, device, dv in (("host", DEV, False), ("device", DEV, True),
                             ("cpu", "cpu", None)):
        audio = []
        pipe = Pipeline(PipelineConfig(
            sample_rate=FS_RTL, carrier_offsets_hz=(-250e3, 250e3),
            device=device, validate=False, block_len=131_072,
            device_voice=dv), on_audio=audio.append)
        ck.reset_launches()
        stats = pipe.run_offline(array_source(iq, FS_RTL),
                                 blocks_per_dispatch=4)
        sync()
        runs[name] = (audio, stats, dict(ck.launches), pipe)
        pipe.close()
    audio, stats, counts, pipe = runs["host"]
    if pipe.runner.fused is not None or not pipe.bank.afc:
        fail("voice rtl: expected the classic chain with AFC")
    if runs["device"][3]._voice_device is None or (
            runs["cpu"][3]._voice_device is not None):
        fail("voice rtl: expected device synthesis on the card run with "
             "device_voice=True and host synthesis on the CPU by default")
    need_launched("voice rtl", counts, ("frame_scan_even", "viterbi_decode"))
    need_launched("voice rtl device", runs["device"][2],
                  ("frame_scan_even", "viterbi_decode", "acelp_decode"))
    cpu_audio, cpu_stats = runs["cpu"][0], runs["cpu"][1]
    for name in ("host", "device"):
        audio, stats = runs[name][0], runs[name][1]
        if (len(audio) != len(cpu_audio) or not all(
                np.array_equal(x, y) for x, y in zip(audio, cpu_audio))
                or stats.voice_frames != cpu_stats.voice_frames
                or stats.stolen_frames != cpu_stats.stolen_frames):
            fail(f"voice rtl ({name} synthesis): the card's PCM "
                 f"({len(audio)} chunks, {stats.voice_frames} voice / "
                 f"{stats.stolen_frames} stolen frames) differs from the CPU "
                 f"run's ({len(cpu_audio)}, {cpu_stats.voice_frames} / "
                 f"{cpu_stats.stolen_frames})")
    if stats.voice_frames < n or stats.stolen_frames < 1:
        fail(f"voice rtl: {stats.voice_frames} voice frames "
             f"({stats.stolen_frames} stolen) of 2 x {n} slots")
    say(f"voice rtl: classic chain (conv, AFC), 2 carriers, "
        f"{stats.blocks} blocks: {stats.voice_frames} voice frames "
        f"({stats.stolen_frames} stolen), PCM equal to the CPU run sample "
        f"for sample with host and with device synthesis; launches "
        f"{ {k: v for k, v in counts.items() if v} } (host), "
        f"{ {k: v for k, v in runs['device'][2].items() if v} } (device)")
    return {"host": counts, "device": runs["device"][2]}


# ---------------------------------------------------------------------------
# multi-device sharding and the scanners
# ---------------------------------------------------------------------------
#
# This machine has one card, so a mesh here is a virtual one: several
# entries naming the card, whose shards run one after the other on it
# (their wall time is no scaling figure).  With more cards the conv rung
# runs over all of them too.

SHARD_ACTIVE = (5, 170, 341, 512, 683, 854, 1019)
# soft decisions nearer their boundary than this may flip between layouts
# (a batched library product may round otherwise at another batch size);
# the others are "firm"
SOFT_MARGIN = 1e-4
# float32 band power of the scanner, card against CPU
SCAN_POWER_TOL_DB = 1e-3


def virtual(n: int) -> list:
    """n mesh entries naming this run's device."""
    return [DEV] * n


def phase_sharded_conv() -> tuple:
    """The multi-device dry run's conv rung (ShardedDemod) on a virtual
    2 x 2 mesh of the card, and over all cards when there are several:
    unique frames equal the transmitted slots; its scaling table over a
    virtual mesh of 8 (sync_hits equal over the carrier layouts).  The
    conv path is plain torch (NCO, resample stages, RRC, timing), no
    hand kernel."""
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.runtime import multichip
    t0 = time.time()
    ck.reset_launches()
    res = {"virtual_2x2": multichip.conv_rung(virtual(4), 2, 2, say),
           "scaling": multichip.scaling_table(virtual(8), 8, say)}
    n_cards = torch.cuda.device_count() if DEV == "cuda" else 0
    if n_cards > 1:
        res["cards"] = multichip.conv_rung(
            [f"cuda:{i}" for i in range(n_cards)],
            *multichip._layout(n_cards), say)
    counts = dict(ck.launches)
    say(f"sharded conv: {time.time() - t0:.1f} s")
    return res, counts


def _margin_equal(a: dict, b: dict) -> tuple:
    """(valid equal, hard decisions that differ where both layouts' soft
    values lie at least SOFT_MARGIN from a boundary, such symbols, the
    largest soft difference on the valid symbols)."""
    import numpy as np
    v = a["valid"].astype(bool)
    firm = (v & (np.abs(a["soft"]).min(axis=-1) >= SOFT_MARGIN)
            & (np.abs(b["soft"]).min(axis=-1) >= SOFT_MARGIN))
    soft = float(np.abs(a["soft"][v] - b["soft"][v]).max()) if v.any() \
        else 0.0
    return (bool(np.array_equal(a["valid"], b["valid"])),
            int((a["hard"][firm] != b["hard"][firm]).sum()),
            int(firm.sum()), soft)


def sharded_timing(name: str, sd, seg: dict, reps: int) -> dict:
    """ms of one mesh step on resident segments (CUDA events), the host
    time of the step call (its return, before the card finishes) and its
    wall time with a synchronise; one shard's front and back phases alone
    (shard (0, 1): a left neighbour); hand-kernel launches a step; the
    redundant-work ratio (each time shard's back half also runs its
    back_halo, the front transforms what the stream would)."""
    import torch
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    n_shards = sd.mesh.size
    step_ms = event_ms(lambda: sd.step(seg), reps)
    sync()
    host, wall = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        sd.step(seg)
        host.append((time.perf_counter() - t0) * 1e3)
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
    ch = sd.chan
    x = seg[(0, 1)]
    left = torch.zeros((ch.overlap, 2), dtype=torch.float32,
                       device=x.device)
    front_ms = event_ms(lambda: sd._front(0, 1, x, left), reps)
    y = sd._front(0, 1, x, left)
    left_y = torch.zeros((sd.c_local, sd.back_halo, 2),
                         dtype=torch.float32, device=x.device)
    back_ms = event_ms(lambda: sd._back(1, y, left_y), reps)
    ck.reset_launches()
    sd.step(seg)
    sync()
    launches = {k: v for k, v in ck.launches.items() if v}
    extract = sharded_extract(name, sd)
    r = {"mesh": dict(sd.mesh.shape), "carriers": sd.n_carriers,
         "fs": sd.fs, "seg_len": sd.seg_len,
         "signal_ms_per_step": sd.seg_len * sd.n_time / sd.fs * 1e3,
         "ms_per_step": step_ms, "ms_per_shard_step": step_ms / n_shards,
         "shard_front_ms": front_ms, "shard_back_ms": back_ms,
         "host_ms_per_step": min(host), "wall_ms_per_step": min(wall),
         "host_share": min(host) / min(wall),
         "hand_kernel_launches_per_step": launches,
         "redundant_work": (ch.n_out + sd.back_halo) / ch.n_out,
         "extract": extract,
         "label": ("one card, shards serialised" if DEV == "cuda"
                   else "CPU rehearsal")}
    say(f"sharded fft {name} timing ({r['label']}, C={sd.n_carriers}, "
        f"mesh {sd.mesh.shape}): {step_ms:.3f} ms a mesh step "
        f"({r['signal_ms_per_step']:.1f} ms of signal), "
        f"{step_ms / n_shards:.3f} a shard; one shard's front "
        f"{front_ms:.3f} + back {back_ms:.3f} ms; host {min(host):.2f} of "
        f"{min(wall):.2f} ms wall; launches a step {launches}; "
        f"redundant work {r['redundant_work']:.4f}")
    return r


def sharded_extract(name: str, sd) -> dict:
    """The shard's extraction kernel at its shape (carrier shard 0's plan
    over a random spectrum), held against its plain version and the
    single-call gather, timed with its bound (extract_result)."""
    import numpy as np
    import torch
    plan = sd.plans[0]
    dev = torch.device(DEV)
    rng = np.random.default_rng(61)
    starts = torch.from_numpy(plan.starts).to(dev)
    if plan.form == "rows":
        src = torch.from_numpy(rng.standard_normal(
            (2, plan.n_rows, 128)).astype(np.float32)).to(dev)
        idx = (starts.long()[:, None, None]
               + torch.arange(plan.span, device=dev)[None, None, :])
        pl_idx = torch.arange(2, device=dev)[None, :, None]

        def gather():
            return src[pl_idx, idx]
    else:
        src = torch.from_numpy(rng.standard_normal(
            (plan.n_rows, 2)).astype(np.float32)).to(dev)
        idx = (starts.long()[:, None]
               + torch.arange(plan.span, device=dev)[None, :])

        def gather():
            return src[idx]
    r = extract_result(f"sharded fft {name} extraction", src, plan, starts,
                       gather, 5, 50)
    unit = " rows of 128" if plan.form == "rows" else ""
    say(f"  {plan.form} extraction of a shard ({len(plan.starts)} bands of "
        f"{plan.span}{unit}): equal to the plain version; call "
        f"{r['ms']:.4f} ms, "
        f"launch {r['launch_ms']:.4f}, gather {r['library_ms']:.4f}, plain "
        f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f}")
    return r


def phase_sharded_fft(name: str, fs: float, c: int, kernel: str,
                      seed: int, reps: int) -> tuple:
    """ShardedFFTDemod at full width on a virtual mesh: the (2, 2) run
    launches ``kernel`` and its deduped frames on the modulated carriers
    equal the transmitted slots; the (1, 2), (2, 2) and (4, 2) meshes give
    the same sync_hits and unique frames (the largest soft difference
    across them printed); then the (2, 2) step timed."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.runtime import multichip
    from tetraear_tpu_torch.runtime.sharding import (ShardedFFTDemod,
                                                     make_mesh)
    offsets = grid(c)
    active = list(SHARD_ACTIVE) if c == 1024 else list(range(c))
    demods = {n_c: ShardedFFTDemod(fs, offsets,
                                   make_mesh(n_c, 2, virtual(2 * n_c)))
              for n_c in (1, 2, 4)}
    d22 = demods[2]
    form = d22.plans[0].form
    t0 = time.time()
    iq, n_slots = multichip.modulated_capture(
        offsets, 2 * d22.seg_len, fs=fs, seed=seed, active=active)
    say(f"sharded fft {name}: capture {len(iq)} samples at {fs / 1e6:g} MHz,"
        f" {len(active)} of {c} carriers modulated ({n_slots} slots), made "
        f"in {time.time() - t0:.1f} s; {form} extraction "
        f"(n_band {d22.chan.n_band}, aligned {d22.chan.aligned})")
    geom = multichip.fft_frame_geometry(d22)
    runs, counts = {}, None
    for n_c, sd in demods.items():
        ck.reset_launches()
        t0 = time.time()
        out = sd.run(iq)
        wall = time.time() - t0
        if n_c == 2:
            counts = dict(ck.launches)
            need_launched(f"sharded fft {name}", counts, (kernel,))
        uniq = multichip.count_unique_frames(out, c, 2, *geom,
                                             carriers=active)
        runs[n_c] = (out, uniq)
        say(f"  mesh ({n_c}, 2): sync_hits {out['sync_hits']}, unique "
            f"frames {uniq} of {n_slots} slots, first run {wall:.2f} s")
        if uniq != n_slots:
            fail(f"sharded fft {name} ({n_c}, 2): {uniq} unique frames for "
                 f"{n_slots} transmitted slots")
    ref = runs[2][0]
    soft = {}
    for n_c in (1, 4):
        out = runs[n_c][0]
        if out["sync_hits"] != ref["sync_hits"]:
            fail(f"sharded fft {name}: sync_hits {out['sync_hits']} on "
                 f"({n_c}, 2) against {ref['sync_hits']} on (2, 2)")
        same_valid, n_diff, n_firm, soft[n_c] = _margin_equal(out, ref)
        say(f"  ({n_c}, 2) against (2, 2): valid equal {same_valid}, "
            f"{n_diff} of {n_firm} firm hard decisions differ, largest "
            f"soft difference {soft[n_c]:.3g}")
    r = sharded_timing(name, d22, d22.upload(iq), reps)
    r.update(unique_frames=runs[2][1], slots=n_slots,
             sync_hits=ref["sync_hits"], extraction=form,
             max_soft_diff_across_layouts=max(soft.values()))
    del runs, demods, iq
    return r, counts


def phase_sharded_fft_big(c: int, fs: float, reps: int) -> tuple:
    """ShardedFFTDemod at C=10240 on a virtual (2, 2) mesh of noise: the
    carrier-axis check against (1, 2) (valid, firm decisions, sync_hits
    printed), and the (2, 2) step timed."""
    import numpy as np
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.runtime.sharding import (ShardedFFTDemod,
                                                     make_mesh)
    offsets = grid(c)
    d22 = ShardedFFTDemod(fs, offsets, make_mesh(2, 2, virtual(4)))
    rng = np.random.default_rng(29)
    n = 2 * d22.seg_len
    iq = np.empty(n, np.complex64)
    iq.real = rng.standard_normal(n, dtype=np.float32)
    iq.imag = rng.standard_normal(n, dtype=np.float32)
    ck.reset_launches()
    out = d22.run(iq)
    counts = dict(ck.launches)
    kernel = "band_extract_rows" if d22.chan.aligned else "band_extract"
    need_launched("sharded fft C=10240", counts, (kernel,))
    seg = d22.upload(iq)
    r = sharded_timing(f"C={c}", d22, seg, reps)
    del seg
    other = ShardedFFTDemod(fs, offsets, make_mesh(1, 2, virtual(2))).run(iq)
    same_valid, n_diff, n_firm, soft = _margin_equal(other, out)
    say(f"sharded fft C={c}: (1, 2) against (2, 2): valid equal "
        f"{same_valid}, {n_diff} of {n_firm} firm hard decisions differ, "
        f"largest soft difference {soft:.3g}, sync_hits "
        f"{other['sync_hits']} / {out['sync_hits']} (noise)")
    # noise: a decision whose differential product is near zero turns on
    # rounding, so at most one firm decision in 10^5 may differ
    if not same_valid or n_diff > n_firm * 1e-5:
        fail(f"sharded fft C={c}: the carrier layouts disagree")
    r.update(sync_hits=out["sync_hits"], sync_hits_1x2=other["sync_hits"],
             max_soft_diff_across_layouts=soft, extraction=kernel)
    return r, counts


def phase_sharded_small() -> dict:
    """At 2.304 MHz, C=8, every carrier modulated: the (2, 2) virtual mesh
    on the card equals the port's CPU run (valid and sync_hits; hard on
    the valid symbols beyond a 64-symbol warmup)."""
    import numpy as np
    from tetraear_tpu_torch.golden import fleet_capture
    from tetraear_tpu_torch.runtime.sharding import (ShardedFFTDemod,
                                                     make_mesh)
    offsets = grid(8)
    outs = {}
    for dev in (DEV, "cpu"):
        sd = ShardedFFTDemod(FS_SMALL, offsets,
                             make_mesh(2, 2, [dev] * 4))
        if not outs:
            iq = fleet_capture(FS_SMALL, offsets, range(8), 2 * sd.seg_len,
                               seed=31)
        outs[dev] = sd.run(iq)
    a, b = outs[DEV], outs["cpu"]
    v = b["valid"].astype(bool)
    v[..., :64] = False
    if (not np.array_equal(a["valid"], b["valid"])
            or a["sync_hits"] != b["sync_hits"]
            or not np.array_equal(a["hard"][v], b["hard"][v])):
        fail(f"sharded fft small: the card's run differs from the CPU's "
             f"(hits {a['sync_hits']} / {b['sync_hits']})")
    say(f"sharded fft small (2.304 MHz, C=8, (2, 2)): equal to the CPU run, "
        f"sync_hits {a['sync_hits']}")
    return {"sync_hits": a["sync_hits"]}


def nccl_child() -> int:
    """--nccl-one-rank: the sharded FFT step at the small geometry with
    and without a one-rank process group (NCCL on the card, gloo in the
    rehearsal); prints one JSON line.  Run by phase_nccl_one_rank in its
    own process, so that a stuck collective cannot hold the run."""
    import socket
    import numpy as np
    import torch.distributed as dist
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.golden import fleet_capture
    from tetraear_tpu_torch.runtime import distributed
    from tetraear_tpu_torch.runtime.sharding import (ShardedFFTDemod,
                                                     make_mesh)
    offsets = grid(8)
    sd = ShardedFFTDemod(FS_SMALL, offsets, make_mesh(2, 2, virtual(4)))
    iq = fleet_capture(FS_SMALL, offsets, range(8), 2 * sd.seg_len, seed=31)
    alone = sd.run(iq)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(TETRAEAR_COORDINATOR=f"127.0.0.1:{port}",
                      TETRAEAR_NUM_PROCESSES="1", TETRAEAR_PROCESS_ID="0")
    try:
        if not distributed.init_distributed(device=DEV):
            fail("nccl one rank: init_distributed did nothing")
        backend = dist.get_backend()
        ck.reset_launches()
        grouped = sd.run(iq)
        counts = dict(ck.launches)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    same = all(np.asarray(grouped[k]).tobytes()
               == np.asarray(alone[k]).tobytes()
               for k in ("hard", "soft", "valid", "sync_hits"))
    print(json.dumps({"backend": backend, "equal": same,
                      "sync_hits": grouped["sync_hits"],
                      "launches": counts}), flush=True)
    return 0 if same else 1


def phase_nccl_one_rank() -> tuple:
    """init_distributed with one rank (TETRAEAR_NUM_PROCESSES=1, a free
    loopback port), the sharded FFT step with its all-reduce on NCCL,
    equal to the run without torch.distributed; the group destroyed.  In
    a process of its own, stopped after 300 s."""
    args = [sys.executable, str(ROOT / "chip_smoke.py"), "--nccl-one-rank"]
    if REHEARSE:
        args.append("--rehearse")
    env = dict(os.environ, NCCL_SOCKET_IFNAME=os.environ.get(
        "NCCL_SOCKET_IFNAME", "lo"))
    proc = subprocess.Popen(args, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    last = log.strip().splitlines()[-1] if log.strip() else ""
    if proc.returncode != 0 or not last.startswith("{"):
        fail(f"nccl one rank: exit {proc.returncode}\n{log[-3000:]}")
    r = json.loads(last)
    if not r["equal"]:
        fail(f"nccl one rank: differs from the run without a group: {r}")
    need_launched("nccl one rank", r["launches"], ("band_extract",))
    say(f"nccl one rank: {r['backend']} group of 1, sharded fft small "
        f"equal to the run without torch.distributed (sync_hits "
        f"{r['sync_hits']}); group destroyed")
    return r, r["launches"]


def phase_voice_mesh(seed: int) -> tuple:
    """DeviceSpeechPool(mesh=) over 256 slots at virtual sizes 1/2/4, on
    the voice fleet's largest launch shape (118 carriers x 16 frames):
    four calls (carriers A, then B on other slots, A again carrying its
    state, then a checkpoint restored into a fresh sharded pool and B
    again), PCM bit-equal to the unsharded pool; acelp_decode launches
    counted per call (one a shard with active rows)."""
    import numpy as np
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.runtime.sharding import Mesh
    from tetraear_tpu_torch.voice.speech_pool import DeviceSpeechPool
    n_items = 8 if REHEARSE else 118
    fr, valid = speech_inputs(4 * n_items, 16, seed)
    fr[:, :, 0] |= ~valid                  # a hole as a bad frame

    def items(k, carriers):
        return [(c, fr[k * n_items + i].astype(np.int16))
                for i, c in enumerate(carriers)]
    a, b = list(range(n_items)), list(range(200, 200 + n_items))
    calls = [items(0, a), items(1, b), items(2, a), items(3, b)]
    ref = DeviceSpeechPool(slots=256, device=DEV)
    want = [ref.synthesize(it) for it in calls]
    res, counts_all = {}, {}
    for n in (1, 2, 4):
        mesh = Mesh(virtual(n), ("voice",))
        pool = DeviceSpeechPool(slots=256, mesh=mesh)
        per_call = []
        for i, it in enumerate(calls):
            if i == 3:
                leaves, meta = pool.checkpoint_state()
                pool = DeviceSpeechPool(slots=256, mesh=mesh)
                pool.restore_state(leaves, meta)
            ck.reset_launches()
            got = pool.synthesize(it)
            sync()
            per_call.append(ck.launches["acelp_decode"])
            if any(w.tobytes() != g.tobytes() for w, g in zip(want[i], got)):
                fail(f"voice mesh: PCM of call {i} at mesh size {n} differs "
                     f"from the unsharded pool")
        shards_touched = [len({pool._map[c] // (256 // n) for c, _ in it})
                          for it in calls]
        if DEV == "cuda" and per_call != shards_touched:
            fail(f"voice mesh {n}: acelp_decode launches {per_call}, "
                 f"shards with active rows {shards_touched}")
        res[n] = per_call
        counts_all[n] = sum(per_call)
    say(f"voice mesh: 256 slots over virtual meshes of 1/2/4, {n_items} "
        f"carriers x 16 frames a call, 4 calls (state carried, a "
        f"checkpoint restored into a fresh sharded pool): PCM bit-equal to "
        f"the unsharded pool; acelp_decode launches a call {res}")
    return res, {"acelp_decode": sum(counts_all.values())}


def phase_crypto_mesh() -> tuple:
    """The multi-device dry run's crypto rung on a virtual mesh of 4:
    K 6 x B 1024, every plaintext equal to TEADecryptor's; tea_search
    launched on every shard."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.runtime import multichip
    ck.reset_launches()
    t0 = time.time()
    multichip.crypto_rung(virtual(4), 4, say)
    counts = dict(ck.launches)
    # tea_decrypt_batch: a decrypt launch a shard; tea_key_search: a
    # search and a pairs launch a shard
    if DEV == "cuda" and counts["tea_search"] != 4 * 3:
        fail(f"crypto mesh: {counts['tea_search']} tea_search launches, "
             f"expected 12")
    say(f"crypto mesh: {time.time() - t0:.1f} s, tea_search launches "
        f"{counts['tea_search']}")
    return {"tea_search": counts["tea_search"]}, counts


def phase_scan_wideband() -> tuple:
    """WidebandScanner on the card over a 2.4 Msps golden capture (4 of
    its 92 channels modulated, two FFT blocks): every channel's verdict,
    n_frames, crc_pass_rate and sync_count equal the port's CPU run,
    power_db within SCAN_POWER_TOL_DB; band_synth_y launched; the scan
    timed (wall, the frame layer on the host included)."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.golden import fleet_capture
    from tetraear_tpu_torch.scan.scanner import WidebandScanner
    ws = WidebandScanner(fs=FS_RTL)
    hot = [10, 30, 55, 80]
    iq = fleet_capture(FS_RTL, list(ws.offsets), hot, 480_000, seed=41,
                       text="SCAN")
    ck.reset_launches()
    t0 = time.perf_counter()
    got = ws.scan(iq, center_freq_hz=392.5e6, device=DEV)
    first_s = time.perf_counter() - t0
    counts = dict(ck.launches)
    need_launched("scan wideband", counts, ("band_synth_y",))
    t0 = time.perf_counter()
    ws.scan(iq, center_freq_hz=392.5e6, device=DEV)
    again_s = time.perf_counter() - t0
    want = ws.scan(iq, center_freq_hz=392.5e6, device="cpu")
    keys = ("is_tetra", "n_frames", "crc_pass_rate", "sync_count",
            "sync_detected", "frames_validated")
    bad = [(w["offset_hz"], k) for w, g in zip(want, got) for k in keys
           if w[k] != g[k]]
    p_err = max(abs(w["power_db"] - g["power_db"])
                for w, g in zip(want, got))
    if bad or p_err > SCAN_POWER_TOL_DB:
        fail(f"scan wideband: card differs from the CPU run at {bad[:5]}, "
             f"power {p_err:.3g} dB")
    found = sorted(r["offset_hz"] for r in got if r["is_tetra"])
    if not {ws.offsets[i] for i in hot} <= set(found):
        fail(f"scan wideband: found {found}")
    say(f"scan wideband: {len(iq)} samples ({len(iq) / FS_RTL * 1e3:.0f} ms) "
        f"at 2.4 MHz, {ws.n_channels} channels; {len(found)} TETRA "
        f"channels; equal to the CPU run (power within {p_err:.2g} dB); "
        f"a scan {again_s * 1e3:.1f} ms on {DEV} (first {first_s:.2f} "
        f"s); launches {({k: v for k, v in counts.items() if v})}")
    return {"scan_ms": again_s * 1e3, "first_scan_s": first_s,
            "found": len(found), "max_power_diff_db": p_err,
            "capture_ms": len(iq) / FS_RTL * 1e3}, counts


# -- the tools and profiling ----------------------------------------------

# (cipher, key, SDS payload) of the tools' capture: both keys are in the
# common-key list (tools/generate_common_keys.py)
TOOL_CIPHERS = (("TEA1", "0123456789ABCDEF0123", "RELOCATE NOW"),
                ("TEA2", "0123456789ABCDEF0123456789ABCDEF",
                 "GATE SEVEN OPEN"))
TOOL_SLOTS = 24
# bruteforce-keys at a dictionary size a user runs: the common keys plus
# seeded keys (half TEA1, half TEA2) over 50 recorded frames (the tool's
# --max-frames default)
BF_SEEDED_KEYS = 4096
BF_FRAMES = 50
# the tools that take --device (the others run on the host only)
DEVICE_TOOLS = ("continuous_capture", "decrypt_capture", "listen_clear",
                "auto_capture", "bruteforce_keys")


def tools_capture(path: Path, seed: int, n_slots: int) -> None:
    """A 2.4 Msps capture on the tools' default channel (offset 0): SDS
    slots encrypted in turn with TOOL_CIPHERS' TEA1 and TEA2 keys, 25 dB
    SNR (the port's golden, modulator and TEADecryptor)."""
    import numpy as np
    from tetraear_tpu_torch.crypto.tea import TEADecryptor
    from tetraear_tpu_torch.ref import golden, modulator
    from tetraear_tpu_torch.runtime.sources import write_capture
    rng = np.random.default_rng(seed)
    slots = []
    for i in range(n_slots):
        alg, key, text = TOOL_CIPHERS[i % len(TOOL_CIPHERS)]
        clear = golden.sds_text_payload(text)
        clear += b"\x00" * ((-len(clear)) % 8)
        cipher = TEADecryptor(bytes.fromhex(key), alg).encrypt(clear)
        slots.append(golden.build_slot(golden.build_mac_resource_data_bits(
            cipher, rng=rng, enc_mode=1), rng=rng))
    pad = rng.integers(0, 2, 64).astype(np.uint8)
    iq = modulator.generate_carrier(np.concatenate([pad] + slots), fs=FS_RTL)
    write_capture(path, modulator.add_awgn(iq, 25, rng))


def tool_runs() -> tuple:
    """The tools' two runs: on DEV (the card; the CPU in the rehearsal)
    and on the CPU, each into directories of its own."""
    return (("card", DEV), ("cpu", "cpu"))


def tool_run(name: str, argv: list, device: str,
             out_dir: Path | None = None) -> tuple:
    """A tool's main as the CLI calls it, on the card (no --device: the
    default) or with --device cpu, its stdout kept; launch counts set to
    0 just before and read just after.  Returns (rc, stdout, launches,
    seconds); ``out_dir`` in the stdout reads <out>."""
    import contextlib
    import importlib
    import io
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    mod = importlib.import_module(f"tetraear_tpu_torch.tools.{name}")
    if device == "cpu" and name in DEVICE_TOOLS:
        argv = [*argv, "--device", "cpu"]
    buf = io.StringIO()
    ck.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    sync()
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    if out_dir is not None:
        out = out.replace(str(out_dir), "<out>")
    return rc, out, dict(ck.launches), seconds


def wall_clock_names(out: str) -> str:
    """``out`` with the wall-clock stamp of each call file's name
    (voice/export.py: call_tg<tg>_<YYYYmmdd_HHMMSS>.wav, the second the
    call started) replaced: the card's run and the CPU run start their
    calls in different seconds whenever a second boundary falls between
    them.  The files' PCM is compared on its own."""
    return re.sub(r"(call_tg\d+)_\d{8}_\d{6}\.wav", r"\1_<start>.wav", out)


def tool_pair(name: str, argv_of, what: str) -> tuple:
    """The tool on the card and on the CPU (argv_of("card" or "cpu") ->
    (argv, output directory or None)); fails unless both exit 0 with the
    same stdout, call files' wall-clock stamps aside.  Returns (the
    card's stdout, its launches, its seconds)."""
    runs = {}
    for run, device in tool_runs():
        argv, out_dir = argv_of(run)
        rc, out, counts, secs = tool_run(name, argv, device, out_dir)
        runs[run] = (rc, wall_clock_names(out), counts, secs)
        if runs[run][0] != 0:
            fail(f"tools {what} on {device}: exit code {runs[run][0]}:\n"
                 f"{runs[run][1][-2000:]}")
    if runs["card"][1] != runs["cpu"][1]:
        fail(f"tools {what}: the card's output differs from the CPU "
             f"run's:\n{runs['card'][1][-1500:]}\n--- cpu ---\n"
             f"{runs['cpu'][1][-1500:]}")
    return runs["card"][1:]


def jsonl_frames(out_dir: Path) -> list:
    logs = sorted(out_dir.glob("continuous_*.jsonl"))
    if len(logs) != 1:
        fail(f"tools continuous-capture: {len(logs)} logs in {out_dir}")
    return [json.loads(line) for line in logs[0].read_text().splitlines()]


def bruteforce_inputs(d: Path, common: list, seed: int, n_keys: int,
                      n_frames: int) -> tuple:
    """The timed bruteforce-keys run's inputs: a key file of the common
    keys and n_keys seeded ones (half TEA1, half TEA2), and a JSONL of
    n_frames encrypted SDS frames, every fourth under a seeded key, the
    others under common keys, between clear frames."""
    import numpy as np
    from tetraear_tpu_torch.crypto.tea import TEADecryptor
    rng = np.random.default_rng(seed)
    seeded = [("TEA1" if i % 2 == 0 else "TEA2",
               rng.bytes(10 if i % 2 == 0 else 16).hex().upper())
              for i in range(n_keys)]
    keys = d / "bf_keys.txt"
    keys.write_text("\n".join([*common, *(f"{a}:9:{k}" for a, k in seeded)])
                    + "\n")
    known = [(a, k) for a, k in (line.split(":")[0::2] for line in common)
             if a in ("TEA1", "TEA2")]
    rows = []
    for i in range(n_frames):
        alg, key = (seeded[(i // 4) % len(seeded)] if i % 4 == 0
                    else known[int(rng.integers(len(known)))])
        text = f"\x82UNIT {i} STATUS {int(rng.integers(1000))}".encode(
            "latin-1")
        text += b"\x00" * ((-len(text)) % 8)
        cipher = TEADecryptor(bytes.fromhex(key), alg).encrypt(text)
        rows.append(json.dumps({"encrypted": True, "number": i,
                                "mac_pdu": {"data": cipher.hex()}}))
        rows.append(json.dumps({"encrypted": False, "number": i}))
    frames = d / "bf_frames.jsonl"
    frames.write_text("\n".join(rows) + "\n")
    return frames, keys


def time_bruteforce(frames: Path, keys: Path, reps: int) -> dict:
    """bruteforce-keys on the card at a user's size, its time split: the
    tool's wall time; its one key-search call (tea_decrypt_families:
    upload, launch, fetch), host wall; the host scoring loop after it
    (to the tool's end); then the recorded search replayed by
    phase_tea_path (call and launch alone by CUDA events, plain version,
    bound)."""
    from tetraear_tpu_torch.crypto import batch as tb
    calls, marks = [], {}
    undo = record_tea_calls(calls)
    recording = tb.tea_decrypt_families

    def timed(*a, **k):
        marks["call_start"] = time.perf_counter()
        out = recording(*a, **k)
        marks["call_end"] = time.perf_counter()
        return out

    tb.tea_decrypt_families = timed
    try:
        t_begin = time.perf_counter()
        rc, out, counts, seconds = tool_run(
            "bruteforce_keys", [str(frames), "-k", str(keys)], DEV)
    finally:
        undo()
    if rc != 0 or len(calls) != 1:
        fail(f"tools bruteforce-keys timed: exit {rc}, {len(calls)} key "
             f"searches")
    if DEV != "cpu" and counts["tea_search"] != 1:
        fail(f"tools bruteforce-keys timed: {counts['tea_search']} "
             f"tea_search launches, want 1")
    pay, k1, k2 = calls[0]
    path = phase_tea_path(calls, reps, "bruteforce-keys' key search")[0]
    r = {"wall_ms": seconds * 1e3,
         "call_ms": (marks["call_end"] - marks["call_start"]) * 1e3,
         "before_call_ms": (marks["call_start"] - t_begin) * 1e3,
         "keys1": len(k1), "keys2": len(k2), "frames": int(pay.shape[0]),
         "length": int(pay.shape[1]),
         "candidates": sum(1 for line in out.splitlines()
                           if line.startswith("[+] candidate")),
         "tea_search_launches": counts["tea_search"],
         "search": {k: path[k] for k in (
             "ms", "launch_ms", "plain_ms", "round_trip_ms", "bound_ms",
             "bound_by")}}
    # the rest of the tool's wall time: the scoring loop, its sort and
    # its prints
    r["scoring_ms"] = r["wall_ms"] - r["before_call_ms"] - r["call_ms"]
    say(f"tools bruteforce-keys timed: {r['keys1']}+{r['keys2']} keys (TEA1 "
        f"+ TEA2 families) x {r['frames']} frames x L {r['length']}, one "
        f"tea_search launch; the tool {r['wall_ms']:.1f} ms wall: reading "
        f"and packing {r['before_call_ms']:.1f} ms, the key search call "
        f"{r['call_ms']:.2f} ms (upload, launch, fetch; replayed: call "
        f"{path['ms']:.4f} ms, launch alone {path['launch_ms']:.4f} ms, "
        f"plain {path['plain_ms']:.2f} ms, bound {path['bound_ms']:.5f} ms "
        f"by {path['bound_by']}), the host scoring loop "
        f"{r['scoring_ms']:.1f} ms ({r['candidates']} candidates printed)")
    return r


def phase_tools(seed: int, reps: int) -> dict:
    """The tools on the card, each equal to its --device cpu run:
    continuous-capture and decrypt-capture on a 2.4 Msps capture of TEA1
    and TEA2 SDS slots (the classic conv chain: frame_scan_even; the
    deferred search of each block: tea_search), bruteforce-keys over the
    encrypted frames continuous-capture recorded with the common keys
    (exactly one tea_search launch, the transmitted texts among the
    candidates), then timed at a user's size; listen-clear and
    auto-capture on the synthetic voice source; verify-codec."""
    import tempfile
    from tetraear_tpu_torch.tools.generate_common_keys import generate
    res, launches = {}, {}
    n_slots = 8 if REHEARSE else TOOL_SLOTS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        d = Path(tmp)
        capture = d / "enc.cfile"
        tools_capture(capture, seed, n_slots)
        common = d / "common.txt"
        rc, _, _, _ = tool_run("generate_common_keys", ["-o", str(common)],
                               "cpu")
        if rc != 0 or len(generate()) != 228:
            fail("tools generate-keys: not the 228 common keys")
        n_each = n_slots // len(TOOL_CIPHERS)

        # continuous-capture: the JSONL log, card against CPU
        logs = {}
        for run, device in tool_runs():
            out_dir = d / f"cc_{run}"
            rc, _, counts, secs = tool_run(
                "continuous_capture", ["--source", str(capture),
                                       "-o", str(out_dir)], device)
            if rc != 0:
                fail(f"tools continuous-capture on {device}: exit {rc}")
            logs[run] = jsonl_frames(out_dir)
            if run == "card":
                launches["continuous_capture"] = counts
                res["continuous_capture_s"] = secs

        def key(f):
            return (f.get("stream_symbol"), f.get("burst_crc"),
                    f.get("encrypted"), f.get("decrypted"),
                    f.get("key_used"), f.get("sds_message"),
                    (f.get("mac_pdu") or {}).get("data"))

        if [key(f) for f in logs["card"]] != [key(f) for f in logs["cpu"]]:
            fail(f"tools continuous-capture: the card's {len(logs['card'])} "
                 f"frames differ from the CPU run's {len(logs['cpu'])}")
        need_launched("tools continuous-capture",
                      launches["continuous_capture"],
                      ("frame_scan_even", "tea_search"))
        for _, _, text in TOOL_CIPHERS:
            got = sum(f.get("sds_message") == f"[TXT] {text}"
                      for f in logs["card"] if f.get("decrypted"))
            if got < n_each - 1:
                fail(f"tools continuous-capture: {got} frames decrypted to "
                     f"{text!r} of {n_each} sent")
        enc = [f for f in logs["card"] if f.get("encrypted")]
        used = {k: v for k, v in launches["continuous_capture"].items() if v}
        say(f"tools continuous-capture: {len(logs['card'])} frames "
            f"({len(enc)} encrypted, all decrypted with common keys) equal "
            f"to the CPU run, {res['continuous_capture_s']:.2f} s; launches "
            f"{used}")

        # decrypt-capture: its report, card against CPU
        out, counts, secs = tool_pair(
            "decrypt_capture", lambda dev: (["--source", str(capture)], None),
            "decrypt-capture")
        launches["decrypt_capture"] = counts
        need_launched("tools decrypt-capture", counts,
                      ("frame_scan_even", "tea_search"))
        n_dec = out.count("[+] DECRYPTED")
        if n_dec < n_slots - 2 or not all(text in out
                                          for _, _, text in TOOL_CIPHERS):
            fail(f"tools decrypt-capture: {n_dec} decryptions reported:\n"
                 f"{out[-1500:]}")
        say(f"tools decrypt-capture: {n_dec} decrypted frames reported "
            f"(keys, confidences, texts) equal to the CPU run, {secs:.2f} "
            f"s; launches { {k: v for k, v in counts.items() if v} }")

        # bruteforce-keys over the recorded encrypted frames, common keys
        log = sorted((d / "cc_card").glob("continuous_*.jsonl"))[0]
        out, counts, secs = tool_pair(
            "bruteforce_keys",
            lambda dev: ([str(log), "-k", str(common)], None),
            "bruteforce-keys")
        launches["bruteforce_keys"] = counts
        if DEV != "cpu" and counts["tea_search"] != 1:
            fail(f"tools bruteforce-keys: {counts['tea_search']} tea_search "
                 f"launches, want exactly 1")
        cands = [line for line in out.splitlines()
                 if line.startswith("[+] candidate")]
        for alg, k, text in TOOL_CIPHERS:
            if not any(f"key={alg}:{k[:20]}..." in c and text in c
                       for c in cands):
                fail(f"tools bruteforce-keys: {text!r} under {alg} not "
                     f"among the {len(cands)} candidates")
        res["bruteforce_keys_common"] = {"candidates": len(cands),
                                         "frames": len(enc),
                                         "wall_s": secs}
        say(f"tools bruteforce-keys: {len(enc)} recorded frames x the 228 "
            f"common keys, one tea_search launch "
            f"({counts['tea_search']}), {len(cands)} candidates equal to "
            f"the CPU run, the transmitted texts among them, {secs:.2f} s")

        # bruteforce-keys timed at a user's dictionary size
        n_keys, n_frames = ((64, 8) if REHEARSE
                            else (BF_SEEDED_KEYS, BF_FRAMES))
        frames, keys = bruteforce_inputs(
            d, [line for line in common.read_text().splitlines()
                if line and not line.startswith("#")], seed + 1, n_keys,
            n_frames)
        res["bruteforce_keys"] = time_bruteforce(frames, keys, reps)

        # listen-clear and auto-capture on the synthetic voice source
        def calls_of(run):
            return (["--source", "synthetic-voice", "--max-blocks", "4",
                     "-o", str(d / f"calls_{run}")], d / f"calls_{run}")

        out, counts, secs = tool_pair("listen_clear", calls_of,
                                      "listen-clear")
        wavs = {run: [p.read_bytes() for p in sorted(
            (d / f"calls_{run}").glob("*.wav"))] for run, _ in tool_runs()}
        if not wavs["card"] or wavs["card"] != wavs["cpu"]:
            fail(f"tools listen-clear: {len(wavs['card'])} calls on the card, "
                 f"not equal to the CPU run's {len(wavs['cpu'])}")
        launches["listen_clear"] = counts
        say(f"tools listen-clear: {out.splitlines()[-1]}; the calls' PCM "
            f"equal to the CPU run, {secs:.2f} s; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        for source in ("synthetic", "synthetic-voice"):
            def auto_of(run, source=source):
                o = d / f"auto_{source}_{run}"
                return (["--source", source, "--max-blocks", "5",
                         "-o", str(o)], o)

            out, counts, secs = tool_pair("auto_capture", auto_of,
                                          f"auto-capture {source}")
            hits = {run: {p.name: p.read_bytes() for p in sorted(
                (d / f"auto_{source}_{run}").glob("hit_*"))}
                for run, _ in tool_runs()}
            if not hits["card"] or hits["card"] != hits["cpu"]:
                fail(f"tools auto-capture {source}: files "
                     f"{sorted(hits['card'])} differ from the CPU run's")
            launches[f"auto_capture_{source}"] = counts
            say(f"tools auto-capture {source}: {sorted(hits['card'])} equal "
                f"to the CPU run, {secs:.2f} s; launches "
                f"{ {k: v for k, v in counts.items() if v} }")

    rc, out, _, _ = tool_run("verify_codec", ["--build"], "cpu")
    if rc != 0:
        fail(f"tools verify-codec: exit {rc}:\n{out[-1500:]}")
    say("tools verify-codec: 0 (the port's voice/csrc library)")
    res["launches"] = launches
    return res


# -- the UI and the examples ---------------------------------------------

# the conv frontend's block at 2.4 Msps (PipelineConfig.block_len rounded
# to the granularity): 54.5 ms of signal
UI_BLOCK = 130_800
UI_VOICE_BLOCKS = 6
UI_DASH_BLOCKS = 5
UI_FRAME_KEYS = ("number", "type_name", "carrier", "burst_crc", "encrypted",
                 "decrypted", "sds_message", "stream_symbol")
UI_TABLES = ("frames_table", "calls_table", "groups_table", "users_table",
             "sds_table")
# the capture thread's signals emitted inside process_block (the Pipeline's
# callbacks); stats_update and status_update are emitted between blocks
UI_SIGNALS = ("frame_decoded", "spectrum_update", "voice_audio", "raw_audio")
# each example and the hand kernels its path launches on the card.
# wideband_scan's capture (71 ms) is shorter than one FFT block, so the
# scanner takes the conv bank, plain torch on the card; voice_roundtrip's
# blocks of 32,000 samples (13.3 ms) hold at most one voice slot, whose
# channel decoding is the host's one-candidate path (V1 launches for two
# or more)
EXAMPLES = {"decode_capture": ("frame_scan_even",),
            "offair_fixture": ("frame_scan_even", "tea_search"),
            "dense_fleet": FUSED_KERNELS + ("tea_search",),
            "wideband_scan": (),
            "voice_roundtrip": ("frame_scan_even", "acelp_decode"),
            "sharded_deployment": ("band_extract", "acelp_decode",
                                   "tea_search")}


def ui_qt():
    """The port's ui.qt imported over tests/unit/qt_stub.py, installed as
    PyQt6 (the GPU machine has no PyQt6; the stub's QThread.start does
    nothing, so the capture thread's run is driven here)."""
    import importlib
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_qt_stub", ROOT / "tests" / "unit" / "qt_stub.py")
    stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stub)
    stub.install()
    sys.modules.pop("tetraear_tpu_torch.ui.qt", None)
    qt = importlib.import_module("tetraear_tpu_torch.ui.qt")
    if not qt.QT_AVAILABLE:
        fail("ui: the port's ui.qt does not see the PyQt6 stub")
    return qt


def on_worker(fn, what: str) -> float:
    """fn() on a threading.Thread of its own; fails if it raises or hangs.
    Returns its wall seconds (the card synchronised after)."""
    import threading
    errors = []

    def body():
        try:
            fn()
        except BaseException as e:      # raised again by fail() below
            errors.append(repr(e))
    t0 = time.perf_counter()
    worker = threading.Thread(target=body, name=f"chip_smoke {what}")
    worker.start()
    worker.join(900)
    if worker.is_alive():
        fail(f"{what}: the worker thread did not finish in 900 s")
    sync()
    if errors:
        fail(f"{what}: the worker thread raised {errors[0]}")
    return time.perf_counter() - t0


class BlockTimer:
    """Pipeline.process_block wrapped while it is active: the host wall
    time of each call (a call returns the block's frames on the host, so
    it ends after the card's work for the block)."""

    def __enter__(self):
        from tetraear_tpu_torch import api
        self.ms, self._real = [], api.Pipeline.process_block
        real = self._real

        def timed(pipe, block):
            t0 = time.perf_counter()
            out = real(pipe, block)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out
        api.Pipeline.process_block = timed
        return self

    def __exit__(self, *exc):
        from tetraear_tpu_torch import api
        api.Pipeline.process_block = self._real

    def summary(self) -> dict:
        rest = sorted(self.ms[1:]) or [float("nan")]
        return {"blocks": len(self.ms), "first_ms": self.ms[0],
                "median_ms": rest[len(rest) // 2],
                "mean_ms": sum(rest) / len(rest), "max_ms": rest[-1],
                "signal_ms": UI_BLOCK / FS_RTL * 1e3}


def ui_tables(win) -> dict:
    return {name: [[None if item is None else item.text() for item in row]
                   for row in getattr(win, name)._rows]
            for name in UI_TABLES}


def wav_pcm(path: Path) -> list:
    import wave
    with wave.open(str(path)) as wf:
        return [wf.getframerate(),
                wf.readframes(wf.getnframes())]


def gui_run(qt, run: str, device: str, capture: Path, d: Path, voice: bool,
            fresh_build: bool = False) -> dict:
    """ModernTetraGUI's START path as a user takes it: the window built
    (on the card by default), its source (on_start opens "rtlsdr")
    redirected to the capture, on_start run so that its own signal
    wiring is made, then the capture thread's run on a threading.Thread
    and its finished signal as QThread emits it.  REC and raw FM are on
    for the voice capture.  With ``fresh_build`` the kernel library is
    compiled anew, into a directory of its own, by whichever thread
    first needs it (the capture thread), and the earlier one is restored
    after.  Launch counts are set to 0 just before the thread starts and
    read just after."""
    import threading
    import numpy as np
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.runtime import sources
    from tetraear_tpu_torch.utils.settings import SettingsManager
    records = d / f"records_{run}"
    records.mkdir(parents=True)
    settings = SettingsManager(d / f"settings_{run}.json")
    settings.set("records_dir", str(records))
    win = qt.ModernTetraGUI(settings=settings,
                            **({} if device == "cuda" else {"device": "cpu"}))
    opened, real_open = [], sources.open_source

    def open_capture(spec, sample_rate=FS_RTL, frequency=392.5e6,
                     gain="auto"):
        opened.append(spec)
        return sources.FileIQSource(capture, sample_rate=sample_rate,
                                    frequency=frequency)
    saved = (ck._lib, ck.BUILD_DIR, dict(ck.build_info),
             ck._compile_and_load)
    built_by = []

    def compile_and_load():
        built_by.append(threading.current_thread().name)
        return saved[3]()
    got = {"frames": [], "status": [], "audio": [], "raw": [], "stats": 0}
    sources.open_source = open_capture
    try:
        if fresh_build:
            ck._lib, ck.BUILD_DIR = None, d / "kernels"
            ck._compile_and_load = compile_and_load
        if voice:
            win.rawfm_chk.setChecked(True)
            win.rec_btn.setChecked(True)
        win.on_start()
        th = win.thread
        if opened != ["rtlsdr"] or th is None:
            fail(f"ui gui {run}: on_start opened {opened}")
        t_first = []

        def frame(f):
            if not got["frames"]:
                t_first.append(time.perf_counter())
            got["frames"].append(tuple(f.get(k) for k in UI_FRAME_KEYS))

        def stats(_s):
            got["stats"] += 1
        th.frame_decoded.connect(frame)
        th.status_update.connect(got["status"].append)
        th.voice_audio.connect(
            lambda a: got["audio"].append(np.asarray(a).copy()))
        th.raw_audio.connect(
            lambda a: got["raw"].append(np.asarray(a).copy()))
        th.stats_update.connect(stats)
        # the stub's signals call their slots in the emitting thread, so
        # the window's slots (tables, waterfall, recorders) run inside
        # process_block here; each signal's emits are timed apart (a
        # Pipeline takes the bound emit when the capture thread makes it)
        slot_ms = {}
        for sig_name in UI_SIGNALS:
            sig = getattr(th, sig_name)

            def emit(*a, real=sig.emit, sig_name=sig_name):
                t0 = time.perf_counter()
                real(*a)
                slot_ms[sig_name] = (slot_ms.get(sig_name, 0.0)
                                     + (time.perf_counter() - t0) * 1e3)
            sig.emit = emit
        ck.reset_launches()
        with BlockTimer() as timer:
            t0 = time.perf_counter()
            wall = on_worker(th.run, f"ui gui {run}")
        got["launches"] = dict(ck.launches)
        th.finished.emit()
        if win.thread is not None or win.status.text() != "stopped":
            fail(f"ui gui {run}: the window did not see its thread finish")
        if voice:
            win.rec_btn.setChecked(False)
        if fresh_build:
            got["build_s"] = ck.build_info.get("seconds")
    finally:
        sources.open_source = real_open
        if fresh_build:
            ck._lib, ck.BUILD_DIR = saved[0], saved[1]
            ck.build_info.clear()
            ck.build_info.update(saved[2])
            ck._compile_and_load = saved[3]
    got.update(
        slot_ms=slot_ms, timer_ms=list(timer.ms),
        tables=ui_tables(win), wall_s=wall, blocks=timer.summary(),
        first_frame_s=(t_first[0] - t0) if t_first else None,
        rec=[wav_pcm(p) for p in sorted(records.glob("rec_*.wav"))],
        rawfm=[wav_pcm(p) for p in sorted(records.glob("rawfm_*.wav"))],
        built_by=built_by)
    errors = [s for s in got["status"] if str(s).startswith("error:")]
    if errors:
        fail(f"ui gui {run}: the capture thread reported {errors}")
    if fresh_build and DEV != "cpu" and (
            len(built_by) != 1 or not built_by[0].startswith("chip_smoke")):
        fail(f"ui gui {run}: the kernel library was built by {built_by}, "
             f"not once by the capture thread")
    return got


def same_pcm(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.tobytes() == y.tobytes()
        for x, y in zip(a, b))


def gui_pair(qt, name: str, capture: Path, d: Path, voice: bool,
             need: tuple, fresh_build: bool = False) -> dict:
    """gui_run on the card and with device="cpu"; fails unless frames,
    table cells, the PCM given to recorder.feed and raw_audio, and the
    REC / raw FM WAVs' PCM are equal, and each kernel in ``need`` was
    launched on the card."""
    card = gui_run(qt, f"{name}_card", DEV, capture, d, voice, fresh_build)
    cpu = gui_run(qt, f"{name}_cpu", "cpu", capture, d, voice)
    what = f"ui gui {name}"
    if not card["frames"] or card["frames"] != cpu["frames"]:
        fail(f"{what}: the card's {len(card['frames'])} frames differ from "
             f"the CPU run's {len(cpu['frames'])}")
    if card["tables"] != cpu["tables"]:
        diff = [t for t in UI_TABLES if card["tables"][t] != cpu["tables"][t]]
        fail(f"{what}: table cells differ from the CPU run's in {diff}")
    for k in ("audio", "raw"):
        if not same_pcm(card[k], cpu[k]):
            fail(f"{what}: {k} PCM differs from the CPU run's "
                 f"({len(card[k])} / {len(cpu[k])} chunks)")
    if card["rec"] != cpu["rec"] or card["rawfm"] != cpu["rawfm"]:
        fail(f"{what}: the REC / raw FM WAVs' PCM differs from the CPU run's")
    if voice and not (card["audio"] and card["raw"] and card["rec"]
                      and card["rawfm"]):
        fail(f"{what}: no voice PCM, raw FM audio or WAV")
    need_launched(what, card["launches"], need)
    b = card["blocks"]
    used = {k: v for k, v in card["launches"].items() if v}
    slots = {k: v / max(b["blocks"], 1) for k, v in card["slot_ms"].items()}
    say(f"{what}: the window's slots inside process_block, ms a block: "
        + ", ".join(f"{k} {v:.2f}" for k, v in slots.items())
        + f" ({sum(slots.values()):.2f} of process_block's "
        f"{sum(card['timer_ms']) / max(b['blocks'], 1):.2f}, the first "
        f"block included; CPU run "
        + ", ".join(f"{k} {v / max(b['blocks'], 1):.2f}"
                    for k, v in cpu["slot_ms"].items()) + ")")
    rows = ", ".join(f"{t[:-6]} {len(card['tables'][t])}" for t in UI_TABLES)
    say(f"{what}: {len(card['frames'])} frames, table cells ({rows} "
        f"rows), {sum(len(a) for a in card['audio'])} voice samples, "
        f"{sum(len(a) for a in card['raw'])} raw FM samples equal to the "
        f"CPU run; no error status; process_block in the capture thread "
        f"{b['median_ms']:.2f} ms median ({b['mean_ms']:.2f} mean, "
        f"{b['max_ms']:.2f} max, first {b['first_ms']:.1f}) a block of "
        f"{b['signal_ms']:.1f} ms signal over {b['blocks']} blocks; first "
        f"frame {card['first_frame_s']:.2f} s after the thread started"
        + (f" (the kernel library built in the capture thread, "
           f"{card['build_s']:.1f} s)" if card.get("build_s") else "")
        + f"; CPU run {cpu['blocks']['median_ms']:.1f} ms a block; "
        f"launches {used}")
    return {"frames": len(card["frames"]), "blocks": b,
            "slot_ms_per_block": slots,
            "cpu_blocks": cpu["blocks"], "first_frame_s":
            card["first_frame_s"], "wall_s": card["wall_s"],
            "cpu_wall_s": cpu["wall_s"], "build_in_thread_s":
            card.get("build_s"), "built_by": card["built_by"],
            "launches": card["launches"]}


def dashboard_run(device: str, n_blocks: int) -> dict:
    """The curses dashboard with a stub screen (tests/unit/test_ui.py's)
    over the synthetic voice source, its Pipeline built and run on a
    worker thread; then 20 draws timed with the 15 FPS cap lifted."""
    import numpy as np
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.runtime.sources import open_source
    from tetraear_tpu_torch.ui.dashboard import Dashboard

    class StubScr:
        def nodelay(self, *_):
            pass

        def getmaxyx(self):
            return (24, 80)

        def erase(self):
            pass

        def addnstr(self, *a, **k):
            pass

        def refresh(self):
            pass

        def getch(self):
            return -1
    out = {"audio": []}

    def body():
        pipe = Pipeline(PipelineConfig(sample_rate=FS_RTL, detect_gate=False,
                                       device=device))
        pipe.on_audio = lambda a: out["audio"].append(np.asarray(a).copy())
        src = open_source("synthetic-voice", sample_rate=FS_RTL)
        dash = Dashboard(StubScr(), pipe, src, "chip_smoke")
        dash.last_draw = -1e9
        dash.run(max_blocks=n_blocks)
        out["dash"], out["pipe"] = dash, pipe
    ck.reset_launches()
    with BlockTimer() as timer:
        wall = on_worker(body, f"ui dashboard on {device}")
    launches = dict(ck.launches)
    dash = out["dash"]
    draws = []
    for _ in range(20):
        dash.last_draw = -1e9
        t0 = time.perf_counter()
        dash.draw()
        draws.append((time.perf_counter() - t0) * 1e3)
    return {"frames": [tuple(f.get(k) for k in UI_FRAME_KEYS)
                       for f in dash.frames],
            "row": dash._spectrum_row(40), "audio": out["audio"],
            "voice_frames": out["pipe"].stats.voice_frames,
            "launches": launches, "wall_s": wall, "blocks": timer.summary(),
            "draw_ms": sorted(draws)[len(draws) // 2]}


def phase_ui(seed: int) -> dict:
    """The UI on the card at its users' size (2.4 Msps, blocks of 130,800
    samples): the Qt window's START path with its capture thread on a
    worker thread, over (a) the tools' 24-slot SDS capture (TEA1 and TEA2
    in turn under common keys, auto-decrypt on: frame_scan_even,
    tea_search; the kernel library built anew in that thread) and (b) a
    finite capture of the synthetic voice source (device synthesis on by
    default: viterbi_decode, acelp_decode), each against device="cpu";
    then the dashboard over the synthetic voice source on a worker
    thread, against the CPU."""
    import tempfile
    from tetraear_tpu_torch.runtime.sources import open_source, write_capture
    qt = ui_qt()
    res = {}
    env_before = os.environ.get("TETRAEAR_TPU_DATA_DIR")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ui_") as tmp:
        d = Path(tmp)
        os.environ["TETRAEAR_TPU_DATA_DIR"] = str(d / "data")
        try:
            sds = d / "sds.cfile"
            tools_capture(sds, seed, 8 if REHEARSE else TOOL_SLOTS)
            voice = d / "voice.cfile"
            n_voice = 2 if REHEARSE else UI_VOICE_BLOCKS
            with open_source("synthetic-voice", sample_rate=FS_RTL) as src:
                write_capture(voice, src.read_samples(n_voice * UI_BLOCK))
            res["gui_sds"] = gui_pair(
                qt, "sds", sds, d, False,
                ("frame_scan_even", "tea_search"), fresh_build=not REHEARSE)
            res["gui_voice"] = gui_pair(
                qt, "voice", voice, d, True,
                ("frame_scan_even", "viterbi_decode", "acelp_decode"))
        finally:
            if env_before is None:
                os.environ.pop("TETRAEAR_TPU_DATA_DIR", None)
            else:
                os.environ["TETRAEAR_TPU_DATA_DIR"] = env_before
    n = 2 if REHEARSE else UI_DASH_BLOCKS
    card, cpu = dashboard_run(DEV, n), dashboard_run("cpu", n)
    if (not card["frames"] or card["frames"] != cpu["frames"]
            or card["row"] != cpu["row"]
            or not same_pcm(card["audio"], cpu["audio"])
            or card["voice_frames"] != cpu["voice_frames"]):
        fail(f"ui dashboard: the card's frames ({len(card['frames'])}), "
             f"spectrum row or voice PCM ({card['voice_frames']} voice "
             f"frames) differ from the CPU run's ({len(cpu['frames'])}, "
             f"{cpu['voice_frames']})")
    need_launched("ui dashboard", card["launches"],
                  ("frame_scan_even", "viterbi_decode", "acelp_decode"))
    b = card["blocks"]
    say(f"ui dashboard: {n} blocks of the synthetic voice source on a "
        f"worker thread, {len(card['frames'])} frames, "
        f"{card['voice_frames']} voice frames, spectrum row and PCM equal "
        f"to the CPU run; process_block {b['median_ms']:.2f} ms median "
        f"(first {b['first_ms']:.1f}) a block of {b['signal_ms']:.1f} ms; "
        f"a draw {card['draw_ms']:.3f} ms; launches "
        f"{ {k: v for k, v in card['launches'].items() if v} }")
    res["dashboard"] = {k: card[k] for k in ("launches", "wall_s", "blocks",
                                             "draw_ms", "voice_frames")}
    res["dashboard"]["frames"] = len(card["frames"])
    res["dashboard"]["cpu_blocks"] = cpu["blocks"]
    return res


def example_run(name: str, device: str, out_dir: Path) -> tuple:
    """An example's main as ``python -m`` calls it, on the card (no
    --device) or with --device cpu; (rc, stdout, launches, seconds)."""
    import contextlib
    import importlib
    import io
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    mod = importlib.import_module(f"tetraear_tpu_torch.examples.{name}")
    argv = [str(out_dir / "roundtrip.wav")] if name == "voice_roundtrip" \
        else []
    if device == "cpu":
        argv += ["--device", "cpu"]
    buf = io.StringIO()
    if device != "cpu":
        import torch
        torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    sync()
    seconds = time.perf_counter() - t0
    if device != "cpu" and torch.cuda.max_memory_allocated() == 0:
        fail(f"examples {name}: nothing was allocated on the card")
    # the sharded example names its device
    out = re.sub(r"mesh entries on \w+", "mesh entries on <device>",
                 buf.getvalue())
    return rc, out, dict(ck.launches), seconds


def phase_examples() -> dict:
    """Each of the port's examples on the card and with --device cpu:
    both exit 0 with the same output (decoded lines, per-carrier counts
    and texts, decryptions, scan table, sync hits, scores), the voice
    round trip's WAV PCM equal; each card run launches kernels."""
    import tempfile
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        for name in EXAMPLES:
            runs = {}
            for run, device in (("card", DEV), ("cpu", "cpu")):
                out_dir = Path(tmp) / f"{name}_{run}"
                out_dir.mkdir()
                runs[run] = example_run(name, device, out_dir)
                if runs[run][0] != 0:
                    fail(f"examples {name} on {device}: exit "
                         f"{runs[run][0]}:\n{runs[run][1][-1500:]}")
            if runs["card"][1] != runs["cpu"][1]:
                fail(f"examples {name}: the card's output differs from the "
                     f"CPU run's:\n{runs['card'][1][-1500:]}\n--- cpu ---\n"
                     f"{runs['cpu'][1][-1500:]}")
            if name == "voice_roundtrip":
                pcm = [wav_pcm(Path(tmp) / f"{name}_{run}" / "roundtrip.wav")
                       for run in ("card", "cpu")]
                if pcm[0] != pcm[1] or len(pcm[0][1]) < 2 * 2880:
                    fail("examples voice_roundtrip: the card's WAV differs "
                         "from the CPU run's")
            launches = {k: v for k, v in runs["card"][2].items() if v}
            need_launched(f"examples {name}", runs["card"][2],
                          EXAMPLES[name])
            last = runs["card"][1].strip().splitlines()[-1]
            say(f"examples {name}: equal to the CPU run, {runs['card'][3]:.2f}"
                f" s on the card ({runs['cpu'][3]:.2f} s on the CPU); "
                f"launches {launches}; last line: {last[:120]}")
            res[name] = {"card_s": runs["card"][3], "cpu_s": runs["cpu"][3],
                         "launches": runs["card"][2]}
    return res


# ---------------------------------------------------------------------------
# bench: the port's benchmark (tetraear_tpu_torch/bench.py) as its users
# run it, and its chains on the kernels against the plain versions
# ---------------------------------------------------------------------------

# (name, environment of `python -m tetraear_tpu_torch bench`, e2e
# variant); the default run sets nothing: C=20480, both modes
# C=1024's steps take about 2 ms (e2e) to 4 ms (voice): 500 of them make a
# timed window of a second or more, where 20 made one of 40-90 ms
BENCH_RUNS = (
    ("c1024", {"BENCH_CARRIERS": "1024", "BENCH_STEPS": "500"}, "fused"),
    ("c10240", {"BENCH_CARRIERS": "10240"}, "fused"),
    ("c20480", {}, "fused"),
    ("c40960", {"BENCH_CARRIERS": "40960", "BENCH_MODE": "e2e"}, "fused"),
    ("c1024_classic", {"BENCH_CARRIERS": "1024", "BENCH_STEPS": "500",
                       "BENCH_MODE": "e2e", "BENCH_NO_FUSED": "1"},
     "classic"),
)
BENCH_VOICE_KERNELS = ("viterbi_decode", "acelp_decode")


@contextlib.contextmanager
def plain_route():
    """Every kernel wrapper runs its plain PyTorch version, on the card's
    tensors too: cuda_kernels._route, which each wrapper asks, answers
    "cpu" after its own device checks."""
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    real = ck._route

    def route(*tensors):
        real(*tensors)
        return "cpu"

    ck._route = route
    try:
        yield
    finally:
        ck._route = real


def bench_run(name: str, env: dict, variant: str, card: str) -> dict:
    """``python -m tetraear_tpu_torch bench`` with ``env`` (every other
    BENCH_* unset) in its own process: exit 0, a last line that parses,
    no ``degraded``, rt_factor > 0 and the expected e2e variant."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    full.update(env)
    if DEV == "cpu":
        full.update(BENCH_CARRIERS="8", BENCH_STEPS="2")
    argv = [sys.executable, "-m", "tetraear_tpu_torch", "bench"]
    if DEV == "cpu":
        argv += ["--device", "cpu"]
    t0 = time.time()
    r = subprocess.run(argv, cwd=ROOT, env=full, capture_output=True,
                       text=True, timeout=900)
    wall = time.time() - t0
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines:
        fail(f"bench {name}: exit {r.returncode}\n{r.stdout[-1500:]}\n"
             f"{r.stderr[-3000:]}")
    try:
        line = json.loads(lines[-1])
    except json.JSONDecodeError:
        fail(f"bench {name}: the last line does not parse: {lines[-1]!r}")
    if "degraded" in line:
        fail(f"bench {name}: degraded: {line['degraded']}")
    if not line.get("rt_factor", 0) > 0:
        fail(f"bench {name}: rt_factor {line.get('rt_factor')}")
    if line.get("e2e_variant") != variant:
        fail(f"bench {name}: e2e_variant {line.get('e2e_variant')}, "
             f"expected {variant}")
    err = [s for s in r.stderr.splitlines() if s.startswith("# backend=")]
    say(f"bench {name} ({card}; env {env or 'none'}, BENCH_STEPS "
        f"{full.get('BENCH_STEPS', '20')}): {wall:.1f} s; {lines[-1]}")
    if err:
        say(f"  {err[-1]}")
    return {"env": env, "line": line, "wall_s": wall,
            "summary": err[-1] if err else None}


def bench_chains(c: int, steps: int, chains: tuple) -> dict:
    """The bench's chains at C = c on its noise block, ``steps`` steps on
    the kernels and again on the plain versions: nhit, nok and pacc
    equal, the voice chain's last PCM bit-equal, no launch on the plain
    route; launches a step of each chain on the kernels.  The voice
    chain's kernels are then held one by one on the same inputs
    (bench_stages)."""
    import torch
    from tetraear_tpu_torch import bench
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp.backhalf import TAILBITS, try_fused
    from tetraear_tpu_torch.voice import speech
    bank, _ = bench.make_bank(c, device=DEV)
    fused, reason = try_fused(bank, DEV)
    if fused is None:
        fail(f"bench C={c}: the fused path refused the bank ({reason})")
    x_r, x_p = bench.noise_block(bank.block_len, DEV)
    runs = {
        "e2e": lambda: bench.chain_e2e_fused(fused, x_p, fused.init_state(),
                                             steps),
        "classic": lambda: bench.chain_e2e(
            bank, x_r, bank.init_state(DEV),
            torch.zeros((c, TAILBITS), dtype=torch.uint8, device=DEV),
            steps),
        "demod": lambda: bench.chain_demod(bank, x_r, bank.init_state(DEV),
                                           steps),
        "voice": lambda: bench.chain_voice(
            fused, x_p, fused.init_state(), speech.init_state(c, DEV),
            steps),
    }
    out = {}
    for name in chains:
        ck.reset_launches()
        got = runs[name]()
        sync()
        launches = {k: v / steps for k, v in ck.launches.items() if v}
        with plain_route():
            ck.reset_launches()
            want = runs[name]()
            sync()
            if any(ck.launches.values()):
                fail(f"bench C={c} {name}: the plain route launched "
                     f"{ {k: v for k, v in ck.launches.items() if v} }")
        keys = [k for k in ("nhit", "nok", "pacc") if k in got]
        vals = {k: (int(got[k].item()), int(want[k].item())) for k in keys}
        if name == "demod":
            vals["tails"] = (got["tails"].cpu().tolist(),
                             want["tails"].cpu().tolist())
        bad = {k: v for k, v in vals.items() if v[0] != v[1]}
        if bad:
            fail(f"bench C={c} {name}: kernels differ from the plain "
                 f"versions: {bad}")
        if name == "voice" and not torch.equal(got["pcm"], want["pcm"]):
            n = int((got["pcm"] != want["pcm"]).sum().item())
            fail(f"bench C={c} voice: PCM differs from the plain versions' "
                 f"at {n} samples")
        shown = {k: v[0] for k, v in vals.items() if k != "tails"}
        if name == "voice":
            # upstream float differences within fft2p's and band_synth's
            # tolerances reach the rounded soft bits; shown, not judged
            shown["soft_bits_differing"] = int(
                (got["soft_batch"] != want["soft_batch"]).sum().item())
        say(f"bench C={c} {name}: {steps} steps on the kernels equal to the "
            f"plain versions {shown}; launches a step {launches}")
        out[name] = {"counters": shown, "launches_per_step": launches}
        del got, want
        if name == "voice":
            out[name]["stages"] = bench_stages(fused, x_p)
    del bank, fused, x_r, x_p, runs
    if DEV != "cpu":
        torch.cuda.empty_cache()
    return out


def bench_stages(fused, x_p) -> dict:
    """The voice chain's first step on the bench's noise block, each
    kernel on the same inputs as its plain version, with phase_kernels'
    tolerances: fft2p on the block's window (1e-4 of the RMS),
    band_synth on its planes (y 1e-5 of the RMS, the phasor 2e-5 of the
    band power), fused_backhalf on the glue's arguments (corr, crc_err
    and the bit tail exact, the soft planes and the rest 1e-6),
    viterbi_decode on the step's (2C, 432) soft batch and acelp_decode on
    its (C, 4) frames from the initial decoder state, and both again at
    the same shapes on the speech phases' inputs (bit-equal)."""
    import torch
    from tetraear_tpu_torch import bench
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    from tetraear_tpu_torch.dsp.backhalf import TWO_PI
    from tetraear_tpu_torch.voice import speech, viterbi
    c = fused.bank.n_carriers
    ch = fused.ch
    state = fused.init_state()
    cst = state["bank"]["channelizer"]
    res = {}

    def check(name, err, tol):
        res[name] = {"max_abs_err": err, "tol": tol}
        if not err <= tol:
            fail(f"bench C={c} voice stages: {name} differs from its plain "
                 f"version on the same inputs by {err:.3e} (tol {tol:.3e})")

    args1 = fused.fft2p_args(x_p, cst)
    planes = ck.fft2p_planes_spliced(*args1)
    err, rms = max_err(planes, ck.fft2p_plain(*args1))
    check("fft2p", err, 1e-4 * rms)
    args2 = (planes, fused.h1_planes, fused.row_start, fused.d_shift,
             fused.m1c, fused.m2re, fused.m2im, fused.twre, fused.twim,
             ch.synth_rows, ch.drop)
    y, ph = ck.band_synth(*args2)
    y_p, ph_p = ck.band_synth_plain(*args2)
    err, rms = max_err(y, y_p)
    check("band_synth y", err, 1e-5 * rms)
    band_power = y_p.double().pow(2).sum(dim=(1, 2, 3)).max().item()
    check("band_synth phasor", max_err(ph, ph_p)[0], 2e-5 * band_power)
    del planes, args1, args2, y_p, ph_p
    ang = cst["cycles"] * TWO_PI / float(ch.nfft)
    g = fused.glue(ph, (torch.cos(ang), -torch.sin(ang)), state)
    args3 = fused.backhalf_args(y, g, state)
    out_k = ck.fused_backhalf(*args3)
    out_p = ck.fused_backhalf_plain(*args3, ck.z_rows_for(fused.p))
    for name, a, b in zip(("corr", "err", "soft", "bt2", "last", "misc"),
                          out_k, out_p):
        check(f"fused_backhalf {name}", max_err(a, b)[0],
              0.0 if name in ("corr", "err", "bt2") else 1e-6)
    del y, args3, out_p
    def v1(sb, what):
        ordered, bfi = viterbi.decode(sb)
        o_p, b_p = viterbi.decode_plain(sb)
        if not (torch.equal(ordered, o_p) and torch.equal(bfi, b_p)):
            fail(f"bench C={c} voice stages: viterbi_decode at B={2 * c} "
                 f"({what}) differs from its plain version in "
                 f"{int((ordered != o_p).sum())} bits, "
                 f"{int((bfi != b_p).sum())} BFI")
        return ordered, bfi

    def v2(state_fn, frames, valid, what):
        st_k, pcm_k = speech.decode_block(state_fn(), frames, valid)
        with plain_route():
            st_p, pcm_p = speech.decode_block(state_fn(), frames, valid)
        same = all(torch.equal(a, b) for a, b in zip(st_k, st_p))
        if not (torch.equal(pcm_k, pcm_p) and same):
            fail(f"bench C={c} voice stages: acelp_decode at S={c} x 4 "
                 f"({what}) differs from its plain version in "
                 f"{int((pcm_k != pcm_p).sum())} samples (state equal: "
                 f"{same})")

    # the step's own batch (noise: nearly every block fails its CRC, so
    # V2 conceals), then V1's and V2's phase inputs at the same shapes
    # (coded blocks under noise; speech frames with their corners)
    ordered, bfi = v1(bench.voice_batch(fused, out_k[2]), "the step's")
    n_bfi = int(bfi.sum())
    v2(lambda: speech.init_state(c, DEV),
       bench.voice_frames(ordered, bfi, bench.unbuild_index(x_p.device)),
       torch.ones((c, 4), dtype=torch.bool, device=x_p.device), "the step's")
    _, bfi = v1(torch.from_numpy(viterbi_inputs(2 * c, 43)).to(DEV),
                "coded blocks")
    fr, vd = speech_inputs(c, 4, 47)
    v2(lambda: speech_state(c), torch.from_numpy(fr).to(DEV),
       torch.from_numpy(vd).to(DEV), "speech frames")
    res["viterbi_decode"] = {"B": 2 * c, "bfi_step": n_bfi,
                             "bfi_coded": int(bfi.sum())}
    res["acelp_decode"] = {"S": c, "frames": 4 * c,
                           "bfi_speech": int(fr[:, :, 0].sum())}
    say(f"bench C={c} voice stages on the same inputs: "
        + ", ".join(f"{k} {v['max_abs_err']:.3e} (tol {v['tol']:.3e})"
                    for k, v in res.items() if "tol" in v)
        + f"; viterbi_decode B={2 * c} on the step's batch ({n_bfi} BFI) "
          f"and on coded blocks ({res['viterbi_decode']['bfi_coded']} BFI), "
          f"acelp_decode S={c} x 4 on the step's frames and on speech "
          f"frames ({res['acelp_decode']['bfi_speech']} BFI): bit-equal")
    return res


def bench_launch_check(per: dict) -> None:
    """A fused step launches each fused kernel once; the voice chain adds
    V1 and V2 once; the classic step band_synth_y and frame_scan_even
    once; the demod step band_synth_y once; no extraction kernel."""
    if DEV == "cpu":
        return
    fused = {k: 1.0 for k in FUSED_KERNELS}
    want = {"e2e": fused,
            "voice": {**fused, **{k: 1.0 for k in BENCH_VOICE_KERNELS}},
            "classic": {"band_synth_y": 1.0, "frame_scan_even": 1.0},
            "demod": {"band_synth_y": 1.0}}
    for name, r in per.items():
        if r["launches_per_step"] != want[name]:
            fail(f"bench {name}: launches a step {r['launches_per_step']}, "
                 f"expected {want[name]}")


def phase_bench(card: str) -> dict:
    """The port's bench as a user runs it (BENCH_RUNS, each in its own
    process), then in process: every chain at C=1024, one step of the
    fused and the voice chain at C=20480 (the default run's shapes: V1 at
    B=40960, V2 at S=20480, nfft 2^26) and one fused step at C=40960 (the
    nfft cap) on the kernels against the plain versions, launches a step,
    and the Profiler's busy share of the e2e and voice chains at C=1024
    and C=20480."""
    import torch
    from tetraear_tpu_torch import bench
    from tetraear_tpu_torch.voice import speech
    if DEV != "cpu":
        torch.cuda.empty_cache()
    res = {"runs": {}}
    t0 = time.time()
    for name, env, variant in BENCH_RUNS:
        res["runs"][name] = bench_run(name, env, variant, card)
    small, big = (8, 8) if REHEARSE else (1024, 20480)
    res["chains_c1024"] = bench_chains(small, 2, ("e2e", "classic", "demod",
                                                  "voice"))
    bench_launch_check(res["chains_c1024"])
    res["chains_c20480"] = bench_chains(big, 1, ("e2e", "voice"))
    bench_launch_check(res["chains_c20480"])
    # the nfft cap: half-size blocks of 2^26 where choose_nfft says 2^27
    res["chains_c40960"] = bench_chains(8 if REHEARSE else 40960, 1,
                                        ("e2e",))
    bench_launch_check(res["chains_c40960"])
    if DEV != "cpu":
        res["profile"] = {}
        out_dir = ROOT / "build" / "bench_profile"
        for c in (small, big):
            b, _ = bench.make_bank(c, device=DEV)
            fused, _ = bench.backhalf.try_fused(b, DEV)
            _, x_p = bench.noise_block(b.block_len, DEV)
            box = {"e2e": [fused.init_state()],
                   "voice": [fused.init_state(), speech.init_state(c, DEV)]}

            def e2e(n, box=box["e2e"], fused=fused, x_p=x_p):
                o = bench.chain_e2e_fused(fused, x_p, box[0], n)
                box[0] = o["state"]
                o["nhit"].item()

            def voice(n, box=box["voice"], fused=fused, x_p=x_p):
                o = bench.chain_voice(fused, x_p, box[0], box[1], n)
                box[0], box[1] = o["state"], o["sstate"]
                o["pacc"].item()

            for name, run in (("e2e", e2e), ("voice", voice)):
                profile_chain(f"bench_{name}_C{c}", run, 5, out_dir)
                rep = json.loads((out_dir / f"profile_bench_{name}_C{c}"
                                  ".json").read_text())
                res["profile"][f"{name}_C{c}"] = {
                    k: rep[k] for k in ("wall_ms_per_block",
                                        "device_busy_ms_per_block",
                                        "idle_share_of_span",
                                        "launches_per_block")}
            del b, fused, x_p, box
            torch.cuda.empty_cache()
    res["seconds"] = time.time() - t0
    say(f"bench: phase done in {res['seconds']:.0f} s")
    return res


def phase_profiling(card: str, chains: dict, sp: dict, c: int,
                    c_big: int, nfft: int | None) -> dict:
    """runtime/profiling on the card: measure_hbm_gbs at 1 GiB (and 4
    GiB), kept as this card's rate; roofline_fraction of the fused chain
    steps' measured rt_factor at C=1024 and C=10240 against the H100's
    peaks and that rate; voice_roofline at the rate the speech phase
    measured acelp_decode to retire the ETSI basic operations; and the
    Profiler around one fused chained step at C=1024, whose trace must
    name fft2p, band_synth and fused_backhalf."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import framescan
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.runtime import profiling
    res = {}
    mbs = (8, 32) if REHEARSE else (1024, 4096)
    gbs = {mb: profiling.measure_hbm_gbs(DEV, mb=mb) for mb in mbs}
    res["hbm_gbs"] = {str(mb): v for mb, v in gbs.items()}
    if DEV != "cpu":
        key = profiling.card_key() or card
        res["hbm_record"] = str(profiling.record_hbm_gbs(
            gbs[1024], 1024, 16, key))
    say(f"profiling measure_hbm_gbs on {card}: "
        + ", ".join(f"{v:.1f} GB/s at {mb} MiB" for mb, v in gbs.items())
        + f" ({100 * gbs[mbs[0]] * 1e9 / profiling.HBM_BYTES_PER_S:.1f}% of "
          f"the {profiling.HBM_BYTES_PER_S / 1e12:.2f} TB/s datasheet rate "
          f"at {mbs[0]} MiB)")
    if REHEARSE:
        os.environ["TETRAEAR_MEASURED_GBS"] = str(gbs[mbs[0]])
    try:
        roof = {}
        for name, fs, n in (("c1024", FS_FLEET, c),
                            ("c10240", FS_BENCH, c_big)):
            rt = chains[name]["rt_factor"]
            r = profiling.roofline_fraction(n, fs, rt, "fft")
            roof[name] = r
            say(f"profiling roofline_fraction {name} (fused chain, rt_factor "
                f"{rt:.3f}): roofline_pct {r['roofline_pct']:.3f}, "
                f"roofline_measured_pct {r['roofline_measured_pct']:.3f} "
                f"(against {r['measured_gbs']:.1f} GB/s, "
                f"{r['measured_gbs_source']}), bound {r['bound']}, achieved "
                f"{r['achieved_tflops']:.4f} TFLOP/s and "
                f"{r['achieved_gbs']:.2f} GB/s")
        res["roofline"] = roof
    finally:
        if REHEARSE:
            del os.environ["TETRAEAR_MEASURED_GBS"]
    s256 = sp[min(k for k in sp if isinstance(k, int))]
    eff = s256["etsi_ops"] / (s256["kernel_ms"] * 1e-3)
    vr = profiling.voice_roofline(1024, 0.1129, basicops_per_frame=s256[
        "etsi_ops_per_frame"], eff_ops_per_s=eff)
    res["voice_roofline"] = vr
    issue = vr["theoretical_int_issue_per_s"]
    say(f"profiling voice_roofline: acelp_decode retired {eff:.4g} ETSI "
        f"basic operations a second in this run (S={s256['slots']}, "
        f"{s256['etsi_ops_per_frame']:.0f} a frame; the module's default "
        f"{profiling.ACELP_EFF_OPS_PER_S:.3g}), "
        f"{vr['model_voice_carriers_rt']:.0f} voice carriers in real time "
        f"at 4 frames a carrier and block, {100 * eff / issue:.2f}% of the "
        f"integer issue rate {issue:.3g}/s")
    bank = CarrierBankDemod(fs=FS_FLEET, freqs_hz=grid(c), frontend="fft",
                            nfft=nfft)
    fused = FusedRx(bank, DEV)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, bank.block_len)).astype(np.float32)).to(DEV)
    state = fused.init_state()
    for _ in range(2):                               # warm-up
        out, state = fused.step(x, state)
    sync()
    with profiling.Profiler(ROOT / "profile_out" / "traces",
                            device=DEV) as prof:
        out, state = fused.step(x, state)
        keys, counts = framescan.sparse_hits(out["corr"], out["crc_err"])
        counts.sum().item()
    trace = json.loads(prof.trace_path.read_text())
    names = [ev.get("name", "") for ev in trace.get("traceEvents", [])
             if ev.get("cat") == "kernel"]
    found = {k: sum(k in n for n in names) for k in FUSED_KERNELS}
    if DEV != "cpu" and not all(found.values()):
        fail(f"profiling: the trace {prof.trace_path} lacks kernel events of "
             f"{[k for k, v in found.items() if not v]} "
             f"({len(names)} kernel events)")
    busy = sum(e - s for _, s, e in prof.kernel_events()) / 1e3
    res["trace"] = {"path": str(prof.trace_path.relative_to(ROOT)),
                    "kernel_events": len(names), "fused_kernels": found,
                    "device_busy_ms": busy}
    say(f"profiling Profiler: one fused step at C={c}, trace "
        f"{res['trace']['path']} ({len(names)} kernel events; "
        + ", ".join(f"{k} x{v}" for k, v in found.items())
        + f"; {busy:.3f} ms of device time)")
    return res


PROFILE_GROUPS = (
    ("hand-written kernels", ("band_synth_kernel", "frame_scan_kernel",
                              "fused_backhalf_kernel", "fft2p_pass",
                              "extract_rows_kernel", "extract_pairs_kernel",
                              "viterbi_kernel", "acelp_kernel",
                              "tea_kernel")),
    ("cuFFT", ("_fft", "fft_")),
    ("concat and copies", ("CatArray", "direct_copy", "Memcpy", "Memset")),
    ("gathers and indexing", ("gather", "index")),
    ("top-k", ("topk", "sort")),
    ("convolution", ("conv", "cudnn", "gemm", "cutlass", "implicit")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def profile_chain(name: str, run, n_blocks: int, out_dir: Path) -> None:
    """The port's Profiler (runtime/profiling.py: torch.profiler, a Chrome
    trace into out_dir/traces) over n_blocks chained steps after warm-up:
    device time by kernel name, launches per block, busy and idle
    share."""
    from tetraear_tpu_torch.runtime.profiling import Profiler
    run(3)
    sync()
    wall_ms = float("inf")
    for _ in range(2):                # the better of two timed passes
        t0 = time.time()
        run(n_blocks)
        sync()
        wall_ms = min(wall_ms, (time.time() - t0) / n_blocks * 1e3)
    with Profiler(out_dir / "traces", device=DEV) as prof:
        run(n_blocks)
    spans = []
    by_name: dict = {}
    for kname, start, end in prof.kernel_events():
        spans.append((start, end))
        tot, cnt = by_name.get(kname, (0.0, 0))
        by_name[kname] = (tot + end - start, cnt + 1)
    if not spans:
        fail(f"profile {name}: the profiler recorded no device time")
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    groups: dict = {}
    for kname, (tot, cnt) in by_name.items():
        grp = next((g for g, keys in PROFILE_GROUPS
                    if any(k in kname for k in keys)), "other")
        g_tot, g_cnt = groups.get(grp, (0.0, 0))
        groups[grp] = (g_tot + tot, g_cnt + cnt)
    report = {
        "name": name, "blocks": n_blocks, "wall_ms_per_block": wall_ms,
        "trace": str(prof.trace_path),
        "device_busy_ms_per_block": busy / 1e3 / n_blocks,
        "idle_share_of_span": 1.0 - busy / span,
        "launches_per_block": len(spans) / n_blocks,
        "by_group_ms_per_block": {
            g: {"ms": v[0] / 1e3 / n_blocks, "launches": v[1] / n_blocks}
            for g, v in sorted(groups.items(), key=lambda kv: -kv[1][0])},
        "by_kernel_ms_per_block": [
            {"kernel": k[:100], "ms": v[0] / 1e3 / n_blocks,
             "launches": v[1] / n_blocks} for k, v in rows[:25]]}
    (out_dir / f"profile_{name}.json").write_text(json.dumps(report,
                                                             indent=1))
    say(f"profile {name}: wall {wall_ms:.3f} ms/block unprofiled, device "
        f"busy {report['device_busy_ms_per_block']:.3f} ms/block, idle "
        f"{100 * report['idle_share_of_span']:.1f}% of the span, "
        f"{report['launches_per_block']:.0f} launches/block")
    say("  by group: " + ", ".join(
        f"{g} {v['ms']:.3f} ms x{v['launches']:.0f}"
        for g, v in report["by_group_ms_per_block"].items()))
    for row in report["by_kernel_ms_per_block"][:12]:
        say(f"  {row['ms']:.4f} ms x{row['launches']:.0f}  {row['kernel']}")


def main_profile(card: str, out_dir: Path) -> int:
    """Where the time goes: the classic chain at fleet-afc and bench-afc
    beside the fused chain and the sharded FFT step (a virtual (2, 2)
    mesh of the card, noise) at the same sizes."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import framescan
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.runtime.sharding import (ShardedFFTDemod,
                                                     make_mesh)
    out_dir.mkdir(parents=True, exist_ok=True)
    say(f"profile on {card}")
    for name, fs, c in (("fleet-afc", FS_FLEET, 1024),
                        ("bench-afc", FS_BENCH, 10240)):
        _, chain, state, tail = classic_chain(fs, c, None, 3)
        box = [state, tail]

        def run(n, box=box, chain=chain):
            box[0], box[1], _ = chain(box[0], box[1], n)

        profile_chain(f"classic_{name}", run, 5, out_dir)
        del box, chain, state, tail
        torch.cuda.empty_cache()

        bank = CarrierBankDemod(fs=fs, freqs_hz=grid(c), frontend="fft")
        fused = FusedRx(bank, DEV)
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (2, bank.block_len)).astype(np.float32)).to(DEV)
        fbox = [fused.init_state()]

        def frun(n, fbox=fbox, fused=fused, x=x):
            total = None
            for _ in range(n):
                out, fbox[0] = fused.step(x, fbox[0])
                _, counts = framescan.sparse_hits(out["corr"],
                                                  out["crc_err"])
                total = counts.sum()
            total.item()

        profile_chain(f"fused_C{c}", frun, 5, out_dir)
        del fbox, fused, x, bank
        torch.cuda.empty_cache()

        # the sharded FFT step on a virtual (2, 2) mesh of the card
        sd = ShardedFFTDemod(fs, grid(c), make_mesh(2, 2, virtual(4)))
        noise = np.random.default_rng(3).standard_normal(
            (2, 2 * sd.seg_len)).astype(np.float32)
        seg = sd.upload((noise[0] + 1j * noise[1]).astype(np.complex64))
        del noise

        def srun(n, sd=sd, seg=seg):
            for _ in range(n):
                sd.step(seg)

        profile_chain(f"sharded_C{c}", srun, 3, out_dir)
        del sd, seg
        torch.cuda.empty_cache()
    say("profile mode: no result line")
    return 4


def record_stream_tea() -> list:
    """The deferred searches of the fused stream's three blocks at C=1024
    (the capture of phase_stream, TEA carriers on), recorded by
    record_tea_calls without the stream's checks."""
    setup = fleet_setup(FS_FLEET, 1024, None, 3, seed=11, encrypted=True)
    calls = []
    undo = record_tea_calls(calls)
    pipe = stream_pipeline(setup, 0, lambda f: None,
                           **dict(FUSED_CFG, auto_decrypt=True))
    try:
        bl = setup["block_len"]
        for i in range(len(setup["iq"]) // bl):
            pipe.process_block(setup["iq"][i * bl:(i + 1) * bl])
    finally:
        pipe.close()
        undo()
    return calls


def record_voice_viterbi() -> list:
    """The viterbi_decode launches of the voice fleet's unsplit run (the
    capture of phase_voice_fleet), recorded by record_viterbi_calls."""
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.golden import fleet_capture
    offsets = grid(1024)
    bl = CarrierBankDemod(fs=FS_FLEET, freqs_hz=offsets,
                          frontend="fft").block_len
    iq, _ = fleet_capture(FS_FLEET, offsets, [], 4 * bl, seed=21,
                          voice=voice_carriers(1024))
    calls = []
    voice_stream_run({"fs": FS_FLEET, "offsets": offsets, "iq": iq,
                      "block_len": bl}, False, 0, calls)
    return calls


def main_parent(parent: Path) -> int:
    """The kernels whose earlier source ``parent`` holds (PARENT_SOURCES),
    in turns with this checkout's on the same inputs; one JSON line a
    case.  band_extract.cu: random starts at the C=1024 and C=10240
    geometries, then the real grids.  tea.cu: the fixed sizes in all
    three modes, the deferred searches of the fused stream (its three
    blocks recorded) with the round trip, the floor.  viterbi.cu: B =
    8192 and 81920, the floor (B = 1, 2), the voice fleet's launches (its
    unsplit run recorded)."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp.channelizer import choose_decim, choose_nfft
    PARENT.update(build_parent(parent))
    if not PARENT:
        fail(f"--parent {parent}: none of {PARENT_SOURCES} there")
    if "band_extract.cu" in PARENT:
        rng = np.random.default_rng(1)
        for fs, c in ((FS_FLEET, 1024), (FS_BENCH, 10240)):
            nfft_ = choose_nfft(fs)
            nb = nfft_ // choose_decim(fs)
            planes = torch.from_numpy(rng.standard_normal(
                (2, (nfft_ + nb) // 128, 128)).astype(np.float32)).to(DEV)
            for _, what, src, plan, starts, gather in extract_random(
                    c, nfft_, nb, planes, rng):
                r = extract_result(what, src, plan, starts, gather, 10,
                                   100 if c <= 1024 else 10)
                say(json.dumps({"case": what, **r}))
            del planes, src
            torch.cuda.empty_cache()
        for name, rs in phase_extract_grids(seed=7).items():
            for r in rs:
                say(json.dumps({"case": f"{name} grid", **r}))
    if "tea.cu" in PARENT:
        tea = phase_tea(seed=8, reps=5, int_rates=phase_int_rate())
        for size, r in tea.items():
            say(json.dumps({"case": f"tea {size}", **r}))
        for r in phase_tea_path(record_stream_tea(), reps=5):
            say(json.dumps({"case": "tea path", **r}))
        say(json.dumps({"case": "tea floor", **tea_floor(reps=5)}))
    if "viterbi.cu" in PARENT:
        vit = phase_viterbi(seed=9, reps=5)
        for b, r in vit.items():
            say(json.dumps({"case": f"viterbi B={b}", **r}))
        for b, r in viterbi_floor(seed=9, reps=5).items():
            say(json.dumps({"case": f"viterbi floor B={b}", **r}))
        for r in phase_viterbi_path(record_voice_viterbi(), reps=5):
            say(json.dumps({"case": "viterbi path", **r}))
    say("parent mode: no result line")
    return 1


def ui_launches(ui: dict, name: str) -> dict:
    """Kernel ``name``'s launches in each run of the ui phase."""
    return {r: res["launches"].get(name, 0) for r, res in ui.items()}


def main_only(phases: list, card: str) -> int:
    """--only ui,examples,bench: the named phases alone (after the
    build), each result line printed; no result line."""
    known = {"ui": lambda: phase_ui(seed=71), "examples": phase_examples,
             "bench": lambda: phase_bench(card)}
    bad = [p for p in phases if p not in known]
    if bad:
        print(f"chip_smoke.py --only: unknown phases {bad}; known "
              f"{sorted(known)}", file=sys.stderr)
        return 2
    for p in phases:
        t0 = time.time()
        out = known[p]()
        say(json.dumps({"phase": p, "seconds": time.time() - t0,
                        "result": out}, default=str))
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "tetraear_tpu" or m.startswith("tetraear_tpu."))
    if bad:
        fail(f"modules of JAX or of the JAX package were imported: {bad}")
    say("--only: no result line")
    return 5


def main(argv: list) -> int:
    global DEV, REHEARSE, SM_CLOCK_HZ
    if not (ROOT / "tetraear_tpu_torch" / "dsp" / "csrc").is_dir():
        print("chip_smoke.py: run it from the root of a tetraear checkout "
              "(tetraear_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    REHEARSE = "--rehearse" in argv
    if REHEARSE:
        DEV = "cpu"
    elif not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    card = "rehearsal on the CPU"
    if not REHEARSE:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
            else "nvidia-smi: " + smi.stderr.strip()
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()
        if clk and clk[0].strip().isdigit():
            SM_CLOCK_HZ = float(clk[0]) * 1e6
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; SM clock "
        f"{SM_CLOCK_HZ / 1e6:.0f} MHz (clocks.max.sm)")
    t_start = time.time()

    from tetraear_tpu_torch import native
    from tetraear_tpu_torch.dsp import cuda_kernels as ck
    t0 = time.time()
    for name in ("frame", "voice"):
        native.build(name)
    hitparse = native.hitparse()
    setting = os.environ.get("TETRAEAR_HITPARSE")
    said = ("" if setting is None else
            f"; TETRAEAR_HITPARSE={setting}: the "
            f"{'native' if hitparse.available() else 'Python'} parse runs")
    if not hitparse.available():
        fail(f"the native frame parser is not loaded{said}")
    parts = ", ".join(f"{k} {v['seconds']:.1f} s"
                      for k, v in native.build_info.items())
    say(f"build: g++ frame parser and voice codec {time.time() - t0:.1f} s "
        f"({parts}){said}")
    if not REHEARSE:
        t0 = time.time()
        ck.build()
        say(f"build: {time.time() - t0:.1f} s ({ck.build_info['path']})")
        for line in ck.build_info.get("log", "").splitlines():
            entry = re.search(r"entry function '\S*?_cu_[0-9a-f]{8}\d+"
                              r"(\w+?)E[vP]", line)
            if entry:
                say("  ptxas " + entry.group(1))
            elif "Used" in line or "spill" in line:
                say("    " + line.replace("ptxas info    :", "").strip())
    if "--profile" in argv:
        rest = argv[argv.index("--profile") + 1:]
        return main_profile(card, ROOT / (rest[0] if rest
                                          else "profile_out"))
    if "--parent" in argv:
        return main_parent(Path(argv[argv.index("--parent") + 1]).resolve())
    if "--nccl-one-rank" in argv:
        return nccl_child()
    if "--only" in argv:
        return main_only(argv[argv.index("--only") + 1].split(","), card)

    # sizes: the real ones, or a tiny stand-in for each in the rehearsal
    # (C=8, nfft overrides; the fleet stand-in stays fused-eligible)
    c_fleet, c_bench = (8, 8) if REHEARSE else (1024, 10240)
    nfft_fleet = 2 ** 18 if REHEARSE else None
    nfft_bench = 2 ** 21 if REHEARSE else None
    nfft_aligned = 2 ** 18 if REHEARSE else None

    int_rates = phase_int_rate()
    kern = phase_kernels(FS_FLEET, c_fleet, seed=1, reps=10,
                         nfft=nfft_fleet)
    kern_big = phase_kernels(FS_BENCH, c_bench, seed=2, reps=3,
                             nfft=nfft_bench)
    phase_kernels_extra(seed=6)
    grids = phase_extract_grids(seed=7)
    tea = phase_tea(seed=8, reps=5, int_rates=int_rates)
    check_tea_corners(seed=12)
    vit = phase_viterbi(seed=9, reps=5)
    vit_floor = viterbi_floor(seed=9, reps=5)
    check_viterbi_corners(seed=13)
    sp = phase_speech(seed=10, reps=5)
    say(f"[{time.time() - t_start:.0f} s] kernels checked")
    phase_decode_small()
    # Pipeline takes no nfft: the rehearsal's fleet is the small geometry
    # (2.304 MHz, C=8, nfft 2^18), which the fused path serves too
    fleet_fs = FS_SMALL if REHEARSE else FS_FLEET
    setup = fleet_setup(fleet_fs, c_fleet, nfft_fleet, 3, seed=11,
                        encrypted=True)
    counts_fused, fused_frames = phase_decode_fleet(c_fleet, setup)
    counts_afc, _ = phase_decode_fleet_afc(
        c_fleet, setup, fused_frames, nfft_fleet)
    counts_afc_w, afc_frames_w = phase_decode_fleet_afc(
        c_fleet, setup, fused_frames, nfft_fleet, workers=2)
    tea_calls = []
    counts_stream, _ = phase_stream(
        "fused", c_fleet, setup, fused_frames, FUSED_KERNELS,
        tea_calls=tea_calls, **dict(FUSED_CFG, auto_decrypt=True))
    counts_stream_w, _ = phase_stream(
        "classic-workers", c_fleet, setup, afc_frames_w,
        ("frame_scan_even", "band_synth_y"), workers=2, frontend="fft",
        carrier_afc=True, auto_decrypt=True)
    if not REHEARSE and counts_stream["tea_search"] != len(tea_calls):
        fail(f"stream fused: {counts_stream['tea_search']} tea_search "
             f"launches for {len(tea_calls)} deferred searches")
    tea_path = phase_tea_path(tea_calls, reps=5)
    tea_fl = tea_floor(reps=5)
    pb_fleet = phase_process_block_timing("fleet", setup, fleet_fs, c_fleet,
                                          2, 0, None)
    pb_fleet_w = {w: phase_process_block_timing(
        "fleet", setup, fleet_fs, c_fleet, 2, 0, None, workers=w)
        for w in (2, 4)}
    del fused_frames, afc_frames_w, setup, tea_calls
    say(f"[{time.time() - t_start:.0f} s] fleet decodes and streams at "
        f"{fleet_fs / 1e6:g} MHz done")
    t_voice = time.time()
    voice_fleet = phase_voice_fleet(c_fleet, nfft_fleet, 4, seed=21)
    voice_dev = phase_voice_fleet_device(voice_fleet)
    vit_path = phase_viterbi_path(voice_fleet["calls"], reps=5)
    for key in ("setup", "log", "stats", "calls"):
        del voice_fleet[key]
    counts_vrtl = phase_voice_rtl()
    say(f"[{time.time() - t_start:.0f} s] voice phases done in "
        f"{time.time() - t_voice:.0f} s")
    if REHEARSE:
        counts_al = counts_x = {k: 0 for k in ck.launches}
    counts_rtl = phase_decode_rtl()
    counts_el = phase_decode_element()
    if not REHEARSE:
        counts_al, counts_x = phase_decode_fleet_aligned(c_fleet,
                                                         nfft_aligned)
    counts_ph = phase_phasor_probe(FS_FLEET, c_fleet, nfft_fleet)
    counts_p1 = phase_pass1_probe(FS_FLEET, c_fleet, nfft_fleet)
    counts_pl = phase_place_probe(FS_FLEET, c_fleet, nfft_fleet)
    counts_op = phase_ops_probe()
    counts_iir = phase_iir_probe(4 * c_fleet)
    say(f"[{time.time() - t_start:.0f} s] decodes done")
    chains = {
        "c1024": phase_chain(FS_FLEET, c_fleet, 10, 3, kern, nfft_fleet),
        "c10240": phase_chain(FS_BENCH, c_bench, 5, 4, kern_big,
                              nfft_bench),
        "classic_fleet_afc": phase_chain_classic(
            "fleet-afc", FS_FLEET, c_fleet, 10, 3, nfft_fleet),
        "classic_fleet_aligned": phase_chain_classic(
            "fleet-aligned", FS_ALIGNED, c_fleet, 10, 5, nfft_aligned),
        "classic_bench_afc": phase_chain_classic(
            "bench-afc", FS_BENCH, c_bench, 3, 4, nfft_bench),
    }
    pb_fleet["chain_ms"] = chains["c1024"]["ms_per_block"]
    pb_bench = phase_process_block_timing(
        "bench", None, FS_SMALL if REHEARSE else FS_BENCH, c_bench, 2, 17,
        chains["c10240"]["ms_per_block"], n_frame=1, n_whole=1)
    pb_bench_w = {w: phase_process_block_timing(
        "bench", None, FS_SMALL if REHEARSE else FS_BENCH, c_bench, 2, 17,
        chains["c10240"]["ms_per_block"], n_frame=1, n_whole=1, workers=w)
        for w in (2, 4)}
    say(f"[{time.time() - t_start:.0f} s] chains timed")
    t_tools = time.time()
    tools = phase_tools(seed=61, reps=5)
    prof = phase_profiling(card, chains, sp, c_fleet, c_bench, nfft_fleet)
    say(f"[{time.time() - t_start:.0f} s] tools and profiling phases done "
        f"in {time.time() - t_tools:.0f} s")
    t_ui = time.time()
    ui = phase_ui(seed=71)
    examples = phase_examples()
    say(f"[{time.time() - t_start:.0f} s] ui and examples phases done in "
        f"{time.time() - t_ui:.0f} s")
    bench_res = phase_bench(card)
    say(f"[{time.time() - t_start:.0f} s] bench phase done")

    # multi-device sharding (virtual meshes of the card) and the scanners;
    # the rehearsal's stand-ins: 2.304 and 10.24 MHz at C=8
    t_shard = time.time()
    conv_sh, counts_sh_conv = phase_sharded_conv()
    sh_fleet, counts_sh_fleet = phase_sharded_fft(
        "fleet", FS_SMALL if REHEARSE else FS_FLEET, c_fleet, "band_extract",
        seed=51, reps=5)
    sh_aligned, counts_sh_aligned = phase_sharded_fft(
        "fleet-aligned", 10.24e6 if REHEARSE else FS_ALIGNED, c_fleet,
        "band_extract_rows", seed=52, reps=5)
    sh_big, counts_sh_big = phase_sharded_fft_big(
        c_bench, FS_SMALL if REHEARSE else FS_BENCH, reps=3)
    sh_small = phase_sharded_small()
    nccl, counts_nccl = phase_nccl_one_rank()
    voice_mesh, counts_vmesh = phase_voice_mesh(seed=53)
    crypto_mesh, counts_cmesh = phase_crypto_mesh()
    scan, counts_scan = phase_scan_wideband()
    say(f"[{time.time() - t_start:.0f} s] sharding and scanner phases done "
        f"in {time.time() - t_shard:.0f} s")

    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "tetraear_tpu" or m.startswith("tetraear_tpu."))
    if bad:
        fail(f"modules of JAX or of the JAX package were imported: {bad}")
    if REHEARSE:
        say("rehearsal passed: no result line")
        return 4

    # launches: each kernel's count in the run of the path that owns it
    main_path = {
        "fft2p": counts_fused, "band_synth": counts_fused,
        "fused_backhalf": counts_fused, "band_synth_y": counts_afc,
        "frame_scan_even": counts_afc, "band_extract_rows": counts_x,
        "band_extract": counts_el, "band_synth_ph": counts_ph,
        "fft2p_pass1": counts_p1, "bit_place": counts_pl,
        "ops_probe": counts_op, "iir_recursion": counts_iir}
    kernels = []
    bench_c1024 = bench_res["chains_c1024"]
    for name, (src, replaces) in KERNELS.items():
        in_bench = {chain: r["launches_per_step"][name]
                    for chain, r in bench_c1024.items()
                    if name in r["launches_per_step"]}
        if name == "tea_search":
            entry = tea_entry(tea, tea_path, counts_stream, tea_fl)
            entry["launches_bruteforce_keys"] = \
                tools["launches"]["bruteforce_keys"]["tea_search"]
            entry["bruteforce_keys"] = tools["bruteforce_keys"]
            entry["launches_tools"] = {
                t: tools["launches"][t]["tea_search"]
                for t in ("continuous_capture", "decrypt_capture",
                          "bruteforce_keys")}
            entry["launches_ui"] = ui_launches(ui, name)
            kernels.append(entry)
            continue
        if name == "viterbi_decode":
            kernels.append(dict(viterbi_entry(vit, vit_floor, vit_path,
                                              voice_fleet),
                                launches_ui=ui_launches(ui, name),
                                launches_bench_per_step=in_bench))
            continue
        if name == "acelp_decode":
            kernels.append(dict(acelp_entry(sp, voice_dev),
                                launches_ui=ui_launches(ui, name),
                                launches_bench_per_step=in_bench))
            continue
        k1, k2 = kern[name], kern_big[name]
        if main_path[name][name] == 0:
            fail(f"{name}: no launch on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main_path[name][name],
            "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
            "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
            "bound_bytes": k1["bytes"], "bound_ops": k1["ops"],
            "bound_fp32_rate_ms": k1["fp32_rate_ms"],
            "bound_fp32_rate_ms_c10240": k2["fp32_rate_ms"],
            "shape": "C=1024 fs=36.864MHz",
            "max_abs_err_c10240": k2["max_abs_err"],
            "ms_c10240": k2["ms"], "plain_ms_c10240": k2["plain_ms"],
            "bound_ms_c10240": k2["bound_ms"],
            "bound_by_c10240": k2["bound_by"],
            "bound_bytes_c10240": k2["bytes"],
            "library_ms_c10240": k2["library_ms"],
            **({"launches_bench_per_step": in_bench} if in_bench else {}),
            **({"launch_ms": k1["launch_ms"],
                "launch_ms_c10240": k2["launch_ms"],
                "source_bytes": k1["source_bytes"],
                "source_bytes_c10240": k2["source_bytes"],
                "real_grid": grids[name]}
               if name in grids else {}),
            **({"launches_tools": {
                t: tools["launches"][t][name]
                for t in ("continuous_capture", "decrypt_capture")},
                "launches_ui": ui_launches(ui, name)}
               if name == "frame_scan_even" else {}),
            **({"unspliced_ms": k1["unspliced_ms"],
                "unspliced_plain_ms": k1["unspliced_plain_ms"],
                "unspliced_ms_c10240": k2["unspliced_ms"],
                "unspliced_plain_ms_c10240": k2["unspliced_plain_ms"]}
               if name == "fft2p" else {})})
    say(card)
    say(json.dumps({
        "kernels": kernels, "chain": chains, "card": card,
        "int_rates": int_rates,
        "launches_by_run": {
            "decode_fleet_fused": counts_fused,
            "decode_fleet_afc": counts_afc,
            "decode_fleet_afc_workers": counts_afc_w,
            "decode_fleet_aligned": counts_al,
            "decode_fleet_aligned_extract": counts_x,
            "decode_rtl_conv": counts_rtl["conv"],
            "decode_rtl_fft": counts_rtl["fft"],
            "decode_element": counts_el, "phasor_prepass": counts_ph,
            "pass1_probe": counts_p1, "place_probe": counts_pl,
            "ops_probe": counts_op, "iir_probe": counts_iir,
            "stream_fused": counts_stream,
            "stream_classic_workers": counts_stream_w,
            "voice_fleet": voice_fleet["launches"],
            "voice_fleet_device": voice_dev["launches"],
            "voice_rtl": counts_vrtl["host"],
            "voice_rtl_device": counts_vrtl["device"],
            "sharded_conv": counts_sh_conv,
            "sharded_fft_fleet": counts_sh_fleet,
            "sharded_fft_fleet_aligned": counts_sh_aligned,
            "sharded_fft_c10240": counts_sh_big,
            "nccl_one_rank": counts_nccl,
            "voice_mesh": counts_vmesh, "crypto_mesh": counts_cmesh,
            "scan_wideband": counts_scan,
            **{f"tools_{t}": c for t, c in tools["launches"].items()},
            **{f"ui_{r}": ui[r]["launches"] for r in ui},
            **{f"examples_{e}": r["launches"]
               for e, r in examples.items()}},
        "tools": {k: v for k, v in tools.items() if k != "launches"},
        "ui": {r: {k: v for k, v in res.items() if k != "launches"}
               for r, res in ui.items()},
        "examples": {e: {k: v for k, v in r.items() if k != "launches"}
                     for e, r in examples.items()},
        "profiling": prof,
        "bench": bench_res,
        "sharding": {
            "conv": conv_sh, "fft_fleet": sh_fleet,
            "fft_fleet_aligned": sh_aligned, "fft_c10240": sh_big,
            "fft_small_vs_cpu": sh_small, "nccl_one_rank": nccl,
            "voice_mesh_acelp_launches_per_call": voice_mesh,
            "crypto_mesh": crypto_mesh},
        "scan_wideband": scan,
        "process_block": {
            "c1024": pb_fleet, "c10240": pb_bench,
            **{f"c1024_workers{w}": r for w, r in pb_fleet_w.items()},
            **{f"c10240_workers{w}": r for w, r in pb_bench_w.items()}},
        "voice_fleet": voice_fleet["result"],
        "voice_fleet_device": voice_dev["result"],
        "speech": {f"s{s}" if isinstance(s, int) else s: r
                   for s, r in sp.items()},
        "native_build": native.build_info,
        "seconds": time.time() - t_start}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
