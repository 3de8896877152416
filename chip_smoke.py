#!/usr/bin/env python3
"""Smoke test of tetraear_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from the checkout's sources and drives the
port's receive paths on the card in phases, one line per result:

  1. the card: name and power limit (nvidia-smi);
  2. build: nvcc time and the kernels' register / shared-memory use;
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
     16384, frame_scan_even at the edge lengths of its planes;
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

Every decode phase sets the kernels' launch counts to 0 just before it
drives its path and reads them just after; a kernel of that path that
was never launched fails the run.

The last two lines are one JSON object of kernel results and the
result line {"ok": true, "device": {...}}.  Any failed phase exits
non-zero before the result line; so does a machine without a CUDA
device, and a directory without the tetraear_tpu_torch package.

Two other modes print no result line and exit non-zero:

    python3 chip_smoke.py --profile [DIR]   # torch.profiler breakdown
                                       # of the chained steps, written
                                       # to DIR (default profile_out/)
    python3 chip_smoke.py --rehearse   # the phases' control flow on the
                                       # CPU at a tiny size (plain
                                       # versions; nothing is built)
"""

import json
import math
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
}
FUSED_KERNELS = ("fft2p", "band_synth", "fused_backhalf")

FS_SMALL = 2.304e6
FS_RTL = 2.4e6
FS_FLEET = 36.864e6
FS_ALIGNED = 40.96e6
FS_BENCH = 294.912e6
RTL_OFFSETS = (12_500.0, -287_500.0)
FIXTURE = ROOT / "tests" / "fixtures" / "offair_2carrier.cs16"

# published peaks of one H100 SXM (dense): device memory rate and the
# float32 rate outside the tensor cores.  Integer work has its own rates:
# on compute capability 9.0 an SM executes 64 32-bit logic operations a
# clock, and 16 population counts or int-to-float conversions (CUDA C
# programming manual, arithmetic instruction throughput), on 132 SMs at the
# SM clock that nvidia-smi reports as clocks.max.sm (read in main).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
N_SMS = 132
LOGIC_PER_CLK_SM = 64.0
QUARTER_PER_CLK_SM = 16.0
SM_CLOCK_HZ = 1.98e9

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


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events; the
    host clock in the rehearsal)."""
    import torch
    fn()
    if DEV == "cpu":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
          quarter: float = 0.0) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations, whichever
    is larger.  ``ops`` are float32 operations at the float32 rate,
    ``logic`` 32-bit integer logic operations and ``quarter`` population
    counts and conversions, each at its own instruction rate; the three run in
    different pipes, so the slowest of them is what the operations need.
    ``fp32_rate_ms`` keeps the earlier yardstick beside it: every
    operation at the float32 rate."""
    t_bytes = in_out_bytes / HBM_BYTES_PER_S * 1e3
    per_ms = N_SMS * SM_CLOCK_HZ * 1e-3
    t_ops = max(ops / FP32_OPS_PER_S * 1e3,
                logic / (LOGIC_PER_CLK_SM * per_ms),
                quarter / (QUARTER_PER_CLK_SM * per_ms))
    total = ops + logic + quarter
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(in_out_bytes), "ops": float(total),
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "fp32_rate_ms": max(t_bytes, total / FP32_OPS_PER_S * 1e3)}


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

    # band extraction: random in-range starts, wrap rows included; at
    # C=1024 a launch is short beside the spread of a 10-launch mean, so
    # kernel and gather are timed over 100 launches there
    xreps = 100 if c <= 1024 else reps
    p = nb // 128
    r_rows = planes.shape[1]
    rs = rng.integers(0, r_rows - p + 1, c)
    rs[0], rs[-1] = 0, r_rows - p
    rs = torch.from_numpy(rs.astype(np.int32)).to(dev)
    got = ck.band_extract_rows(planes, rs, p)
    want = ck.band_extract_rows_plain(planes, rs, p)
    if not torch.equal(got, want):
        fail(f"band_extract_rows C={c}: differs from the gather")
    pl_idx = torch.arange(2, device=dev)[None, :, None]
    row_idx = (rs.long()[:, None, None]
               + torch.arange(p, device=dev)[None, None, :])
    if not torch.equal(planes[pl_idx, row_idx], want):
        fail(f"band_extract_rows C={c}: the single-call gather differs")
    res["band_extract_rows"] = {
        "max_abs_err": 0.0, "tol": 0.0,
        "ms": event_ms(lambda: ck.band_extract_rows(planes, rs, p), xreps),
        "plain_ms": event_ms(
            lambda: ck.band_extract_rows_plain(planes, rs, p), reps),
        "library_ms": event_ms(lambda: planes[pl_idx, row_idx], xreps),
        **bound(2 * nbytes(got) + nbytes(rs), 0.0)}
    del got, want, row_idx

    flat = planes.reshape(2, -1)[:, :nfft_ + nb]
    x_ext = torch.stack([flat[0], flat[1]], dim=1).contiguous()
    st = rng.integers(0, nfft_ + 1, c)
    st[0], st[1], st[-2], st[-1] = 0, 1, nfft_ - 1, nfft_
    st = torch.from_numpy(st.astype(np.int32)).to(dev)
    got = ck.band_extract(x_ext, st, nb)
    want = ck.band_extract_plain(x_ext, st, nb)
    if not torch.equal(got, want):
        fail(f"band_extract C={c}: differs from the gather")
    idx = st.long()[:, None] + torch.arange(nb, device=dev)[None, :]
    res["band_extract"] = {
        "max_abs_err": 0.0, "tol": 0.0,
        "ms": event_ms(lambda: ck.band_extract(x_ext, st, nb), xreps),
        "plain_ms": event_ms(
            lambda: ck.band_extract_plain(x_ext, st, nb), reps),
        "library_ms": event_ms(lambda: x_ext[idx], xreps),
        **bound(2 * nbytes(got) + nbytes(st), 0.0)}
    del got, want, idx, x_ext

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


FUSED_CFG = dict(frontend="fft", carrier_afc=False, auto_decrypt=False)


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


def fleet_setup(fs: float, c: int, nfft: int | None, n_blocks: int,
                seed: int) -> tuple:
    """(offsets, modulated carriers, capture) of a fleet decode."""
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    from tetraear_tpu_torch.golden import fleet_capture
    offsets = grid(c)
    active = ([5, 170, 341, 512, 683, 854, 1019] if c == 1024
              else sorted({(c - 1) * i // 6 for i in range(7)}))
    bl = CarrierBankDemod(fs=fs, freqs_hz=offsets, frontend="fft",
                          nfft=nfft).block_len
    t0 = time.time()
    iq = fleet_capture(fs, offsets, active, n_blocks * bl, seed=seed)
    say(f"capture at {fs / 1e6:g} MHz: {len(active)} of {c} carriers "
        f"modulated over {n_blocks} blocks, made in {time.time() - t0:.1f} s")
    return offsets, active, iq


def phase_decode_fleet(c: int, setup: tuple) -> tuple:
    """The fused path at fleet size; returns (launches, frames)."""
    offsets, active, iq = setup
    t0 = time.time()
    frames, stats, pipe, counts = run_pipeline(
        array_source(iq, FS_FLEET), FS_FLEET, offsets, DEV, 2, **FUSED_CFG)
    wall = time.time() - t0
    if pipe.runner.fused is None:
        fail("decode fleet: not on the fused path")
    need_launched("decode fleet", counts, FUSED_KERNELS)
    check_fleet_texts("decode fleet", frames, active)
    say(f"decode fleet C={c}: {stats.frames} frames, {stats.crc_pass} CRC "
        f"pass, SDS text on carriers {active}; launches {counts}; "
        f"wall {wall:.2f} s incl. first-call setup")
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


def phase_decode_fleet_afc(c: int, setup: tuple, fused_frames: list,
                           nfft: int | None) -> dict:
    """The classic chain (AFC on) beside the fused one, same capture."""
    offsets, active, iq = setup
    t0 = time.time()
    frames, stats, pipe, counts = run_pipeline(
        array_source(iq, FS_FLEET), FS_FLEET, offsets, DEV, 2,
        frontend="fft", carrier_afc=True, auto_decrypt=False)
    wall = time.time() - t0
    if pipe.runner.fused is not None:
        fail("decode fleet-afc: expected the classic chain")
    if nfft is None and not pipe.bank.channelizer.quantized:
        fail("decode fleet-afc: expected the quantized extraction")
    need_launched("decode fleet-afc", counts,
                  ("frame_scan_even", "band_synth_y"))
    check_fleet_texts("decode fleet-afc", frames, active)
    got, want = crc_texts(frames, active), crc_texts(fused_frames, active)
    if got != want:
        fail(f"decode fleet-afc: {len(got)} CRC-passing frames on the "
             f"modulated carriers, the fused path has {len(want)}; first "
             f"difference {next((a, b) for a, b in zip(got + [None], want + [None]) if a != b)}")
    say(f"decode fleet-afc C={c}: {stats.frames} frames, {stats.crc_pass} "
        f"CRC pass, {len(got)} on the modulated carriers, equal to the "
        f"fused path's; launches "
        f"{ {k: v for k, v in counts.items() if v} }; wall {wall:.2f} s")
    return counts


def phase_decode_fleet_aligned(c: int, nfft: int | None) -> tuple:
    """40.96 MHz: the 25 kHz grid falls on 128-bin starts (aligned).
    Default (synthesis kernel without phasor) through Pipeline, then the
    row-extraction kernel through DecodeRunner on a bank built with the
    extraction keyword; the two frame lists must be equal."""
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
    offsets, active, iq = fleet_setup(FS_ALIGNED, c, nfft, 2, seed=13)
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
PROFILE_GROUPS = (
    ("hand-written kernels", ("band_synth_kernel", "frame_scan_kernel",
                              "fused_backhalf_kernel", "fft2p_pass",
                              "extract_rows_kernel", "extract_pairs_kernel")),
    ("cuFFT", ("_fft", "fft_")),
    ("concat and copies", ("CatArray", "direct_copy", "Memcpy", "Memset")),
    ("gathers and indexing", ("gather", "index")),
    ("top-k", ("topk", "sort")),
    ("convolution", ("conv", "cudnn", "gemm", "cutlass", "implicit")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def profile_chain(name: str, run, n_blocks: int, out_dir: Path) -> None:
    """torch.profiler over n_blocks chained steps after warm-up: device
    time by kernel name, launches per block, busy and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run(3)
    sync()
    wall_ms = float("inf")
    for _ in range(2):                # the better of two timed passes
        t0 = time.time()
        run(n_blocks)
        sync()
        wall_ms = min(wall_ms, (time.time() - t0) / n_blocks * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(n_blocks)
        torch.cuda.synchronize()
    spans = []
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start = ev.time_range.start
        dur = ev.time_range.end - start
        spans.append((start, start + dur))
        tot, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + dur, cnt + 1)
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
    beside the fused chain at the same sizes."""
    import numpy as np
    import torch
    from tetraear_tpu_torch.dsp import framescan
    from tetraear_tpu_torch.dsp.backhalf import FusedRx
    from tetraear_tpu_torch.dsp.pipeline import CarrierBankDemod
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
    say("profile mode: no result line")
    return 4


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

    from tetraear_tpu_torch.dsp import cuda_kernels as ck
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
    say(f"[{time.time() - t_start:.0f} s] kernels checked")
    phase_decode_small()
    setup = fleet_setup(FS_FLEET, c_fleet, nfft_fleet, 2, seed=11)
    if REHEARSE:
        # Pipeline takes no nfft: the rehearsal drives the runner's twin
        say("rehearsal: fleet decodes skipped (full-size transforms)")
        counts_fused = {k: 0 for k in ck.launches}
        counts_afc = counts_al = counts_x = dict(counts_fused)
    else:
        counts_fused, fused_frames = phase_decode_fleet(c_fleet, setup)
        counts_afc = phase_decode_fleet_afc(c_fleet, setup, fused_frames,
                                            nfft_fleet)
        del fused_frames
    del setup
    say(f"[{time.time() - t_start:.0f} s] fleet decodes at 36.864 MHz done")
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
    say(f"[{time.time() - t_start:.0f} s] chains timed")

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
    for name, (src, replaces) in KERNELS.items():
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
            "decode_fleet_aligned": counts_al,
            "decode_fleet_aligned_extract": counts_x,
            "decode_rtl_conv": counts_rtl["conv"],
            "decode_rtl_fft": counts_rtl["fft"],
            "decode_element": counts_el, "phasor_prepass": counts_ph,
            "pass1_probe": counts_p1, "place_probe": counts_pl,
            "ops_probe": counts_op, "iir_probe": counts_iir},
        "seconds": time.time() - t_start}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
