"""Tracing, per-stage throughput counters and the H100 roofline.

The port's form of the JAX package's runtime/profiling.py:

  * Profiler — context manager around torch.profiler writing a Chrome
    trace (chrome://tracing, Perfetto) of the host and, on the card, of
    every kernel launched inside it;
  * StageTimers — host-side per-stage wall-time accounting with
    samples/s rates (the JAX package's, code for code);
  * roofline_estimate — back-of-envelope FLOP/byte counts for the demod
    chain (the JAX package's, code for code);
  * the card's peaks (HBM_BYTES_PER_S, FP32_OPS_PER_S and the integer
    rates a clock an SM), roofline_fraction against them, and the HBM
    rate the card really streams (measure_hbm_gbs, measured_hbm_gbs);
  * voice_roofline — the ETSI speech decoder's device limit, from the
    basic operations a frame needs and the rate the acelp_decode kernel
    was measured to retire them.

Nothing here is a TPU figure: the peaks are one H100 SXM's, and the
measured rates come from the port's own runs on an NVIDIA H100 80GB
HBM3 at 700 W (chip_smoke.py).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict
from pathlib import Path

from tetraear_tpu_torch.device import resolve

# published peaks of one H100 SXM (dense): device memory rate and the
# float32 rate outside the tensor cores.  Integer work has its own rates:
# on compute capability 9.0 an SM executes 64 32-bit logic operations a
# clock, and 16 population counts or int-to-float conversions (CUDA C
# programming manual, arithmetic instruction throughput), on 132 SMs at the
# SM clock that nvidia-smi reports as clocks.max.sm (chip_smoke.py reads
# it; SM_CLOCK_HZ is the H100 SXM's 1980 MHz).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
N_SMS = 132
LOGIC_PER_CLK_SM = 64.0
QUARTER_PER_CLK_SM = 16.0
# instructions an SM issues a clock (4 schedulers, a warp each): the
# ceiling of integer work the compiler spreads over the integer pipe and
# the multiply-add pipe (IMAD forms of shifts and additions)
ISSUE_PER_CLK_SM = 128.0
SM_CLOCK_HZ = 1.98e9

# the ETSI speech decoder on the card (acelp_decode, dsp/csrc/speech.cu),
# measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: S = 256
# slots x 4 frames need 18,618,231 basic operations (its frame_ops, a
# counting build of voice/csrc: 19,096 a frame), retired in a launch of
# 0.146-0.148 ms, about 1.26e11 basic operations a second
ACELP_BASICOPS_PER_FRAME = 19_096
ACELP_EFF_OPS_PER_S = 1.26e11

# where measure_hbm_gbs's results are kept, a card a key (gitignored)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "tetraear_tpu_torch"
HBM_FILE = "hbm_gbs.json"
# the smallest footprint whose rate is recorded: smaller arrays pay a
# fixed cost a pass that would understate the rate
HBM_RECORD_MB = 1024


class Profiler:
    """torch.profiler wrapper: ``with Profiler(dir) as p: run()``.

    ``device`` (None: the card) picks the activities: the host's, plus
    the card's kernels when the device is a CUDA one; without a card and
    without ``device="cpu"`` the constructor raises.  On exit the card
    is synchronised and a Chrome trace is written into ``trace_dir``
    (``trace_path``); ``kernel_events()`` lists the card's events."""

    def __init__(self, trace_dir: str | Path | None = None, device=None):
        self.device = resolve(device)
        self.trace_dir = Path(trace_dir) if trace_dir is not None else \
            Path(tempfile.gettempdir()) / "tetraear_trace"
        self.trace_path: Path | None = None
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)
        self.trace_dir.mkdir(parents=True, exist_ok=True)
        self.trace_path = self.trace_dir / (
            f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}_"
            f"{id(self):x}.json")
        self.prof.export_chrome_trace(str(self.trace_path))
        return False

    def kernel_events(self) -> list:
        """(name, start_us, end_us) of every event the card ran."""
        import torch
        out = []
        for ev in self.prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                out.append((ev.name, ev.time_range.start,
                            ev.time_range.end))
        return out


class StageTimers:
    """Accumulate wall time per named stage; report rates."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.items = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            self.items[name] += items

    def report(self) -> dict:
        out = {}
        for name, total in self.totals.items():
            entry = {
                "total_s": total,
                "calls": self.counts[name],
                "mean_ms": 1e3 * total / max(self.counts[name], 1),
            }
            if self.items[name]:
                entry["items_per_s"] = self.items[name] / max(total, 1e-12)
            out[name] = entry
        return out


def roofline_estimate(n_carriers: int, fs: float, frontend: str = "fft",
                      decim: int | None = None) -> dict:
    """Rough FLOPs and HBM bytes per input second for the demod chain.

    Used to sanity-check measured throughput: if achieved FLOP/s or
    bytes/s are far below chip peaks, the kernel is latency- or
    layout-bound, not roofline-bound.
    """
    import math
    decim = decim or max(1, int(round(fs / 96_000.0)))
    out96 = fs / decim
    out72 = 72_000.0
    c = n_carriers

    if frontend == "fft":
        nfft = fs / 10.0                       # 0.1 s blocks, amortized
        fft_flops = 5.0 * fs * math.log2(max(nfft, 2))      # forward, /s
        ifft_flops = c * 5.0 * out96 * math.log2(max(nfft / decim, 2))
        front_flops = fft_flops + ifft_flops + 6.0 * c * out96
        front_bytes = 8.0 * fs * 2 + c * out96 * 8.0 * 2
    else:
        # NCO (sincos ~ 20 flops) + stage-1 conv per carrier
        front_flops = c * fs * (20.0 + 8.0)
        front_bytes = c * fs * 8.0 * 2

    # back half per carrier: stage2 (~64 MAC/out at 72k), RRC (41 taps),
    # timing (~30 flops/sym), demod (~10)
    back_flops = c * (out72 * (64 + 41) * 2 + 18_000.0 * 40)
    back_bytes = c * out72 * 8.0 * 4
    # frame scan (dsp.framescan.frame_scan_sparse): dense 2x22 sync conv
    # at 36 kbit/s per carrier + CRC (33x230 matvec) at only the top-K
    # candidates per ~0.1 s block
    bits_per_s = 36_000.0
    k_cand_per_s = 64 / 0.1
    scan_flops = c * (bits_per_s * 2.0 * 2 * 22
                      + k_cand_per_s * 2.0 * 33 * 230)
    scan_bytes = c * (bits_per_s * (4.0 + 4.0) + k_cand_per_s * 230 * 4.0)
    return {
        "flops_per_s": front_flops + back_flops + scan_flops,
        "hbm_bytes_per_s": front_bytes + back_bytes + scan_bytes,
        "front_flops_per_s": front_flops,
        "scan_flops_per_s": scan_flops,
        "frontend": frontend,
    }


def voice_roofline(n_carriers: int, block_s: float,
                   rt_factor: float | None = None,
                   frames_per_carrier_block: int = 4,
                   basicops_per_frame: float | None = None,
                   eff_ops_per_s: float | None = None) -> dict:
    """Device-limit model for the bit-exact ETSI ACELP voice chain.

    The decoder is a chain of sequential Word16 basic operations per 30
    ms speech frame, whose exact rounding the conformance corpus pins;
    the card parallelizes across slots (acelp_decode: a CTA of two warps
    a slot), so the ceiling is the rate at which the card retires them:

        t_block >= C * frames/block * basicops / eff_rate

    basicops_per_frame defaults to the count the port measured
    (ACELP_BASICOPS_PER_FRAME, TETRAEAR_ACELP_BASICOPS overrides);
    eff_ops_per_s to the rate the acelp_decode kernel was measured to
    retire them on an NVIDIA H100 80GB HBM3 at 700 W
    (ACELP_EFF_OPS_PER_S, TETRAEAR_VOICE_EFF_OPS overrides).  Beside it
    stands the card's integer issue rate (every basic operation one
    integer instruction at ISSUE_PER_CLK_SM a clock on each of N_SMS SMs
    at SM_CLOCK_HZ), the figure the kernel's bound uses; both are
    reported so the gap stays visible.

    Returns the model ceiling in realtime carriers and, when rt_factor
    (measured realtime multiple) is given, the fraction achieved.
    """
    basicops = basicops_per_frame or float(os.environ.get(
        "TETRAEAR_ACELP_BASICOPS", str(ACELP_BASICOPS_PER_FRAME)))
    eff = eff_ops_per_s or float(os.environ.get(
        "TETRAEAR_VOICE_EFF_OPS", str(ACELP_EFF_OPS_PER_S)))
    ops_per_carrier_block = frames_per_carrier_block * basicops
    # realtime ceiling: carriers such that the block decodes in block_s
    model_carriers = eff * block_s / ops_per_carrier_block
    out = {
        "model_voice_carriers_rt": model_carriers,
        "model_ms_per_block": 1e3 * n_carriers * ops_per_carrier_block
        / eff,
        "basicops_per_frame": basicops,
        "eff_basicops_per_s": eff,
        "theoretical_int_issue_per_s": N_SMS * ISSUE_PER_CLK_SM
        * SM_CLOCK_HZ,
        "frames_per_carrier_block": frames_per_carrier_block,
    }
    if rt_factor is not None:
        achieved = rt_factor * n_carriers
        out["voice_model_pct"] = 100.0 * achieved / model_carriers
    return out


def card_key() -> str | None:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (the key of the recorded HBM rates); None without nvidia-smi."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None


def measure_hbm_gbs(device=None, mb: int = 1024, steps: int = 16) -> float:
    """The card's streaming memory rate in GB/s (1e9 bytes a second).

    ``steps`` chained passes y = x * a + carry over float32 tensors of
    ``mb`` MiB, the carry being the pass before's y: each pass reads x
    and the carry once and writes y once, every operand contiguous (a
    carry broadcast from one element runs unvectorized and understates
    the rate), timed with CUDA events (the host clock on the CPU).  The
    twin of the JAX package's perf/hbm_bw_probe.py axpy pass, in plain
    torch: a probe, not a kernel.  Below 1 GiB a fixed cost a pass
    understates the rate."""
    import torch
    dev = resolve(device)
    n = mb * 2 ** 20 // 4
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(n, generator=gen, device=dev)
    bufs = [torch.zeros_like(x), torch.zeros_like(x)]

    def passes(k: int) -> None:
        for i in range(k):
            torch.add(bufs[(i + 1) % 2], x, alpha=0.5, out=bufs[i % 2])

    passes(2)                                      # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        passes(steps)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) * 1e-3
    else:
        t0 = time.perf_counter()
        passes(steps)
        seconds = time.perf_counter() - t0
    return steps * 3 * n * 4 / seconds / 1e9


def record_hbm_gbs(gbs: float, mb: int, steps: int, card: str,
                   repo_root: str | Path | None = None) -> Path:
    """Keep a measure_hbm_gbs result for ``card`` (card_key()) in the
    build directory, where measured_hbm_gbs finds it."""
    path = _hbm_path(repo_root)
    path.parent.mkdir(parents=True, exist_ok=True)
    table = _read_hbm(path)
    table[card] = {"gbs": gbs, "mb": mb, "steps": steps,
                   "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(table, indent=1))
    os.replace(tmp, path)
    return path


def _hbm_path(repo_root) -> Path:
    base = BUILD_DIR if repo_root is None else \
        Path(repo_root) / "build" / "tetraear_tpu_torch"
    return base / HBM_FILE


def _read_hbm(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def measured_hbm_gbs(repo_root: str | Path | None = None, device=None,
                     mb: int = HBM_RECORD_MB) -> tuple:
    """The card's measured streaming rate -> (GB/s, provenance).

    The denominator of ``roofline_measured_pct``.  Precedence:

      1. TETRAEAR_MEASURED_GBS (explicit operator calibration);
      2. the rate measure_hbm_gbs recorded for this card (card_key(): its
         name and power limit) at >= 1 GiB in build/tetraear_tpu_torch/;
      3. a fresh measure_hbm_gbs on ``device`` (None: the card; without
         one this raises), recorded for the card when it streamed >= 1
         GiB.

    The provenance string names the card the rate belongs to."""
    env = os.environ.get("TETRAEAR_MEASURED_GBS")
    if env:
        return float(env), "env:TETRAEAR_MEASURED_GBS"
    path = _hbm_path(repo_root)
    card = card_key()
    if card is not None:
        rec = _read_hbm(path).get(card)
        if rec and rec.get("mb", 0) >= HBM_RECORD_MB and rec.get("gbs"):
            return float(rec["gbs"]), (
                f"{path.name}:{card} (measure_hbm_gbs {rec['mb']} MiB, "
                f"{rec.get('utc', '?')})")
    dev = resolve(device)
    gbs = measure_hbm_gbs(dev, mb=mb)
    if dev.type == "cuda" and mb >= HBM_RECORD_MB:
        import torch
        name = card or torch.cuda.get_device_name(dev)
        record_hbm_gbs(gbs, mb, 16, name, repo_root)
        return gbs, f"measured now:{name} ({mb} MiB)"
    return gbs, f"measured now:{dev} ({mb} MiB)"


def roofline_fraction(n_carriers: int, fs: float, rt_factor: float,
                      frontend: str = "fft",
                      peak_flops: float | None = None,
                      peak_bw: float | None = None,
                      include_scan: bool = True) -> dict:
    """Fraction of the card's roofline the measured run achieves.

    rt_factor: measured realtime multiple (input seconds per wall
    second).  Peaks default to the H100's: FP32_OPS_PER_S (float32
    outside the tensor cores, as the chain runs float32) and
    HBM_BYTES_PER_S, and can be overridden via arguments or the
    TETRAEAR_PEAK_TFLOPS / TETRAEAR_PEAK_GBS environment variables.
    Beside the datasheet fraction stands the one against the rate the
    card really streams (measured_hbm_gbs), never instead of it.
    """
    peak_flops = peak_flops or float(os.environ.get(
        "TETRAEAR_PEAK_TFLOPS", str(FP32_OPS_PER_S / 1e12))) * 1e12
    peak_bw = peak_bw or float(os.environ.get(
        "TETRAEAR_PEAK_GBS", str(HBM_BYTES_PER_S / 1e9))) * 1e9
    est = roofline_estimate(n_carriers, fs, frontend=frontend)
    flops = est["flops_per_s"]
    bbytes = est["hbm_bytes_per_s"]
    if not include_scan:
        flops -= est["scan_flops_per_s"]
    achieved_flops = flops * rt_factor
    achieved_bw = bbytes * rt_factor
    frac = max(achieved_flops / peak_flops, achieved_bw / peak_bw)
    meas_gbs, meas_src = measured_hbm_gbs()
    meas_bw = meas_gbs * 1e9
    frac_meas = max(achieved_flops / peak_flops, achieved_bw / meas_bw)
    return {
        "roofline_pct": 100.0 * frac,
        "roofline_measured_pct": 100.0 * frac_meas,
        "measured_gbs": meas_gbs,
        "measured_gbs_source": meas_src,
        "achieved_tflops": achieved_flops / 1e12,
        "achieved_gbs": achieved_bw / 1e9,
        "bound": ("compute" if achieved_flops / peak_flops
                  >= achieved_bw / peak_bw else "memory"),
        "model_flops_per_input_s": flops,
        "model_bytes_per_input_s": bbytes,
    }
