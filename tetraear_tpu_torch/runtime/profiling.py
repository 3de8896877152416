"""Tracing, per-stage throughput counters and the H100 roofline.

The port's form of the JAX package's runtime/profiling.py:

  * Profiler — context manager around torch.profiler writing a Chrome
    trace (chrome://tracing, Perfetto) of the host and, on the card, of
    every kernel launched inside it;
  * StageTimers — host-side per-stage wall-time accounting with
    samples/s rates (the JAX package's, code for code);
  * the port's tracer (``tracer()``, ``block``, ``span``, ``count``) —
    spans and counters inside the live path, a block at a time, on
    StageTimers' totals (see ``Tracer``);
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
from collections import defaultdict, deque
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


# whole blocks the tracer keeps in memory, the oldest dropped first
BLOCKS_KEPT = 1024


class _NullSpan:
    """The shared no-op context a span site gets while nothing is traced."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class BlockRecord:
    """One block of the tracer: ``spans`` holds [name, start, end, parent]
    in the order the spans opened (time.perf_counter seconds; ``parent``
    is the parent's position in the list, -1 for the root ``spans[0]``),
    ``counts`` the counters added in the block and ``device_ms`` the
    CUDA-event milliseconds of the spans that recorded events."""

    __slots__ = ("index", "spans", "counts", "device_ms")

    def __init__(self, index: int):
        self.index = index
        self.spans: list = []
        self.counts: dict = {}
        self.device_ms: dict = {}

    @property
    def name(self) -> str:
        return self.spans[0][0]

    @property
    def start(self) -> float:
        return self.spans[0][1]

    def ms(self, name: str) -> float:
        """Host milliseconds of the block's spans called ``name``."""
        return 1e3 * sum(s[2] - s[1] for s in self.spans if s[0] == name)


class _Span:
    """An open span of the tracer (``span``): its row in the block's
    record, a ``te.<name>`` profiler range while a torch.profiler session
    is on, and two CUDA events where it times a device."""

    __slots__ = ("tr", "name", "cuda", "pos", "rf", "e0")

    def __init__(self, tr, name: str, cuda: bool = False):
        self.tr = tr
        self.name = name
        self.cuda = cuda
        self.rf = self.e0 = None

    def __enter__(self):
        tr = self.tr
        if tr._ranges:
            import torch
            self.rf = torch.profiler.record_function("te." + self.name)
            self.rf.__enter__()
        spans = tr._cur.spans
        self.pos = len(spans)
        stack = tr._stack
        spans.append([self.name, time.perf_counter(), None,
                      stack[-1] if stack else -1])
        stack.append(self.pos)
        if self.cuda:
            import torch
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        return self

    def __exit__(self, *exc):
        tr = self.tr
        if self.e0 is not None:
            import torch
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            tr._pending.append((self.name, self.e0, e1))
        t1 = time.perf_counter()
        row = tr._cur.spans[self.pos]
        row[2] = t1
        tr._stack.pop()
        tr.totals[self.name] += t1 - row[1]
        tr.counts[self.name] += 1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Block(_Span):
    """The root span: opens a block record, closes it into the ring."""

    __slots__ = ()

    def __enter__(self):
        tr = self.tr
        tr._ranges = _profiler_active()
        tr._index += 1
        tr._cur = BlockRecord(tr._index)
        tr._stack = []
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        tr = self.tr
        tr.blocks.append(tr._cur)
        tr._cur = None
        tr._pending = []
        tr._ranges = False
        return False


def _profiler_active() -> bool:
    import torch
    return bool(torch.autograd._profiler_enabled())


class Tracer(StageTimers):
    """The port's tracer: one a process (``tracer()``), as ``logging``
    has one root logger, so a reader needs no reference to a Pipeline.

    Off by default.  Off, every span site (``span``, ``block``) is one
    attribute check that returns the shared ``NULL_SPAN``: nothing is
    recorded, allocated or synchronized.  On (``enable()``), the root
    span ``block`` (one a ``Pipeline.process_block``) opens a
    ``BlockRecord`` and every span inside it records its name, start,
    end and parent on ``time.perf_counter``; spans opened outside a block
    record nothing.  Closed blocks go into ``blocks``, a ring of the last
    ``BLOCKS_KEPT``, and every span's time into StageTimers' totals
    (``report()``).  While a torch.profiler session is on (checked once a
    block) each span also opens a ``te.<name>`` range, so a device trace
    holds the program's spans beside its kernels and copies.  A span
    opened with a CUDA device records two CUDA events; ``read_device()``
    reads their milliseconds once they have completed, so no synchronize
    is added.

    Counters (``count``) are always on: integers added once a block to
    ``counter_totals`` and, while a block is recorded, to its
    ``counts``."""

    def __init__(self):
        super().__init__()
        self.on = False
        self.blocks: deque = deque(maxlen=BLOCKS_KEPT)
        self.counter_totals: dict = defaultdict(int)
        self._cur = None                # the open BlockRecord
        self._stack: list = []          # positions of the open spans
        self._pending: list = []        # (name, e0, e1) unread events
        self._ranges = False
        self._index = 0

    def enable(self, on: bool = True) -> None:
        self.on = bool(on)

    def reset(self) -> None:
        """Drop every record, total and counter (the switch stays)."""
        on = self.on
        self.__init__()
        self.on = on

    def counters(self) -> dict:
        return dict(self.counter_totals)

    def window(self, t_lo: float, t_hi: float,
               name: str = "block") -> list:
        """The kept records of root ``name`` that started in [t_lo,
        t_hi)."""
        return [b for b in self.blocks
                if b.name == name and t_lo <= b.start < t_hi]


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process's tracer."""
    return _TRACER


def block(name: str = "block"):
    """The root span of one block (a plain span if a block is open)."""
    tr = _TRACER
    if not tr.on:
        return NULL_SPAN
    if tr._cur is not None:
        return _Span(tr, name)
    return _Block(tr, name)


def span(name: str, device=None):
    """A span inside the open block; ``device`` (a torch.device) adds
    two CUDA events where it is a card."""
    tr = _TRACER
    if tr._cur is None:
        return NULL_SPAN
    return _Span(tr, name, device is not None and device.type == "cuda")


def count(name: str, n: int) -> None:
    """Add ``n`` to a counter (always on; once a block at each site)."""
    tr = _TRACER
    tr.counter_totals[name] += n
    rec = tr._cur
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


def read_device() -> None:
    """Read the CUDA-event milliseconds of the open block's spans whose
    events have completed (a query, never a wait)."""
    tr = _TRACER
    if tr._cur is None or not tr._pending:
        return
    keep = []
    for name, e0, e1 in tr._pending:
        if e1.query():
            ms = tr._cur.device_ms
            ms[name] = ms.get(name, 0.0) + e0.elapsed_time(e1)
        else:
            keep.append((name, e0, e1))
    tr._pending = keep


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
