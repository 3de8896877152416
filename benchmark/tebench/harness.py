"""One run of one cell: set-up, a measured window, the check, one line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Set-up makes the cell's capture on the card from the seed (tebench.
traffic and tebench.synth), copies it to pageable host memory as a cycle
of distinct blocks, builds the program's ``Pipeline`` as the
configuration states, and warms it up on the capture's first blocks.
The window then feeds ``Pipeline.process_block`` fresh host blocks in a
closed loop until ``--seconds`` have passed; every block that started
in the window is finished and counted.  After the window, untimed and
with the program's tracer off, the program takes as many more blocks
(fewer than a cycle) as end the judged span on a whole cycle of the
capture, so that a run judges the same positions of the cycle however
many blocks its window held.  Then the peak device memory is read, the
program's state is freed, and the frames of a sample of carriers over
the judged span are judged against the reference (tebench.check).
``--trace 1`` adds span timings, a device trace of a short stretch of
the window, and reports the per-layer metrics instead of the end-to-end
ones.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from tebench import cells, check, traffic
from tebench.record import Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "tetraear_tpu")
# PipelineStats counters reported a block on the run's info line
COUNTS = ("frames", "crc_pass", "encrypted", "decrypted", "voice_frames",
          "stolen_frames", "sds_messages")
PROGRAM = "tetraear_tpu_torch"


class Run:
    """What a metric's reader sees (metrics/<name>.py: compute(run))."""

    def __init__(self, cell, fs, block_len):
        self.cell = cell
        self.n_carriers = int(cell.config["n_carriers"])
        self.fs = fs
        self.block_len = block_len
        self.block_s = block_len / fs
        self.setup_s = None
        self.blocks = 0                  # blocks finished in the window
        self.wall_s = None               # the window's wall seconds
        self.t_lo = self.t_hi = None     # the window, perf_counter
        self.block_times = []            # process_block cells, seconds
        self.block_cpu = []              # the process's CPU seconds a block
        self.steal_s = None              # the machine's steal time, window
        self.recorder = None
        self.trace = None                # devtrace result or None
        self.traced_blocks = 0
        self.counts = {}                 # PipelineStats a window block
        self.extra_blocks = 0            # judged blocks past the window
        self.extra_s = 0.0               # their wall seconds

    def span_ms_per_block(self, *names) -> float | None:
        vals = [self.recorder.span_ms(n, self.t_lo, self.t_hi)
                for n in names]
        if all(v is None for v in vals) or not self.blocks:
            return None
        return sum(v for v in vals if v is not None) / self.blocks


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control's answers in place of the "
                         "program's (the benchmark's own check of its "
                         "comparison; never part of a measured run)")
    return ap.parse_args(argv)


def checkout_root() -> Path:
    return cells.HERE.parent


def set_cache_dirs(root: Path) -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    base = root / "build" / "benchmark" / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def steal_seconds() -> float | None:
    """CPU seconds the hypervisor gave to others, all cores (/proc/stat),
    or None where the system does not say."""
    try:
        with open("/proc/stat", encoding="ascii") as fh:
            f = fh.readline().split()
        return int(f[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def offsets(cfg: dict) -> list:
    c, g = int(cfg["n_carriers"]), float(cfg["grid_hz"])
    return [(i - c // 2) * g + g / 2 for i in range(c)]


def make_capture(cfg: dict, tr: dict, seed: int, device) -> tuple:
    """(host (cycle_blocks, block_len) complex64, Truth)."""
    import torch
    from tebench import synth
    fs = float(cfg["sample_rate"])
    bl = int(cfg["block_len"])
    sps = fs / synth.SYMBOL_RATE
    block_syms = bl / sps
    if abs(block_syms - round(block_syms)) > 1e-9:
        raise ValueError("a block must hold whole symbols")
    bits, active, truth = traffic.make(int(cfg["n_carriers"]),
                                       int(round(block_syms)), tr, seed, sps)
    n = bl * int(tr["cycle_blocks"])
    df = fs / n
    offs = np.asarray(offsets(cfg))
    bins = np.round(offs[active] / df).astype(np.int64)
    delays = np.array([truth.carriers[int(c)].delay for c in active])
    x = synth.capture(synth.points(bits), bins, delays, n, fs,
                      float(tr["snr_db"]), seed, torch.device(device))
    host = x.cpu().numpy().reshape(int(tr["cycle_blocks"]), bl)
    del x
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return host, truth


def build_pipeline(cfg: dict, device: str):
    from tetraear_tpu_torch.api import Pipeline, PipelineConfig
    kw = dict(cfg["pipeline"])
    pc = PipelineConfig(sample_rate=float(cfg["sample_rate"]),
                        carrier_offsets_hz=tuple(offsets(cfg)),
                        device=device, **kw)
    pipe = Pipeline(pc)
    if pipe.block_len != int(cfg["block_len"]):
        raise RuntimeError(f"block_len {pipe.block_len} != configured "
                           f"{cfg['block_len']}")
    return pipe


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, control: bool = False) -> dict:
    """Set-up, window and check of one cell; returns the result dict
    (without printing)."""
    import torch
    cfg, tr = cell.config, cell.traffic
    cuda = device != "cpu"
    host, truth = make_capture(cfg, tr, seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cb, bl = host.shape
    fs = float(cfg["sample_rate"])
    run = Run(cell, fs, bl)
    watch = check.watched(truth, int(tr["watch"]["per_role"]),
                          int(tr["watch"]["idle"]), seed)
    rec = run.recorder = Recorder(watch)
    pipe = build_pipeline(cfg, device)
    rec.install(pipe)
    if trace:
        rec.install_spans(pipe, cells.span_points(cell.per_layer, cell.root))
    stretch = None
    if trace and cuda:
        from tebench.devtrace import Stretch
        stretch = Stretch()
    if cfg["entry"] != "process_block":
        raise ValueError(f"unknown entry {cfg['entry']!r}")
    warm = int(cfg["warmup_blocks"])
    for i in range(warm):
        pipe.process_block(host[i % cb])
    if cuda:
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start
    c0 = {k: getattr(pipe.stats, k) for k in COUNTS}
    prof_at = int(cfg["trace_from_block"])
    prof_n = int(cfg["trace_blocks"])
    i = warm
    steal0 = steal_seconds()
    t0 = run.t_lo = time.perf_counter()
    while True:
        if stretch is not None and i == warm + prof_at:
            stretch.start()
        b0 = time.perf_counter()
        p0 = time.process_time()
        pipe.process_block(host[i % cb])
        b1 = time.perf_counter()
        run.block_cpu.append(time.process_time() - p0)
        run.block_times.append(b1 - b0)
        i += 1
        if stretch is not None and i == warm + prof_at + prof_n:
            stretch.stop()
            run.traced_blocks = prof_n
        if b1 - t0 >= seconds:
            break
    if stretch is not None and stretch._prof is not None:
        stretch.stop()
        run.traced_blocks = i - warm - prof_at
    run.t_hi = b1
    run.wall_s = b1 - t0
    if steal0 is not None:
        run.steal_s = steal_seconds() - steal0
    run.blocks = i - warm
    if stretch is not None:
        run.trace = stretch.result
    run.counts = {k: (getattr(pipe.stats, k) - c0[k]) / max(run.blocks, 1)
                  for k in COUNTS}
    if trace:
        from tebench import progtrace
        progtrace.switch_off()
    # the judged span ends on a whole cycle: untimed blocks past the
    # window, which no metric reads, so that every run judges the same
    # positions of the cycle
    t_ext = time.perf_counter()
    while (i - warm) % cb:
        pipe.process_block(host[i % cb])
        i += 1
    if cuda:
        torch.cuda.synchronize()
    run.extra_blocks = i - warm - run.blocks
    run.extra_s = time.perf_counter() - t_ext
    b_lo, b_hi = warm, i - 1
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    bad = forbidden_modules()
    pipe.close()
    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    verdict = check.compare(truth, watch, rec.frames, rec.voice, b_lo, b_hi,
                            control=control)
    return {"run": run, "verdict": verdict, "peak": peak, "forbidden": bad,
            "watch": watch, "truth": truth}


def metrics_of(cell, run, trace: bool) -> dict:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cells.metric_reader(m["name"], cell.root).compute(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(cell, res: dict, trace: bool, device_name: str,
                count: int) -> tuple:
    """(result dict for the last stdout line, stderr check lines)."""
    run, v = res["run"], res["verdict"]
    lim = cell.limits
    checks = {}
    lines = []
    for key in ("failed_share",):
        limit = lim[key]["limit"]
        checks[key] = {"value": v[key], "limit": limit}
        lines.append(f"check {key} {v[key]} limit {limit} "
                     f"(missed {v['missed']} + wrong {v['wrong']} "
                     f"of {v['expected']} slots)")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu", "kind": device_name, "count": count,
           "memory_peak_bytes": res["peak"]}
    out = {"correct": bool(correct), "attempted": int(v["expected"]),
           "failed": int(v["missed"] + v["wrong"]),
           "metrics": metrics_of(cell, run, trace), "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {
            "device_ops": [[k, s] for k, s in run.trace["device_ops"]],
            "idle_gaps": [[k, s] for k, s in run.trace["idle_gaps"]]}
    out["check"] = checks
    return out, lines


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = checkout_root()
    if not (root / PROGRAM).is_dir():
        print(f"no program: {root / PROGRAM} is missing", file=sys.stderr)
        return 3
    cell = cells.load(args.workload, root / "BENCHMARK.json")
    set_cache_dirs(root)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start, control=bool(args.control))
    if res["forbidden"]:
        print(f"forbidden modules loaded: {res['forbidden']}",
              file=sys.stderr)
        return 5
    run, v = res["run"], res["verdict"]
    info = {"workload": cell.name, "seed": args.seed,
            "card": power_limit(), "blocks": run.blocks,
            "wall_s": run.wall_s, "setup_s": run.setup_s,
            "watched": len(res["watch"]),
            "judged_blocks": run.blocks + run.extra_blocks,
            "extra_blocks": run.extra_blocks, "extra_s": run.extra_s,
            "failed_by_position": v["failed_by_position"],
            "failed_by_cycle": v["failed_by_cycle"],
            "details": v["details"],
            "examples": v["examples"],
            "traced_blocks": run.traced_blocks,
            "per_block": run.counts,
            "block_ms": [round(t * 1e3, 3) for t in run.block_times],
            "block_cpu_ms": [round(t * 1e3, 3) for t in run.block_cpu],
            "steal_s": run.steal_s}
    if run.trace is not None:
        info["kernels_in_spans"] = run.trace["kernels_in"]
        info["launches_per_block"] = (run.trace["launches"]
                                      / max(run.traced_blocks, 1))
    print("info " + json.dumps(info, default=str), flush=True)
    out, lines = result_line(cell, res, bool(args.trace),
                             torch.cuda.get_device_name(0), cell.chips)
    for ln in lines:
        print(ln, file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
