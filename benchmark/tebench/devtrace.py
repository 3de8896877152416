"""The device trace of a short steady stretch of the window.

``torch.profiler`` (CUPTI) traces the card for a stretch of whole blocks
of a traced run; the trace is exported as Chrome JSON into the run's
temporary directory, read, and deleted.  From it come the device's busy
time (the union of kernels, copies and memsets), the stretch's length,
the kernels that ran inside each ``bm.<span>`` annotation of the host,
the device operations that took most time, and the longest idle time
by what the host was doing meanwhile.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Stretch:
    """Profile from ``start()`` to ``stop()`` (both synchronize)."""

    def __init__(self):
        self.result = None
        self._prof = None

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.result = read(events, wall)


def _union(iv: list) -> tuple:
    """(total covered length, merged intervals) of [(start, end)]."""
    iv = sorted(iv)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def read(events: list, wall_s: float) -> dict:
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    ann = [e for e in events if e.get("ph") == "X"
           and str(e.get("name", "")).startswith("bm.")
           and e.get("cat") == "user_annotation"]
    busy_us, merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"] * 1e-6
    spans = defaultdict(list)
    for a in ann:
        spans[a["name"][3:]].append((a["ts"], a["ts"] + a["dur"]))
    kernels_in = {}
    for name, iv in spans.items():
        tot = 0.0
        for e in dev:
            if e.get("cat") != "kernel":
                continue
            mid = e["ts"] + e["dur"] / 2
            if any(a <= mid <= b for a, b in iv):
                tot += e["dur"] * 1e-6
        kernels_in[name] = (tot, len(iv))
    gaps = defaultdict(float)
    for (_, a1), (b0, _) in zip(merged, merged[1:]):
        mid = (a1 + b0) / 2
        owner, best = "other", None
        for name, iv in spans.items():
            for s, t in iv:
                if s <= mid <= t and (best is None or t - s < best):
                    owner, best = name, t - s
        gaps["host:" + owner] += (b0 - a1) * 1e-6
    return {
        "launches": sum(1 for e in dev if e.get("cat") == "kernel"),
        "busy_s": busy_us * 1e-6,
        "window_s": wall_s,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
        "kernels_in": kernels_in,
    }
