"""What the harness records around the program's calls.

The harness wraps methods of the program's instances from outside (an
instance attribute shadows the class's method); it edits no code of the
program.  Two kinds of wrapper:

* the answers, in every run: after ``DecodeRunner.frames_of`` the frames
  of the watched carriers, after ``Pipeline._synth_voice`` their voice
  frames' channel-decoded parameters and PCM;
* spans, in a traced run: each span point that the cell's metrics read
  (``spans/<name>.json``: the object as a dotted path from the
  ``Pipeline``, such as ``pipeline.runner``, and its method) is timed by
  the host clock, by the host clock after a synchronize (``sync``), or
  by CUDA events with a synchronize after the call (``cuda``), and named
  ``bm.<span>`` in the profiler's trace.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np


def resolve(pipe, path: str):
    """The object at a dotted path from the Pipeline: ``pipeline`` is the
    Pipeline itself, ``pipeline.runner`` its DecodeRunner."""
    head, *rest = path.split(".")
    if head != "pipeline":
        raise ValueError(f"a span's object starts at 'pipeline': {path!r}")
    obj = pipe
    for a in rest:
        obj = getattr(obj, a)
    return obj


class Recorder:
    def __init__(self, watch: dict):
        self.watch = watch
        self.voice_watch = {c for c, r in watch.items() if r == "voice"}
        self.block = -1                 # block of the last frames_of
        self.frames: list = []
        self.voice: list = []
        self.spans = defaultdict(list)  # name -> [(t0, t1, device ms)]

    # -- answers -------------------------------------------------------------

    def install(self, pipe) -> None:
        runner = pipe.runner
        frames_of = runner.frames_of
        synth = pipe._synth_voice
        watch = self.watch

        def frames_of_rec(host):
            self.block += 1
            out = frames_of(host)
            b = self.block
            for f in out:
                if f["carrier"] in watch:
                    self.frames.append((
                        b, f["carrier"], int(f["stream_symbol"]),
                        bool(f.get("burst_crc")), f.get("sds_message"),
                        bool(f.get("encrypted")), bool(f.get("decrypted")),
                        f.get("decrypted_bytes")))
            return out

        def synth_rec(frames):
            synth(frames)
            b = self.block
            for f in frames:
                if f["carrier"] in self.voice_watch and "_voice_params" in f:
                    a = f.get("_voice_audio")
                    self.voice.append((
                        b, f["carrier"], int(f["stream_symbol"]),
                        np.array(f["_voice_params"], np.int16),
                        None if a is None else np.array(a, np.float32)))

        runner.frames_of = frames_of_rec
        pipe._synth_voice = synth_rec

    # -- spans ----------------------------------------------------------------

    def install_spans(self, pipe, points: dict) -> None:
        import torch
        cuda = pipe.device.type == "cuda"
        for name, pt in points.items():
            obj = resolve(pipe, pt["on"])
            fn = getattr(obj, pt["method"])
            setattr(obj, pt["method"],
                    self._span(name, fn, pt["clock"], cuda, torch))

    def _span(self, name, fn, clock, cuda, torch):
        label = "bm." + name

        def wrapped(*a, **k):
            with torch.profiler.record_function(label):
                if clock == "cuda" and cuda:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    t0 = time.perf_counter()
                    e0.record()
                    out = fn(*a, **k)
                    e1.record()
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    self.spans[name].append((t0, t1, e0.elapsed_time(e1)))
                    return out
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if clock in ("sync", "cuda") and cuda:
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                self.spans[name].append((t0, t1, None))
                return out
        return wrapped

    def span_ms(self, name: str, t_lo: float, t_hi: float) -> float | None:
        """Total ms of a span's calls that started in [t_lo, t_hi) (device
        ms where the span has them), or None if none did."""
        rows = [r for r in self.spans.get(name, ()) if t_lo <= r[0] < t_hi]
        if not rows:
            return None
        return float(sum(r[2] if r[2] is not None else (r[1] - r[0]) * 1e3
                         for r in rows))
