"""The program's own spans and counters, a block at a time.

The program (``tetraear_tpu_torch.runtime.profiling``) keeps a process-
wide tracer: off by default; on, a record of each ``process_block`` (its
root span ``block``, the spans inside it on ``time.perf_counter``, the
step's CUDA-event milliseconds and the block's counters).  Importing
this module switches it on.  The harness imports a per-layer metric's
reader only in a traced run (``cells.span_points``, before the warm-up
blocks, and ``metrics_of``), so the program traces itself in every
traced run and in no untraced one; each reader also calls ``switch_on``
when it is loaded.  The harness switches it off once the window has
closed (``switch_off``), before the blocks that end the judged span on
a whole cycle.

A reading covers the blocks whose ``block`` span started in the window
``[run.t_lo, run.t_hi)`` and is divided by ``run.blocks``, as
``Run.span_ms_per_block`` is.  A program without the tracer, or a
window without the span or counter, reads None, and the metric is left
out of the line.
"""

from __future__ import annotations


def _tracer():
    try:
        from tetraear_tpu_torch.runtime import profiling
    except ImportError:
        return None
    get = getattr(profiling, "tracer", None)
    return None if get is None else get()


def switch_on() -> None:
    tr = _tracer()
    if tr is not None:
        tr.enable()


def switch_off() -> None:
    """Stop recording blocks (the harness's blocks past the window must
    not push the window's out of the tracer's ring)."""
    tr = _tracer()
    if tr is not None:
        tr.enable(False)


switch_on()


def _window(run) -> list:
    tr = _tracer()
    if tr is None or not run.blocks or run.t_lo is None:
        return []
    return tr.window(run.t_lo, run.t_hi)


def ms_per_block(run, *spans, device: bool = False) -> float | None:
    """Milliseconds a window block of the named spans: host time, or
    with ``device`` the CUDA-event time of those that recorded it."""
    blocks = _window(run)
    if device:
        vals = [b.device_ms[n] for b in blocks for n in spans
                if n in b.device_ms]
    else:
        vals = [b.ms(n) for b in blocks for n in spans
                if any(s[0] == n for s in b.spans)]
    if not vals:
        return None
    return sum(vals) / run.blocks


def count_per_block(run, name: str) -> float | None:
    """A counter's count a window block."""
    vals = [b.counts[name] for b in _window(run) if name in b.counts]
    if not vals:
        return None
    return sum(vals) / run.blocks
