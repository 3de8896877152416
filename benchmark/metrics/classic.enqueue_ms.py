"""classic.enqueue_ms (ms a block, layer: block step): the host
milliseconds of the program's spans "frontend", "timing" and "scan"
together: the time the host takes to issue the classic chain's step (its
launch route; the spans add no synchronize).  None on the fused chain
and on a program without the spans."""

from tebench import progtrace

progtrace.switch_on()

SPAN_NAMES = ("frontend", "timing", "scan")


def compute(run):
    # the mean over the window's blocks the tracer kept: it keeps the last
    # 1,024, and a window of this cell can hold more
    blocks = progtrace._window(run)
    vals = [b.ms(n) for b in blocks for n in SPAN_NAMES
            if any(s[0] == n for s in b.spans)]
    return sum(vals) / len(blocks) if vals else None
