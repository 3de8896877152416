"""gate_ms (ms a block, layer: detection gate): the host milliseconds of
the program's span "gate" (api.Pipeline._detect_signal: the FFT of the
block's first samples and the hysteresis), over the window's blocks.
None where the gate is off and on a program without the span."""

from tebench import progtrace

progtrace.switch_on()

SPAN_NAMES = ("gate",)


def compute(run):
    # the mean over the window's blocks the tracer kept: it keeps the last
    # 1,024, and a window of this cell can hold more
    blocks = progtrace._window(run)
    vals = [b.ms(n) for b in blocks for n in SPAN_NAMES
            if any(s[0] == n for s in b.spans)]
    return sum(vals) / len(blocks) if vals else None
