"""classic.timing_ms (ms a block, layer: block step): the device
milliseconds of the program's span "timing" inside "step" on the classic
chain (CarrierBankDemod._timing: timing recovery, the AFC loop and
DQPSK), two CUDA events read in DecodeRunner.fetch.  None on the fused
chain, on the CPU and on a program without the span."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    # the mean over the window's blocks the tracer kept: it keeps the last
    # 1,024, and a window of this cell can hold more
    blocks = progtrace._window(run)
    vals = [b.device_ms["timing"] for b in blocks
            if "timing" in b.device_ms]
    return sum(vals) / len(blocks) if vals else None
