"""classic.frontend_ms (ms a block, layer: block step): the device
milliseconds of the program's span "frontend" inside "step" on the
classic chain (CarrierBankDemod._frontend: the mix, the polyphase
resampling and the RRC filter), two CUDA events read in
DecodeRunner.fetch.  None on the fused chain, on the CPU and on a
program without the span."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    # the mean over the window's blocks the tracer kept: it keeps the last
    # 1,024, and a window of this cell can hold more
    blocks = progtrace._window(run)
    vals = [b.device_ms["frontend"] for b in blocks
            if "frontend" in b.device_ms]
    return sum(vals) / len(blocks) if vals else None
