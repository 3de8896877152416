"""classic.scan_ms (ms a block, layer: block step): the device
milliseconds of the program's span "scan" inside "step" on the classic
chain (DecodeRunner._block_classic: the bit interleave after the carried
tail, the sync + CRC scan, the tail slide and the compaction of the
scan outputs), two CUDA events read in DecodeRunner.fetch.  None on the
fused chain, on the CPU and on a program without the span."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    # the mean over the window's blocks the tracer kept: it keeps the last
    # 1,024, and a window of this cell can hold more
    blocks = progtrace._window(run)
    vals = [b.device_ms["scan"] for b in blocks
            if "scan" in b.device_ms]
    return sum(vals) / len(blocks) if vals else None
