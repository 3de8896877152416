"""step_ms.spans (ms a block, layer: block step): the device milliseconds
of the program's span "step" (DecodeRunner.step), two CUDA events read in
DecodeRunner.fetch after its copy has synchronized; the twin of step_ms.
None on the CPU, where the span records no events."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.ms_per_block(run, "step", device=True)
