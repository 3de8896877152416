"""fetch_ms (ms a block, layer: copy to the host): the program's span
"fetch" (DecodeRunner.fetch): the wait for the step and the copy of its
outputs to the host."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.ms_per_block(run, "fetch")
