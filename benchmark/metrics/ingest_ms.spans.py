"""ingest_ms.spans (ms a block, layer: copy to the card): the program's
own span "ingest" (DecodeRunner.ingest, host clock, no synchronize added),
the twin of ingest_ms."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.ms_per_block(run, "ingest")
