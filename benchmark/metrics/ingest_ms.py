"""ingest_ms (ms a block, layer: copy to the card): DecodeRunner.ingest,
host clock to a synchronize after the call, over the window's blocks."""

SPANS = ("ingest",)


def compute(run):
    return run.span_ms_per_block(*SPANS)
