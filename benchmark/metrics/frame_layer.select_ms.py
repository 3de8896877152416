"""frame_layer.select_ms (ms a block, layer: host frame layer): the
program's spans "assemble" (BatchedFrameDecoder.assemble), "hits"
(framescan.hits_from_keys) and "select" (collect_hits: the threshold
cascade and the dedup)."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.ms_per_block(run, "assemble", "hits", "select")
