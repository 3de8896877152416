"""frame_layer.candidates (a block, layer: host frame layer): the
program's counter "candidates", the windows collect_hits hands to the
parse and decode_candidates."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.count_per_block(run, "candidates")
