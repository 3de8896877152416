"""frame_layer.parse_ms (ms a block, layer: host frame layer): the
program's spans "parse" (hitparse.parse_windows, the native parse of every
candidate window) and "decode" (decode_candidates: decode_frame and the
MAC parse)."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.ms_per_block(run, "parse", "decode")
