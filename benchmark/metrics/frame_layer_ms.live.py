"""frame_layer_ms (ms a block, layer: host frame layer): DecodeRunner.
frames_of (hit parse, frame decode, the deferred key search) plus
Pipeline._handle_frame, host clock, over the window's blocks."""

SPANS = ("frames_of", "handle_frame")


def compute(run):
    return run.span_ms_per_block(*SPANS)
