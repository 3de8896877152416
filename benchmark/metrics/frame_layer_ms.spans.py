"""frame_layer_ms.spans (ms a block, layer: host frame layer): the
program's spans "frames_of" (DecodeRunner.frames_of) and "handle_frames"
(the _handle_frame loop of process_block), the twin of
frame_layer_ms.live."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.ms_per_block(run, "frames_of", "handle_frames")
