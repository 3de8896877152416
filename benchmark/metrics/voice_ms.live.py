"""voice_ms (ms a block, layer: voice): Pipeline._prepare_voice_batch
(V1 channel decoding) plus Pipeline._synth_voice (the device speech
pool, V2), host clock, over the window's blocks."""

SPANS = ("prepare_voice", "synth_voice")


def compute(run):
    return run.span_ms_per_block(*SPANS)
