"""voice_ms.spans (ms a block, layer: voice): the program's spans
"voice_prepare" (Pipeline._prepare_voice_batch, V1) and "voice_synth"
(Pipeline._synth_voice, the device speech pool, V2), the twin of
voice_ms.live."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.ms_per_block(run, "voice_prepare", "voice_synth")
