"""voice.evictions (a block, layer: voice): the program's counter
"v2_evictions", the decoder slots the device speech pool took from a
carrier for another (DeviceSpeechPool._run)."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.count_per_block(run, "v2_evictions")
