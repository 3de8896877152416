"""frame_layer.key_device_ms (ms a block, layer: host frame layer): the
program's span "tea" (crypto/batch.tea_decrypt_families: the upload, the
tea_search launch and the fetch), host clock."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.ms_per_block(run, "tea")
