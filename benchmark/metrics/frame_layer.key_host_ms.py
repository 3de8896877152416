"""frame_layer.key_host_ms (ms a block, layer: host frame layer): the
program's spans "key_plan" (the key plans, key and payload matrices) and
"key_score" (the _select_decrypt + _post_decrypt_sds loop) of
crypto/batch.batch_decrypt_frames."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.ms_per_block(run, "key_plan", "key_score")
