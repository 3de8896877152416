"""frame_layer.keys_scored (a block, layer: host frame layer): the
program's counter "keys_scored", the plaintexts the deferred key search's
selection loops scored (BYPASS entries among them)."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    return progtrace.count_per_block(run, "keys_scored")
