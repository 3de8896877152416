"""frame_layer.key_fallback_pct (%, layer: host frame layer): the
program's counter "key_fallback" (plan entries of the deferred key
search whose score the card left to the host, which scored them) over
its counter "keys_scored" (plan entries scored), a window block's."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    fallback = progtrace.count_per_block(run, "key_fallback")
    scored = progtrace.count_per_block(run, "keys_scored")
    if fallback is None or not scored:
        return None
    return 100.0 * fallback / scored
