"""frame_layer.crc_yield_pct (%, layer: host frame layer): CRC passes
(PipelineStats.crc_pass, a window block) over the program's counter
"candidates": the share of the windows parsed that passed the CRC."""

from tebench import progtrace

progtrace.switch_on()


def compute(run):
    cands = progtrace.count_per_block(run, "candidates")
    if not cands:
        return None
    return 100.0 * run.counts["crc_pass"] / cands
