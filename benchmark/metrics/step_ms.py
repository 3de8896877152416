"""step_ms (ms a block, layer: block step): DecodeRunner.step timed by
CUDA events around the call, over the window's blocks."""

SPANS = ("step",)


def compute(run):
    return run.span_ms_per_block(*SPANS)
