"""kernels.roofline_pct (%, layer: kernels): the block step's least time
on one H100 (tebench.roofline, from the configuration's sample rate, C
and block) times the traced steps, over the device time of the kernels
that ran inside those steps in the device trace."""

from tebench import roofline

SPANS = ("step",)


def compute(run):
    if run.trace is None:
        return None
    kernel_s, n_steps = run.trace["kernels_in"].get("step", (0.0, 0))
    if not n_steps or kernel_s <= 0:
        return None
    least, _ = roofline.least_step_s(run.fs, run.n_carriers, run.block_len)
    return 100.0 * least * n_steps / kernel_s
