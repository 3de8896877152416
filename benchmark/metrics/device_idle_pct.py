"""device_idle_pct (%, layer: device): the share of the traced stretch in
which the card ran no kernel, copy or memset."""


def compute(run):
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
