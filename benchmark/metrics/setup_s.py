"""setup_s (s, lower): from the process's start to the window's start:
imports, the capture made on the card, the Pipeline built (and, in a
checkout's first run, its kernels and host libraries compiled), and the
warm-up blocks or dispatch."""


def compute(run):
    return run.setup_s
