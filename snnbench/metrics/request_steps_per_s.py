"""True (unpadded) steps of the requests completed inside the window,
over the window's whole length."""
from snnbench.stats import steps_per_s


def read(run):
    return steps_per_s(run.window, run.sched)
