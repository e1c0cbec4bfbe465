"""``lif_step``'s share of its roofline over phase B of a traced run, in
percent: the bound of each call (``work/lif_step.py``) summed over the
calls the launches imply, over the device time of the kernel's calls."""
from snnbench.work import lif_step as work
from snnbench.work.roofline import share


def read(run):
    return share(run, work)
