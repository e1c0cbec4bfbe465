"""``sparse_gather``'s share of its roofline over phase B of a traced run, in
percent: the bound of each call (``work/sparse_gather.py``) summed over the
calls the launches imply, over the device time of the kernel's calls."""
from snnbench.work import sparse_gather as work
from snnbench.work.roofline import share


def read(run):
    return share(run, work)
