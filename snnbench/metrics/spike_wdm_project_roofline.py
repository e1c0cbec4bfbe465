"""``spike_wdm_project``'s share of its roofline over phase B of a traced run, in
percent: the bound of each call (``work/spike_wdm_project.py``) summed over the
calls the launches imply, over the device time of the kernel's calls."""
from snnbench.work import spike_wdm_project as work
from snnbench.work.roofline import share


def read(run):
    return share(run, work)
