"""The whole launch's share of the chip's peak, in percent: the least
time its counted work needs (``work/step.py``: from the network, the
requests and their spikes, whatever kernel runs it) over the span around
``supervisor.run``, summed over the launches of phase A."""


def read(run):
    ls = [r for r in run.launches if r["phase"] == "A" and "bound_s" in r]
    wall = sum(r["sup_s"] for r in ls)
    return 100.0 * sum(r["bound_s"] for r in ls) / wall if wall else None
