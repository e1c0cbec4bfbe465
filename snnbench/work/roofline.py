"""A kernel's share of its roofline over phase B of a traced run."""
from snnbench.trace import kernel_time


def share(run, work):
    """Percent: the bound of the calls the phase's launches imply, over the
    profiled device time of the kernel's calls.  Where the profiler
    recorded fewer calls than the launches imply (it can drop records,
    never add), the bound is scaled to the calls it recorded.  None where
    the kernel did not run."""
    if not run.profile:
        return None
    t, calls = kernel_time(run.profile, work.NAMES)
    bound, implied = 0.0, 0
    for rec in run.launches:
        if rec["phase"] != "B":
            continue
        per = run.per_step(work, rec["model"], rec["batch"])
        bound += rec["bucket"] * sum(per)
        implied += rec["bucket"] * len(per)
    if not calls or not implied or t <= 0:
        return None
    return 100.0 * bound * min(1.0, calls / implied) / t
