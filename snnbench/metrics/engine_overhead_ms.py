"""Mean a launch, over phase A, of the span around ``supervisor.run``
less the time inside it spent in ``pool.run_microbatch``: admission of
the result, validation, host copies and trimming."""


def read(run):
    ls = [r for r in run.launches if r["phase"] == "A"]
    if not ls:
        return None
    return sum(r["sup_s"] - r["pool_s"] for r in ls) / len(ls) * 1e3
