"""Microseconds a bucket step of ``pool.run_microbatch`` (the launch to
the device's sync), over every launch of phase A."""


def read(run):
    ls = [r for r in run.launches if r["phase"] == "A"]
    steps = sum(r["bucket"] for r in ls)
    return sum(r["pool_s"] for r in ls) / steps * 1e6 if steps else None
