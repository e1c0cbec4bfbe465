"""Share of phase B's traced window in which no operation ran on the
device, in percent."""


def read(run):
    s = run.profile
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s else None
