"""The arithmetic of the end-to-end metrics, from the harness's own
timestamps (never the engine's metrics)."""
from __future__ import annotations

import numpy as np


def quantile(values, q: float) -> float:
    """The ``q`` quantile by linear interpolation between order statistics."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def latencies_ms(window) -> np.ndarray:
    """Milliseconds from due to reply of every served request that was due
    inside the window."""
    return np.array([(r.t_reply - r.t_due) * 1e3 for r in window.requests
                     if r.kind == "ok" and r.t_due < window.t_end])


def steps_per_s(window, sched) -> float:
    """True steps of the requests that completed inside the window, over
    the window's whole length: a stall anywhere in it lowers the rate."""
    done = sum(int(sched.steps[r.index]) for r in window.requests
               if r.kind == "ok" and r.t_reply <= window.t_end)
    return done / window.seconds


def failed(window) -> int:
    """Requests due in the window that were shed, failed or never answered."""
    return sum(r.kind != "ok" for r in window.requests if r.t_due < window.t_end)

