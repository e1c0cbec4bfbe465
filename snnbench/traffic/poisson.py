"""Open loop: Poisson arrivals at ``rate_hz``.  Every seed gets the same
set of exponential gaps (their quantiles), in another order."""
import numpy as np

LOOP = "open"


def count(traffic: dict, seconds: float) -> int:
    return max(1, int(round(traffic["rate_hz"] * seconds)))


def arrivals(traffic: dict, n: int, permute):
    q = (np.arange(n) + 0.5) / n
    gaps = permute(5, -np.log1p(-q) / traffic["rate_hz"])
    return np.cumsum(gaps) - gaps[0], np.full(n, -1)
