"""95th percentile of the latency of the requests due in the window,
from when each was due to its reply (served requests; a shed or failed
one is counted in ``failed`` instead)."""
from snnbench.stats import latencies_ms, quantile


def read(run):
    lat = latencies_ms(run.window)
    return quantile(lat, 0.95) if len(lat) else None
