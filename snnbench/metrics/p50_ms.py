"""Median latency of the requests due in the window, from due to reply."""
from snnbench.stats import latencies_ms, quantile


def read(run):
    lat = latencies_ms(run.window)
    return quantile(lat, 0.5) if len(lat) else None
