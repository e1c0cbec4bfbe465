"""Median of the engine's own ``RequestRecord.queue_wait_s`` (enqueue to
dispatch) over the requests dispatched in phase A of a traced run."""
import numpy as np


def read(run):
    a0, a1 = run.phase_a
    waits = [r.queue_wait_s for r in run.engine.metrics.records
             if a0 <= r.t_dispatch < a1]
    return float(np.median(waits)) * 1e3 if waits else None
