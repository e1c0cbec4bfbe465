"""The event form of a serial projection (the port's ``serial_update``):
every synaptic row's spike gathered, weighted and added into the target's
delay ring.  Its least work is the synaptic events of the step: a spike
of the projection's source times that source's out-degree, each reading a
4-byte target index and a 4-byte weight and updating a 4-byte current,
12 bytes, against the memory bandwidth.

Counted from the benchmark's graph and each request's spikes (its input,
and the reply's trains of the populations that fire); of the program only
which projections run in the event form (``forms``), never its operands.
"""
from __future__ import annotations

import numpy as np

from snnbench.graph import input_slices, out_degrees
from snnbench.work.peaks import HBM_BYTES_S

BYTES_PER_EVENT = 12
#: device ops that are not the event form's: K1, K2, K3 and every copy
OTHER = ("lif_step_kernel", "wdm_kernel", "gather_lanes_kernel",
         "gather_cols_kernel", "Memcpy")
#: the event form's one kernel a projection and step, ``index_add_``'s
INDEX_ADD = ("indexFuncLargeIndex", "indexFuncSmallIndex")


class EventWork:
    """Event counts of one graph under one tuple of forms."""

    def __init__(self, graph: dict, forms):
        names = {p["name"]: k for k, p in enumerate(graph["populations"])}
        self.inputs = dict(input_slices(graph))
        self.post = [names[e["post"]] for e in graph["projections"]]
        self.edges = [(names[e["pre"]], out_degrees(e).astype(np.float64))
                      for e, form in zip(graph["projections"], forms)
                      if form == "event"]

    def events(self, payload: np.ndarray, reply) -> float:
        """Synaptic events of one request: ``payload`` its ``(steps, width)``
        input, ``reply`` its per-projection trains."""
        trains = {p: np.asarray(z) for p, z in zip(self.post, reply)}
        total = 0.0
        for src, deg in self.edges:
            if src in self.inputs:
                a, b = self.inputs[src]
                train = np.zeros((payload.shape[0], b - a), np.float32)
                part = payload[:, a:b]
                train[:, : part.shape[1]] = part
            else:
                train = trains[src]
            total += float(train.sum(axis=0, dtype=np.float64) @ deg)
        return total

    @staticmethod
    def bound_s(events: float) -> float:
        return BYTES_PER_EVENT * events / HBM_BYTES_S
