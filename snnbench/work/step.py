"""The whole launch's least work, counted from the network, the requests
and their spikes, whatever kernels the program runs it with.

A request of ``steps`` steps must read its input spikes and write every
population's spikes, at least a bit each: ``steps * (inputs + neurons) /
8`` bytes.  It must do at least 3 operations a neuron and step for the
LIF update (scale, add, reset) and one a synaptic event: a spike of a
source at a step from which every delay of the projection still lands
inside the request.  The bound is the larger of the operations over the
int8 peak and the bytes over the memory bandwidth.
"""
from __future__ import annotations

import numpy as np

from snnbench.graph import input_slices, out_degrees
from snnbench.reference import graph_order
from snnbench.work.peaks import INT8_OPS_S, bound_s


class StepWork:
    """Counts for one graph, reused across requests."""

    def __init__(self, graph: dict):
        self.graph = graph
        names = {p["name"]: k for k, p in enumerate(graph["populations"])}
        _, back, _ = graph_order(graph)
        self.inputs = dict(input_slices(graph))
        self.sizes = [p["size"] for p in graph["populations"]]
        self.neurons = sum(s for k, s in enumerate(self.sizes) if k not in self.inputs)
        self.n_input = sum(b - a for a, b in self.inputs.values())
        self.edges = [(names[e["pre"]], e["delay_range"] + (i in back),
                       out_degrees(e).astype(np.float64))
                      for i, e in enumerate(graph["projections"])]
        self.post = [names[e["post"]] for e in graph["projections"]]

    def request(self, payload: np.ndarray, reply) -> tuple:
        """``(ops, bytes)`` of one served request: ``payload`` its ``(steps,
        width)`` input, ``reply`` its per-projection trains."""
        steps = payload.shape[0]
        trains = {p: np.asarray(z) for p, z in zip(self.post, reply)}
        for k, (a, b) in self.inputs.items():
            x = np.zeros((steps, b - a), np.float32)
            part = payload[:, a:b]
            x[:, : part.shape[1]] = part
            trains[k] = x
        sums, events = {}, 0.0
        for src, late, deg in self.edges:
            cut = steps - late
            if cut <= 0:
                continue
            key = (src, cut)
            if key not in sums:
                sums[key] = trains[src][:cut].sum(axis=0, dtype=np.float64)
            events += float(sums[key] @ deg)
        ops = 3.0 * steps * self.neurons + events
        n_bytes = steps * (self.n_input + self.neurons) / 8.0
        return ops, n_bytes

    @staticmethod
    def bound(ops: float, n_bytes: float) -> float:
        return bound_s(ops, n_bytes, INT8_OPS_S)
