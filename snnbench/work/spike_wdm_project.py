"""K2, ``spike_wdm_project``: one parallel projection's step, the int8
weight-delay map times the spikes its columns gather from the ring.

The map has a row a target and a column a distinct (source, delay) pair
of the projection's synapses.  A call reads the (M, K) int8 map once, its
K column sources and delays (int32 each), one int8 ring byte a column and
lane, and writes the (lanes, M) f32 current; it does 2 M K operations a
lane, at the int8 tensor-core peak.  Counted from the benchmark's graph;
of the program only which projections run parallel (``forms``).
"""
import numpy as np

from snnbench.work.peaks import INT8_OPS_S, bound_s

#: substrings of the kernel's names in the device trace
NAMES = ("wdm_kernel<true",)


def per_step(graph: dict, forms, batch: int):
    """Bound seconds of each call in one step of a launch at ``batch``."""
    out = []
    for e, form in zip(graph["projections"], forms):
        if form != "-":
            continue
        src = np.repeat(np.arange(e["n_source"]), np.diff(e["indptr"]))
        k = len(np.unique(e["delays"] * e["n_source"] + src))
        m = e["n_target"]
        n_bytes = m * k + 8 * k + batch * k + 4 * batch * m
        out.append(bound_s(2 * m * k * batch, n_bytes, INT8_OPS_S))
    return out
