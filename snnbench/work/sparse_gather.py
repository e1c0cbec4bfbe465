"""K3, ``sparse_gather``: one serial projection's step in the sparse form,
each (delay, target) pair's synapses gathering their sources' spikes.

A call reads each stored synapse once (an f32 weight and an int32 source,
8 bytes), a lane's f32 spike of each source that has a synapse, and
writes a lane's f32 current of each (delay, target) pair that has one;
it does 2 operations a synapse and lane, at the f32 peak.  Counted from
the benchmark's graph, never from the program's padded operands; of the
program only which projections run in the sparse form (``forms``).
"""
import numpy as np

from snnbench.work.peaks import F32_FLOPS_S, bound_s

NAMES = ("gather_lanes_kernel", "gather_cols_kernel")


def per_step(graph: dict, forms, batch: int):
    """Bound seconds of each call in one step of a launch at ``batch``."""
    out = []
    for e, form in zip(graph["projections"], forms):
        if form != "sparse":
            continue
        nnz = len(e["indices"])
        sources = int(np.count_nonzero(np.diff(e["indptr"])))
        rows = len(np.unique(e["delays"] * e["n_target"] + e["indices"]))
        n_bytes = 8 * nnz + 4 * batch * (sources + rows)
        out.append(bound_s(2 * nnz * batch, n_bytes, F32_FLOPS_S))
    return out
