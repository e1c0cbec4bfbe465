"""K1, ``lif_step``: one population's step: each serial in-edge's update
delivered through its delay ring, the in-edge currents summed, the LIF
update and the spike row.

A neuron and lane costs 4 bytes a current in-edge, 12 bytes a slot of
each ring it updates, and 14 bytes of carry and output; and one
operation a ring slot, one a current after the first, and 5 for the
update, at the f32 peak.  Counted from the benchmark's graph; of the
program only which projections run serial (``forms``).
"""
from snnbench.work.peaks import F32_FLOPS_S, bound_s

NAMES = ("lif_step_kernel",)


def per_step(graph: dict, forms, batch: int):
    """Bound seconds of each call in one step of a launch at ``batch``:
    one a population with in-edges; ``forms[i]`` is projection ``i``'s
    kernel form (``"-"``: parallel)."""
    projs = graph["projections"]
    out = []
    for pop in graph["populations"]:
        edges = [i for i, e in enumerate(projs) if e["post"] == pop["name"]]
        if not edges:
            continue
        rings = [projs[i]["delay_range"] + 1 for i in edges if forms[i] != "-"]
        per = 4 * (len(edges) - len(rings)) + 12 * sum(rings) + 14
        ops = sum(rings) + len(edges) - 1 + 5
        n = batch * pop["size"]
        out.append(bound_s(ops * n, per * n, F32_FLOPS_S))
    return out
