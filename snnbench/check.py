"""How ``correct`` is decided: the replies the timed window served, held
against the plain reference run over the same payloads.

Every number here is an exact count with the limit 0: the weights are
integers of int8 magnitude, so in float32 every current is an exact
integer and a served spike that differs from the reference's is a fault.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from snnbench.reference import Simulator

#: the numbers compared, each with its limit (a run is correct when each
#: is within it); ``replies_compared`` must reach its limit instead
LIMITS = {"mismatched_spikes": 0, "missing_replies": 0, "replies_compared": 1}


def _lanes(graph: dict) -> int:
    """Lanes a block: the largest projection's gathered (synapses, lanes)
    product kept near 2**27 elements."""
    nnz = max(len(e["indices"]) for e in graph["projections"])
    return max(1, min(1024, (1 << 27) // max(1, nnz)))


def _blocks(graph: dict, sched, indices: List[int], device, dtypes):
    """Yield ``(block indices, {dtype: per-population trains on the host})``
    for the requests ``indices``, longest first, a block of lanes at once."""
    sims = {dt: Simulator(graph, device=device, dtype=dt) for dt in dtypes}
    order = sorted(indices, key=lambda i: -int(sched.steps[i]))
    lanes = _lanes(graph)
    for b0 in range(0, len(order), lanes):
        block = order[b0:b0 + lanes]
        x = np.zeros((int(sched.steps[block[0]]), len(block), sched.n_input), np.uint8)
        for b, i in enumerate(block):
            p = sched.payload(i)
            x[: p.shape[0], b, : p.shape[1]] = p
        xt = torch.as_tensor(x, device=device)
        yield block, {dt: [t.cpu().numpy() for t in sim.run(xt)]
                      for dt, sim in sims.items()}


def compare(graph: dict, sched, win, device) -> Dict[str, int]:
    """The window's numbers: spikes of the kept replies that differ from
    the reference (a reply of the wrong shape counts whole, an entry
    neither 0 nor 1 counts), due requests that got no reply at all, and
    how many replies were compared."""
    post = Simulator.posts(graph)
    wrong = 0
    for block, trains in _blocks(graph, sched, list(win.kept), device,
                                 [torch.float32]):
        ref = trains[torch.float32]
        for b, i in enumerate(block):
            arrays, index, bad = win.kept[i]
            steps = int(sched.steps[i])
            wrong += bad
            for j, p in enumerate(post):
                want = ref[p][:steps, b]
                got = arrays[index[j]] if j < len(index) else None
                if got is None or got.shape != want.shape:
                    wrong += want.size
                else:
                    wrong += int(np.count_nonzero(got != want))
    missing = sum(r.kind == "pending" for r in win.requests)
    return {"mismatched_spikes": wrong, "missing_replies": missing,
            "replies_compared": len(win.kept)}


def control(graph: dict, sched, indices: List[int], device) -> Dict[str, int]:
    """The control's reading: the reference computed in bfloat16 (the
    precision below the configuration's float32) put in the program's
    place, held against the float32 reference on the same requests."""
    post = Simulator.posts(graph)
    wrong = 0
    for block, trains in _blocks(graph, sched, indices, device,
                                 [torch.float32, torch.bfloat16]):
        ref, low = trains[torch.float32], trains[torch.bfloat16]
        for b, i in enumerate(block):
            steps = int(sched.steps[i])
            for p in post:
                wrong += int(np.count_nonzero(ref[p][:steps, b] != low[p][:steps, b]))
    return {"mismatched_spikes": wrong, "missing_replies": 0,
            "replies_compared": len(indices)}


def is_correct(numbers: Dict[str, int]) -> bool:
    return (numbers["mismatched_spikes"] <= LIMITS["mismatched_spikes"]
            and numbers["missing_replies"] <= LIMITS["missing_replies"]
            and numbers["replies_compared"] >= LIMITS["replies_compared"])


def lines(numbers: Dict[str, int]) -> List[str]:
    """One plain line a number, with its limit."""
    out = []
    for k, v in numbers.items():
        op = ">=" if k == "replies_compared" else "<="
        out.append(f"check {k} {v} limit {op} {LIMITS[k]}")
    return out
