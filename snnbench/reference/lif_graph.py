"""Plain LIF-graph simulator over CSR synapses, in plain PyTorch.

The semantics (Eq. 1 of the paper, as the port documents them):

* every spike of a source neuron at step ``t`` crosses each of its
  synapses of delay ``d`` and adds the synapse's weight to the target's
  current at step ``t + d``; a back-edge (a self-loop or a projection onto
  a population not after its source in the topological order) reads the
  source's spikes of step ``t - 1`` instead, so it arrives a step later;
* a population sums its in-projections' currents and updates
  ``v' = (i + alpha*v) - z*v_th``, each operation rounded on its own in
  the simulator's precision, and fires ``z' = [v' >= v_th]``;
* input populations (no in-projection) read their columns of the
  concatenated input train, in declared order.

The topological order is Kahn's over forward edges with ties broken by
declared order; a stall is broken at the earliest-declared population of
a cycle that nothing outside it still feeds.

Nothing is densified: each projection is a list of synapses, and a step
gathers its sources' spikes, scales them by the weights and adds them
into the target's delay ring with ``index_add_``.  Weights are integers
of int8 magnitude, so in float32 every current is an exact integer and
the order of the additions does not matter.  ``dtype=torch.bfloat16``
runs the same arithmetic one precision lower (the benchmark's control).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def graph_order(graph: dict):
    """``(topological order, back-edge indices, in-edges per population)``."""
    pops = [p["name"] for p in graph["populations"]]
    idx = {name: k for k, name in enumerate(pops)}
    ends = [(idx[e["pre"]], idx[e["post"]]) for e in graph["projections"]]
    n = len(pops)
    preds = [set() for _ in range(n)]
    for s, t in ends:
        if s != t:
            preds[t].add(s)
    placed: set = set()
    order: List[int] = []
    while len(order) < n:
        left = [k for k in range(n) if k not in placed]
        ready = [k for k in left if preds[k] <= placed]
        pick = min(ready) if ready else _cycle_head(left, preds)
        placed.add(pick)
        order.append(pick)
    pos = {p: k for k, p in enumerate(order)}
    back = frozenset(i for i, (s, t) in enumerate(ends) if pos[t] <= pos[s])
    in_edges = [[i for i, (_, t) in enumerate(ends) if t == p] for p in range(n)]
    return order, back, in_edges


def _cycle_head(left, preds) -> int:
    """The earliest-declared population of a cycle among ``left`` that no
    population of ``left`` outside the cycle feeds."""
    left_set = set(left)

    def reach(u):
        seen, stack = set(), [u]
        while stack:
            x = stack.pop()
            for y in left:
                if x in preds[y] and y not in seen:
                    seen.add(y)
                    stack.append(y)
        return seen

    reached = {u: reach(u) for u in left}
    heads = []
    for u in left:
        cycle = {u} | {v for v in reached[u] if u in reached[v]}
        if all(q in cycle or q not in left_set for v in cycle for q in preds[v]):
            heads.append(u)
    return min(heads)


class Simulator:
    """One network on one device in one precision; :meth:`run` simulates a
    block of lanes."""

    def __init__(self, graph: dict, *, device="cpu", dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.sizes = [p["size"] for p in graph["populations"]]
        self.lif = [(p["alpha"], p["v_th"]) for p in graph["populations"]]
        self.order, self.back, self.in_edges = graph_order(graph)
        names = {p["name"]: k for k, p in enumerate(graph["populations"])}
        driven = {e["post"] for e in graph["projections"]}
        self.inputs, start = {}, 0
        for k, p in enumerate(graph["populations"]):
            if p["name"] not in driven:
                self.inputs[k] = (start, start + p["size"])
                start += p["size"]
        self.n_input = start
        self.edges = []
        for e in graph["projections"]:
            rows = np.repeat(np.arange(e["n_source"]), np.diff(e["indptr"]))
            slots = e["delay_range"] + 1
            tgt = torch.as_tensor(e["indices"], device=self.device)
            dly = torch.as_tensor(e["delays"], device=self.device)
            # the flat ring row of each synapse for each phase t % slots
            rows_by_phase = [((t + dly) % slots) * e["n_target"] + tgt
                             for t in range(slots)]
            self.edges.append({
                "src": names[e["pre"]], "tgt": names[e["post"]],
                "n": e["n_target"], "slots": slots,
                "rows": torch.as_tensor(rows, device=self.device),
                "w": torch.as_tensor(np.asarray(e["weights"], np.float32),
                                     device=self.device).to(dtype),
                "ring_rows": rows_by_phase,
            })
        #: projection i's output is population ``post_of[i]``'s train
        self.post_of = self.posts(graph)

    @staticmethod
    def posts(graph: dict) -> List[int]:
        """Per projection: the index of its target population."""
        names = {p["name"]: k for k, p in enumerate(graph["populations"])}
        return [names[e["post"]] for e in graph["projections"]]

    def run(self, spikes: torch.Tensor) -> List[torch.Tensor]:
        """``spikes`` ``(T, B, n_input)`` 0/1 -> each population's ``(T, B,
        N)`` uint8 train (an input population's is its input)."""
        T, B, width = spikes.shape
        if width != self.n_input:
            raise ValueError(f"spikes must be (T, B, {self.n_input})")
        dt, dev = self.dtype, self.device
        x = spikes.to(device=dev, dtype=dt).permute(0, 2, 1)     # (T, S, B)
        rings = [torch.zeros((e["slots"] * e["n"], B), dtype=dt, device=dev)
                 for e in self.edges]
        v = {p: torch.zeros((self.sizes[p], B), dtype=dt, device=dev)
             for p in self.order if p not in self.inputs}
        z = {p: torch.zeros_like(v[p]) for p in v}
        trains = [torch.zeros((T, B, n), dtype=torch.uint8, device=dev)
                  for n in self.sizes]
        prev = [torch.zeros((n, B), dtype=dt, device=dev) for n in self.sizes]
        for t in range(T):
            cur = [None] * len(self.sizes)
            for p, (a, b) in self.inputs.items():
                cur[p] = x[t, a:b]
            for p in self.order:
                if p in self.inputs:
                    continue
                i = torch.zeros_like(v[p])
                for ei in self.in_edges[p]:
                    e, ring = self.edges[ei], rings[ei]
                    src = prev[e["src"]] if ei in self.back else cur[e["src"]]
                    contrib = src.index_select(0, e["rows"]) * e["w"][:, None]
                    ring.index_add_(0, e["ring_rows"][t % e["slots"]], contrib)
                    now = ring[(t % e["slots"]) * e["n"]:][: e["n"]]
                    i = i + now
                    now.zero_()
                alpha, v_th = self.lif[p]
                decayed = v[p] * alpha
                charged = i + decayed
                reset = z[p] * v_th
                v[p] = charged - reset
                z[p] = (v[p] >= v_th).to(dt)
                cur[p] = z[p]
            for p in range(len(self.sizes)):
                trains[p][t] = cur[p].t().to(torch.uint8)
            prev = cur
        return trains
