"""The benchmark's own description of a network: plain dicts of NumPy
arrays, made by a configuration's generator and handed to both the port
(``system.py`` builds its ``SNNNetwork`` from it) and the reference.

A graph is ``{"name", "chain", "populations", "projections"}``:

* ``populations``: ``{"name", "size", "alpha", "v_th"}`` in declared
  order; an input population has ``alpha`` and ``v_th`` ``None``.
* ``projections``: ``{"name", "pre", "post", "n_source", "n_target",
  "delay_range", "indptr", "indices", "weights", "delays"}`` — CSR by
  source row, targets sorted in a row, signed integer weights, delays in
  ``[1, delay_range]``; a chain's projections also keep ``dense``, the
  ``(weights, delays)`` arrays the port's dense layers are made of.
"""
from __future__ import annotations

import numpy as np


def csr_from_dense(weights: np.ndarray, delays: np.ndarray):
    """``(indptr, indices, weights, delays)`` of a dense layer's synapses."""
    rows, cols = np.nonzero(weights)
    indptr = np.zeros(weights.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=weights.shape[0]), out=indptr[1:])
    return (indptr, cols.astype(np.int64), weights[rows, cols],
            delays[rows, cols].astype(np.int64))


def chain_graph(name, layers, delay_range, alpha, v_th) -> dict:
    """A feed-forward chain of dense ``(weights, delays)`` layers; the
    populations are named ``<name>.p<k>`` as the port names a chain's."""
    sizes = [layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]
    pops = [{"name": f"{name}.p{k}", "size": int(s),
             "alpha": None if k == 0 else float(alpha),
             "v_th": None if k == 0 else float(v_th)}
            for k, s in enumerate(sizes)]
    projs = []
    for i, (w, d) in enumerate(layers):
        indptr, indices, values, dly = csr_from_dense(w, d)
        projs.append({
            "name": f"{name}.l{i}", "pre": pops[i]["name"],
            "post": pops[i + 1]["name"], "n_source": int(w.shape[0]),
            "n_target": int(w.shape[1]), "delay_range": int(delay_range),
            "indptr": indptr, "indices": indices, "weights": values,
            "delays": dly, "dense": (w, d),
        })
    return {"name": name, "chain": True, "populations": pops,
            "projections": projs}


def input_slices(graph: dict):
    """Per input population (no in-projection), in declared order: its
    index and its ``(start, stop)`` columns of the concatenated train."""
    driven = {e["post"] for e in graph["projections"]}
    out, start = [], 0
    for k, p in enumerate(graph["populations"]):
        if p["name"] not in driven:
            out.append((k, (start, start + p["size"])))
            start += p["size"]
    return out


def n_input(graph: dict) -> int:
    return sum(b - a for _, (a, b) in input_slices(graph))


def out_degrees(proj: dict) -> np.ndarray:
    """Synapses of each source neuron."""
    return np.diff(proj["indptr"])
