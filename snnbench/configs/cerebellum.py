"""Frozen copy of the cerebellum scaffold generator (``build_cerebellum``
and ``random_sparse_projection`` of the port's ``scaffold/cerebellum.py``
and ``core/layer.py``), NumPy only, driven by the recipe in the
configuration's JSON (the port's ``CEREBELLUM`` as data).

Same draws in the same order (one ``np.random.default_rng(seed + k)``
stream for projection ``k``), so the same configuration gives the port's
CSR arrays byte for byte.
"""
from __future__ import annotations

import numpy as np

#: mean magnitude of the int8 weights (uniform 1..127): scales thresholds
MEAN_WEIGHT = 64.0


def sizes(recipe: dict, n_neurons: int) -> dict:
    """``n_neurons`` split by fraction, largest remainders first, each
    population at least ``min_pop_size``."""
    pops = recipe["populations"]
    floor = {p["name"]: max(recipe["min_pop_size"],
                            int(p["fraction"] * n_neurons)) for p in pops}
    by_rem = sorted(pops, key=lambda p: p["fraction"] * n_neurons
                    - int(p["fraction"] * n_neurons), reverse=True)
    short = n_neurons - sum(floor.values())
    for p in by_rem:
        if short <= 0:
            break
        floor[p["name"]] += 1
        short -= 1
    return floor


def sparse_projection(n_source, n_target, density, delay_range, *, seed,
                      inhibitory_fraction):
    """CSR ``(indptr, indices, weights, delays)``: per-row binomial counts,
    sorted distinct targets, signed int8-magnitude weights, one delay per
    source row."""
    rng = np.random.default_rng(seed)
    counts = rng.binomial(n_target, density, size=n_source).astype(np.int64)
    indptr = np.zeros(n_source + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(int(indptr[-1]), np.int64)
    for r in range(n_source):
        if counts[r]:
            indices[indptr[r]:indptr[r + 1]] = np.sort(
                rng.choice(n_target, size=counts[r], replace=False))
    nnz = int(indptr[-1])
    mag = rng.integers(1, 128, size=nnz).astype(np.float64)
    sign = np.where(rng.random(nnz) < inhibitory_fraction, -1.0, 1.0)
    per_src = rng.integers(1, delay_range + 1, size=n_source)
    return indptr, indices, mag * sign, np.repeat(per_src, counts).astype(np.int64)


def generate(cfg: dict) -> dict:
    recipe, n = cfg["recipe"], cfg["n_neurons"]
    size = sizes(recipe, n)
    drive = {p["name"]: 0.0 for p in recipe["populations"]}
    for e in recipe["projections"]:
        density = min(1.0, float(e["convergence"]) / size[e["pre"]])
        drive[e["post"]] += (density * size[e["pre"]]
                             * (1.0 - e["inhibitory_fraction"]) * MEAN_WEIGHT)
    pops = []
    for p in recipe["populations"]:
        if p["input"]:
            pops.append({"name": p["name"], "size": size[p["name"]],
                         "alpha": None, "v_th": None})
        else:
            v_th = max(1.0, round(recipe["v_th_sensitivity"] * drive[p["name"]]))
            pops.append({"name": p["name"], "size": size[p["name"]],
                         "alpha": float(p["alpha"]), "v_th": float(v_th)})
    projs = []
    for k, e in enumerate(recipe["projections"]):
        s, t = size[e["pre"]], size[e["post"]]
        density = min(1.0, float(e["convergence"]) / s)
        indptr, indices, w, d = sparse_projection(
            s, t, density, e["delay_range"], seed=cfg["seed"] + k,
            inhibitory_fraction=e["inhibitory_fraction"])
        projs.append({"name": f"{e['pre']}->{e['post']}", "pre": e["pre"],
                      "post": e["post"], "n_source": s, "n_target": t,
                      "delay_range": int(e["delay_range"]), "indptr": indptr,
                      "indices": indices, "weights": w, "delays": d})
    return {"name": f"cerebellum-{n}-s{cfg['seed']}", "chain": False,
            "populations": pops, "projections": projs}
