"""Frozen copy of the Potjans-Diesmann microcircuit generator
(``build_microcircuit`` and ``bernoulli_pairs`` of the port's
``scaffold/microcircuit.py``), NumPy only, driven by the tables in the
configuration's JSON (the port's ``MICROCIRCUIT`` as data).

Same draws in the same order (one ``np.random.default_rng([seed, k])``
stream for projection ``k``: its pairs, then its weights, then its
delays), so the same configuration gives the port's CSR arrays byte for
byte.  ``scale`` (1.0 in the benchmark; tests cut it) multiplies every
population size and every ``K_ext``, keeps every probability and scales
``v_th`` with it.
"""
from __future__ import annotations

import math

import numpy as np


def bernoulli_pairs(rng, n_source, n_target, p):
    """CSR ``(indptr, indices)``: each ``(source, target)`` pair kept with
    probability ``p``, by geometric gaps over the row-major grid."""
    total = n_source * n_target
    mean = total * p
    chunk = int(mean + 8.0 * math.sqrt(mean) + 64)
    parts, last = [], -1
    while True:
        pos = last + np.cumsum(rng.geometric(p, size=chunk))
        if pos[-1] >= total:
            parts.append(pos[: np.searchsorted(pos, total)])
            break
        parts.append(pos)
        last = int(pos[-1])
    rows, indices = np.divmod(np.concatenate(parts), n_target)
    indptr = np.zeros(n_source + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_source), out=indptr[1:])
    return indptr, indices


def sizes(cfg: dict) -> dict:
    scale = cfg["scale"]
    out = {p["name"]: max(1, int(round(p["n"] * scale))) for p in cfg["populations"]}
    return {"ext": sum(out.values()), **out}


def generate(cfg: dict) -> dict:
    scale, seed = cfg["scale"], cfg["seed"]
    size = sizes(cfg)
    names = [p["name"] for p in cfg["populations"]]
    inhibitory = {p["name"]: p["inhibitory"] for p in cfg["populations"]}
    inhibitory["ext"] = False
    alpha = float(np.float32(np.exp(-1.0 / cfg["tau_m_steps"])))
    v_th = max(1.0, float(round(cfg["v_th"] * scale)))
    w, d = cfg["weights"], cfg["delays"]
    doubled = (w["doubled"]["pre"], w["doubled"]["post"])

    edges = []
    for t, pop in enumerate(cfg["populations"]):
        edges += [(pre, pop["name"], p) for pre, p in zip(names, cfg["p"][t]) if p > 0]
        edges.append(("ext", pop["name"], pop["k_ext"] * scale / size["ext"]))
    projs = []
    for k, (pre, post, p) in enumerate(edges):
        rng = np.random.default_rng([seed, k])
        indptr, indices = bernoulli_pairs(rng, size[pre], size[post], p)
        if (pre, post) == doubled:
            w_mean, w_sd = w["doubled"]["mean_sd"]
        else:
            w_mean, w_sd = w["inh"] if inhibitory[pre] else w["exc"]
        nnz = len(indices)
        mag = np.clip(np.rint(rng.normal(w_mean, w_sd, nnz)), 1, 127)
        d_mean, d_sd = d["inh"] if inhibitory[pre] else d["exc"]
        delays = np.clip(np.rint(rng.normal(d_mean, d_sd, nnz)), 1,
                         d["range"]).astype(np.int64)
        projs.append({"name": f"{pre}->{post}", "pre": pre, "post": post,
                      "n_source": size[pre], "n_target": size[post],
                      "delay_range": int(d["range"]), "indptr": indptr,
                      "indices": indices, "weights": -mag if inhibitory[pre] else mag,
                      "delays": delays})
    pops = [{"name": "ext", "size": size["ext"], "alpha": None, "v_th": None}]
    pops += [{"name": n, "size": size[n], "alpha": alpha, "v_th": v_th} for n in names]
    return {"name": f"microcircuit-{scale:g}-s{seed}", "chain": False,
            "populations": pops, "projections": projs}
