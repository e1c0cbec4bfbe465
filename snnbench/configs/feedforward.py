"""Frozen copy of the feed-forward chain generator (``random_layer`` and
``feedforward_network`` of the port's ``core/layer.py``), NumPy only.

Draws in the same order from the same ``np.random.default_rng`` stream,
so the same configuration gives the port's arrays byte for byte.
"""
from __future__ import annotations

import numpy as np

from snnbench.graph import chain_graph


def random_layer(n_source, n_target, density, delay_range, *, seed,
                 inhibitory_fraction=0.2):
    """Dense ``(weights, delays)``: Bernoulli(density) synapses, signed
    int8-magnitude weights, one delay per source neuron (1 where no
    synapse)."""
    rng = np.random.default_rng(seed)
    shape = (n_source, n_target)
    mask = rng.random(shape) < density
    mag = rng.integers(1, 128, size=shape).astype(np.float64)
    sign = np.where(rng.random(shape) < inhibitory_fraction, -1.0, 1.0)
    weights = np.where(mask, mag * sign, 0.0)
    per_src = rng.integers(1, delay_range + 1, size=(n_source, 1))
    delays = np.broadcast_to(per_src, shape).copy()
    delays = np.where(mask, delays, 1)
    return weights, delays


def generate(cfg: dict) -> dict:
    """The chain ``sizes[0] -> sizes[1] -> ...``; layer ``i`` drawn with
    seed ``seed + i``; every non-input population fires with the
    configuration's ``lif``."""
    sizes, name = cfg["sizes"], cfg["name"]
    layers = [
        random_layer(sizes[i], sizes[i + 1], cfg["density"],
                     cfg["delay_range"], seed=cfg["seed"] + i)
        for i in range(len(sizes) - 1)
    ]
    return chain_graph(name, layers, cfg["delay_range"], cfg["lif"]["alpha"],
                       cfg["lif"]["v_th"])
