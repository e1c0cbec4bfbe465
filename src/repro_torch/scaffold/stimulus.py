"""Poisson stimulus for multi-input application graphs.

One Bernoulli(rate) draw per (timestep, batch lane, input neuron) — the
discrete-time Poisson process every SpiNNaker cerebellum experiment
drives its fiber inputs with.  Rates are per input *population*, so
mossy and climbing fibers (or any other set of external sources) get
independent intensities inside one concatenated ``(T, B, n_input)``
train.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np

__all__ = ["poisson_stimulus"]


def poisson_stimulus(
    net,
    steps: int,
    batch: int = 1,
    *,
    seed: int,
    rates: Union[float, Mapping[str, float], None] = None,
    default_rate: float = 0.05,
) -> np.ndarray:
    """A seed-deterministic ``(steps, batch, net.n_input)`` 0/1 train.

    ``rates`` maps input-population name -> spike probability per
    timestep (a bare float applies to every input population; missing
    names fall back to ``default_rate``).  Slots are filled in
    ``net.input_slices`` order with one contiguous draw per population,
    so the same seed always produces the byte-identical train.
    """
    if steps < 0 or batch < 1:
        raise ValueError(f"need steps >= 0 and batch >= 1; got {steps}, {batch}")
    if isinstance(rates, (int, float)):
        rates = {p.name: float(rates) for p in net.input_populations}
    rates = dict(rates or {})
    unknown = set(rates) - {p.name for p in net.input_populations}
    if unknown:
        raise ValueError(
            f"rates for non-input populations {sorted(unknown)}"
        )
    rng = np.random.default_rng(seed)
    out = np.zeros((steps, batch, net.n_input), np.float32)
    for p, (a, b) in zip(net.input_populations, net.input_slices):
        r = float(rates.get(p.name, default_rate))
        if not (0.0 <= r <= 1.0):
            raise ValueError(f"rate for {p.name!r} must be in [0, 1]; got {r}")
        out[:, :, a:b] = (
            rng.random((steps, batch, b - a)) < r
        ).astype(np.float32)
    return out
