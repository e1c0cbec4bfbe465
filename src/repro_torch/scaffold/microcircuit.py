"""The cell-type-specific cortical microcircuit of Potjans & Diesmann (2014).

Cereb. Cortex 24(3):785-806, doi:10.1093/cercor/bhs358: four layers of
one excitatory and one inhibitory population each, 77,169 neurons, the
connection probabilities of their Table 5, and a background of Poisson
spikes at 8 Hz on ``K_ext`` external synapses a neuron.  It is the
standard full-scale benchmark of neuromorphic and GPU SNN simulators
(SpiNNaker: van Albada et al. 2018; GeNN: Knight & Nowotny 2018).

The published structure is kept whole: every population size, every
probability, every in-degree of the external drive, weights of relative
spread 0.1 with ``g = -4`` and the L4E -> L2/3E weight doubled, per-synapse
delays of 1.5 ms (excitatory) and 0.75 ms (inhibitory) with relative
spread 0.5.  What the system's own neuron model and time step change:

* the neuron is the paper's Eq. (1): delta-current synapses, reset by
  subtraction, no refractory period; PD14's tau_syn of 0.5 ms is under the
  step, so a PSC lands as one jump;
* dt is 1 ms (PD14 uses 0.1 ms): alpha = exp(-1 ms / 10 ms), rounded to
  float32; delays are rounded to whole steps and clipped to 1..4;
* weights are integers of int8 magnitude in units of a twentieth of the
  excitatory jump (87.8 pA x 0.5 ms / 250 pF = 0.1756 mV), so
  ``v_th = 15 mV / 0.1756 mV x 20 = 1708``;
* each back-edge arrives one step later (the graph IR's semantics);
* each pair of neurons has at most one synapse (Bernoulli(p) pairs, 4.7 %
  fewer synapses than PD14's multapses);
* the external Poisson drive comes from one input population ``ext`` of
  77,169 shared sources, each neuron drawing ``K_ext`` of them;
* the membrane starts at 0 (PD14: N(-58, 10) mV).

Projections are declared target by target in Table 5's order, each
target's recurrent sources in that order and then ``ext``; the first is
L2/3E -> L2/3E.  Projection ``k`` draws from its own stream,
``np.random.default_rng([seed, k])``: its pairs (geometric gaps over the
row-major ``(source, target)`` grid, so targets come sorted), then its
weights, then its delays.  Everything is vectorized: the full scale
(442.7 M synapses) draws in about a minute.

``scale`` multiplies every population size and every ``K_ext`` and keeps
every probability; ``v_th`` scales with it, so that a neuron's mean drive
over its threshold stays as at full scale.  It exists for tests.

At full scale 52 of the 63 projections are over ``DENSE_ELEMENT_CAP``;
under the ``classifier`` and ``ideal`` policies the switching compiler
compiles them serial (``CompiledLayer.forced``).  The benchmark's cell
``microcircuit-pd14-stream`` runs scale 1.0
(``snnbench/configs/microcircuit-pd14.json``, with its frozen NumPy copy
``snnbench/configs/microcircuit.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np

from ..core.layer import LIFParams, Population, SNNNetwork, SparseProjection

__all__ = [
    "MICROCIRCUIT",
    "Microcircuit",
    "MicrocircuitSpec",
    "bernoulli_pairs",
    "build_microcircuit",
    "microcircuit_edges",
    "microcircuit_projection",
]


@dataclasses.dataclass(frozen=True)
class MicrocircuitSpec:
    """PD14's tables as data, in Table 5's population order."""

    populations: Tuple[str, ...]
    sizes: Tuple[int, ...]
    k_ext: Tuple[int, ...]
    inhibitory: Tuple[bool, ...]
    #: connection probability, ``p[target][source]``
    p: Tuple[Tuple[float, ...], ...]
    #: spike probability a step of each external source (8 Hz at 1 ms)
    ext_rate: float = 0.008
    #: (mean, sd) of a weight's magnitude
    w_exc: Tuple[float, float] = (20.0, 2.0)
    w_inh: Tuple[float, float] = (80.0, 8.0)
    #: the doubled projection ``(pre, post)`` and its (mean, sd)
    doubled: Tuple[str, str] = ("L4E", "L23E")
    w_doubled: Tuple[float, float] = (40.0, 4.0)
    #: (mean, sd) of a delay in steps, by the source's type
    d_exc: Tuple[float, float] = (1.5, 0.75)
    d_inh: Tuple[float, float] = (0.75, 0.375)
    delay_range: int = 4
    v_th: float = 1708.0
    #: membrane time constant in steps: alpha = exp(-1 / tau_m_steps)
    tau_m_steps: float = 10.0

    @property
    def alpha(self) -> float:
        return float(np.float32(np.exp(-1.0 / self.tau_m_steps)))


#: Potjans & Diesmann 2014: N and K_ext (Table 5's populations), Table 5's
#: probabilities (rows targets, columns sources).
MICROCIRCUIT = MicrocircuitSpec(
    populations=("L23E", "L23I", "L4E", "L4I", "L5E", "L5I", "L6E", "L6I"),
    sizes=(20683, 5834, 21915, 5479, 4850, 1065, 14395, 2948),
    k_ext=(1600, 1500, 2100, 1900, 2000, 1900, 2900, 2100),
    inhibitory=(False, True) * 4,
    p=(
        (0.1009, 0.1689, 0.0437, 0.0818, 0.0323, 0.0, 0.0076, 0.0),
        (0.1346, 0.1371, 0.0316, 0.0515, 0.0755, 0.0, 0.0042, 0.0),
        (0.0077, 0.0059, 0.0497, 0.1350, 0.0067, 0.0003, 0.0453, 0.0),
        (0.0691, 0.0029, 0.0794, 0.1597, 0.0033, 0.0, 0.1057, 0.0),
        (0.1004, 0.0622, 0.0505, 0.0057, 0.0831, 0.3726, 0.0204, 0.0),
        (0.0548, 0.0269, 0.0257, 0.0022, 0.0600, 0.3158, 0.0086, 0.0),
        (0.0156, 0.0066, 0.0211, 0.0166, 0.0572, 0.0197, 0.0396, 0.2252),
        (0.0364, 0.0010, 0.0034, 0.0005, 0.0277, 0.0080, 0.0658, 0.1443),
    ),
)


@dataclasses.dataclass
class Microcircuit:
    """A generated microcircuit: the network and its generation record."""

    network: SNNNetwork
    spec: MicrocircuitSpec
    scale: float
    seed: int
    #: population name -> neurons (``ext`` included)
    sizes: Dict[str, int]
    #: projection name -> realized mean in-degree (synapses / targets)
    in_degree: Dict[str, float]

    @property
    def total_synapses(self) -> int:
        return sum(e.n_synapses for e in self.network.projections)

    def stimulus(self, steps: int, batch: int = 1, *, seed: int):
        """The background drive: Bernoulli(``spec.ext_rate``) on every
        ``ext`` column (:func:`~repro_torch.scaffold.stimulus.poisson_stimulus`)."""
        from .stimulus import poisson_stimulus

        return poisson_stimulus(self.network, steps, batch, seed=seed,
                                rates=self.spec.ext_rate)


def bernoulli_pairs(rng: np.random.Generator, n_source: int, n_target: int,
                    p: float):
    """CSR ``(indptr, indices)`` of the ``(source, target)`` pairs each kept
    with probability ``p``: geometric gaps between kept pairs over the
    row-major grid, drawn in chunks of the expected count, so the targets
    of a row come sorted and distinct."""
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


def _sizes(spec: MicrocircuitSpec, scale: float) -> Dict[str, int]:
    sizes = {name: max(1, int(round(n * scale)))
             for name, n in zip(spec.populations, spec.sizes)}
    return {"ext": sum(sizes.values()), **sizes}


def microcircuit_edges(scale: float = 1.0):
    """``(pre, post, p)`` of every projection in declaration order (Table
    5's targets, each target's recurrent sources then ``ext``; ``p`` the
    connection probability)."""
    spec = MICROCIRCUIT
    sizes = _sizes(spec, scale)
    edges = []
    for t, post in enumerate(spec.populations):
        edges += [(pre, post, p) for pre, p in zip(spec.populations, spec.p[t])
                  if p > 0]
        edges.append(("ext", post, spec.k_ext[t] * scale / sizes["ext"]))
    return edges


def microcircuit_projection(k: int, scale: float = 1.0, *,
                            seed: int = 0) -> SparseProjection:
    """Projection ``k`` of :func:`microcircuit_edges`, drawn from its own
    stream ``np.random.default_rng([seed, k])`` exactly as
    :func:`build_microcircuit` draws it, without drawing the others."""
    spec = MICROCIRCUIT
    sizes = _sizes(spec, scale)
    lif = LIFParams(alpha=spec.alpha,
                    v_th=max(1.0, float(round(spec.v_th * scale))))
    inhibitory = dict(zip(spec.populations, spec.inhibitory), ext=False)
    pre, post, p = microcircuit_edges(scale)[k]
    rng = np.random.default_rng([seed, k])
    indptr, indices = bernoulli_pairs(rng, sizes[pre], sizes[post], p)
    if (pre, post) == spec.doubled:
        w_mean, w_sd = spec.w_doubled
    else:
        w_mean, w_sd = spec.w_inh if inhibitory[pre] else spec.w_exc
    nnz = len(indices)
    mag = np.clip(np.rint(rng.normal(w_mean, w_sd, nnz)), 1, 127)
    d_mean, d_sd = spec.d_inh if inhibitory[pre] else spec.d_exc
    delays = np.clip(np.rint(rng.normal(d_mean, d_sd, nnz)), 1,
                     spec.delay_range).astype(np.int64)
    return SparseProjection(
        n_source=sizes[pre], n_target=sizes[post], indptr=indptr,
        indices=indices, values=-mag if inhibitory[pre] else mag,
        delay_values=delays, delay_range=spec.delay_range, lif=lif,
        name=f"{pre}->{post}", pre=pre, post=post)


def build_microcircuit(scale: float = 1.0, *, seed: int = 0) -> Microcircuit:
    """Generate the microcircuit at ``scale`` (1.0: the published sizes).

    Seed-deterministic: the same ``(scale, seed)`` gives a byte-identical
    network in any process.
    """
    if scale <= 0:
        raise ValueError(f"scale must be positive; got {scale}")
    spec = MICROCIRCUIT
    sizes = _sizes(spec, scale)
    lif = LIFParams(alpha=spec.alpha,
                    v_th=max(1.0, float(round(spec.v_th * scale))))
    pops = [Population("ext", sizes["ext"])] + [
        Population(name, sizes[name], lif=lif) for name in spec.populations]
    projs = [microcircuit_projection(k, scale, seed=seed)
             for k in range(len(microcircuit_edges(scale)))]
    in_degree = {e.name: e.n_synapses / e.n_target for e in projs}
    net = SNNNetwork(populations=pops, projections=projs,
                     name=f"microcircuit-{scale:g}-s{seed}")
    return Microcircuit(network=net, spec=spec, scale=scale, seed=seed,
                        sizes=sizes, in_degree=in_degree)
