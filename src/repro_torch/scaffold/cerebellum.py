"""Seed-deterministic cerebellum-class network generator.

The population mix and connectivity shape follow the cerebellar granular
/ molecular layer microcircuit the SpiNNCer experiments scale (granule
cells dominate by two orders of magnitude; mossy and climbing fibers are
independent external spike sources; Golgi feedback inhibition onto the
granule layer is the one recurrent loop):

======================  ========  ======================================
population              fraction  role
======================  ========  ======================================
``mossy``               6.5 %     external input (mossy fibers)
``climbing``            1.0 %     external input (climbing fibers)
``granule``             80.0 %    granular layer (the scale driver)
``golgi``               2.0 %     feedback inhibition onto granule
``purkinje``            2.5 %     sole output of the cortex analogue
``basket_stellate``     8.0 %     molecular-layer inhibition
======================  ========  ======================================

Connectivity is specified as **convergence** — the average number of
synapses a *target* neuron receives from the source population — which
is the quantity cerebellar anatomy pins (4 mossy dendrites per granule
cell, ~one climbing fiber per Purkinje cell, hundreds of parallel-fiber
contacts).  Convergence converts to Bernoulli density as
``min(1, convergence / n_source)``, so the generated in-degree stays
anatomical while everything else scales with the single ``n_neurons``
knob.  All projections are CSR (:func:`random_sparse_projection`):
memory scales with synapse count, and at 100k neurons several
projections exceed the dense element cap — those **must** compile on the
serial paradigm (:func:`scaffold_policies` encodes exactly that).

Every draw comes from one ``np.random.default_rng`` stream per
projection, seeded as ``seed + projection position``; same
``(n_neurons, seed, spec)`` -> byte-identical network, across processes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.hw import DEFAULT_S2
from ..core.layer import (
    LIFParams,
    Population,
    SNNNetwork,
    random_sparse_projection,
)
from ..core.switching import over_dense_cap

__all__ = [
    "CEREBELLUM",
    "CerebellumSpec",
    "PopulationSpec",
    "ProjectionSpec",
    "ScaffoldNetwork",
    "build_cerebellum",
    "compile_scaffold",
    "scaffold_policies",
]

#: Mean magnitude of the int8 weight distribution (uniform 1..127) —
#: used to scale thresholds to the realized convergence.
_MEAN_WEIGHT = 64.0


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """One named population: its share of ``n_neurons`` and its role."""

    name: str
    fraction: float
    is_input: bool = False
    #: Poisson spike probability per timestep (input populations only).
    rate: float = 0.0
    #: Membrane leak for the generated LIF parameters.
    alpha: float = 0.5


@dataclasses.dataclass(frozen=True)
class ProjectionSpec:
    """One projection: anatomical convergence onto each target neuron."""

    pre: str
    post: str
    #: Average synapses a target neuron receives from ``pre`` (clamped
    #: to ``pre``'s realized size at small scales).
    convergence: float
    delay_range: int = 2
    #: Fraction of synapses drawn inhibitory (1.0 = purely inhibitory).
    inhibitory_fraction: float = 0.0


@dataclasses.dataclass(frozen=True)
class CerebellumSpec:
    """The whole generator recipe: populations, projections, thresholds.

    ``v_th_sensitivity`` sets each population's firing threshold as a
    fraction of its expected *excitatory* synaptic drive per fully
    active input set (``sum over in-projections of realized convergence
    x excitatory fraction x mean weight``) — anatomy-coupled, so
    thresholds stay meaningful as convergence clamps at small sizes.
    """

    populations: Tuple[PopulationSpec, ...]
    projections: Tuple[ProjectionSpec, ...]
    v_th_sensitivity: float = 0.15
    min_pop_size: int = 2

    def validate(self) -> None:
        names = [p.name for p in self.populations]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate population names in spec: {names}")
        total = sum(p.fraction for p in self.populations)
        if abs(total - 1.0) > 1e-9:
            raise ValueError(f"population fractions must sum to 1; got {total}")
        known = set(names)
        inputs = {p.name for p in self.populations if p.is_input}
        if not inputs:
            raise ValueError("spec needs at least one input population")
        driven = {e.post for e in self.projections}
        for e in self.projections:
            if e.pre not in known or e.post not in known:
                raise ValueError(f"projection {e.pre}->{e.post}: unknown population")
            if e.post in inputs:
                raise ValueError(
                    f"projection {e.pre}->{e.post} drives an input population"
                )
        undriven = known - inputs - driven
        if undriven:
            raise ValueError(f"undriven non-input populations: {sorted(undriven)}")


#: The default cerebellum-class recipe (fractions sum to exactly 1).
CEREBELLUM = CerebellumSpec(
    populations=(
        PopulationSpec("mossy", 0.065, is_input=True, rate=0.08),
        PopulationSpec("climbing", 0.01, is_input=True, rate=0.02),
        PopulationSpec("granule", 0.80),
        PopulationSpec("golgi", 0.02),
        PopulationSpec("purkinje", 0.025),
        PopulationSpec("basket_stellate", 0.08),
    ),
    projections=(
        # granular layer: 4 mossy dendrites per granule cell; Golgi
        # feedback inhibition closes the one recurrent loop
        ProjectionSpec("mossy", "granule", convergence=4, delay_range=2),
        ProjectionSpec("mossy", "golgi", convergence=20, delay_range=2),
        ProjectionSpec("granule", "golgi", convergence=100, delay_range=3),
        ProjectionSpec(
            "golgi", "granule", convergence=4, delay_range=2,
            inhibitory_fraction=1.0,
        ),
        # parallel fibers (bounded stand-in for the anatomical ~100k
        # contacts) and the molecular-layer inhibition onto Purkinje
        ProjectionSpec("granule", "purkinje", convergence=150, delay_range=4),
        ProjectionSpec(
            "granule", "basket_stellate", convergence=100, delay_range=3,
        ),
        ProjectionSpec(
            "basket_stellate", "purkinje", convergence=20, delay_range=2,
            inhibitory_fraction=1.0,
        ),
        ProjectionSpec("climbing", "purkinje", convergence=1, delay_range=1),
    ),
)


@dataclasses.dataclass
class ScaffoldNetwork:
    """A generated scaffold: the network plus its generation record."""

    network: SNNNetwork
    spec: CerebellumSpec
    n_neurons: int
    seed: int
    #: population name -> realized size
    sizes: Dict[str, int]
    #: projection name -> realized convergence (density x n_source)
    convergence: Dict[str, float]
    #: input population name -> default Poisson rate from the spec
    input_rates: Dict[str, float]

    @property
    def total_neurons(self) -> int:
        return sum(self.sizes.values())

    @property
    def total_synapses(self) -> int:
        return sum(e.n_synapses for e in self.network.projections)

    def stimulus(
        self, steps: int, batch: int = 1, *, seed: int,
        rates: Optional[Dict[str, float]] = None,
    ):
        """Spec-rate Poisson train for this network (see
        :func:`~repro_torch.scaffold.stimulus.poisson_stimulus`)."""
        from .stimulus import poisson_stimulus

        merged = dict(self.input_rates)
        merged.update(rates or {})
        return poisson_stimulus(
            self.network, steps, batch, seed=seed, rates=merged,
        )


def _sizes(spec: CerebellumSpec, n_neurons: int) -> Dict[str, int]:
    """Allocate ``n_neurons`` across populations by fraction.

    Largest-remainder rounding with the spec's minimum size per
    population, so sizes are deterministic, every population exists at
    every scale, and the total stays within one neuron per population of
    the knob.
    """
    floors = {
        p.name: max(spec.min_pop_size, int(p.fraction * n_neurons))
        for p in spec.populations
    }
    remainders = sorted(
        spec.populations,
        key=lambda p: (p.fraction * n_neurons) - int(p.fraction * n_neurons),
        reverse=True,
    )
    short = n_neurons - sum(floors.values())
    for p in remainders:
        if short <= 0:
            break
        floors[p.name] += 1
        short -= 1
    return floors


def build_cerebellum(
    n_neurons: int,
    *,
    seed: int = 0,
    spec: CerebellumSpec = CEREBELLUM,
) -> ScaffoldNetwork:
    """Generate one cerebellum-class network of ~``n_neurons`` neurons.

    Seed-deterministic: the same ``(n_neurons, seed, spec)`` produces a
    byte-identical network in any process.  Multi-input by construction
    (mossy + climbing in the default spec); the recurrent Golgi loop
    lands on the back-edge path exactly as declared.
    """
    if n_neurons < 10 * len(spec.populations):
        raise ValueError(
            f"n_neurons={n_neurons} too small for {len(spec.populations)} "
            "populations"
        )
    spec.validate()
    sizes = _sizes(spec, n_neurons)
    pspec = {p.name: p for p in spec.populations}

    # thresholds from realized excitatory drive (see CerebellumSpec)
    exc_drive: Dict[str, float] = {p.name: 0.0 for p in spec.populations}
    conv_real: Dict[str, float] = {}
    for e in spec.projections:
        S = sizes[e.pre]
        density = min(1.0, float(e.convergence) / S)
        conv_real[f"{e.pre}->{e.post}"] = density * S
        exc_drive[e.post] += (
            density * S * (1.0 - e.inhibitory_fraction) * _MEAN_WEIGHT
        )

    pops: List[Population] = []
    for p in spec.populations:
        if p.is_input:
            pops.append(Population(p.name, sizes[p.name]))
        else:
            v_th = max(1.0, round(spec.v_th_sensitivity * exc_drive[p.name]))
            pops.append(
                Population(
                    p.name, sizes[p.name],
                    lif=LIFParams(alpha=p.alpha, v_th=float(v_th)),
                )
            )
    by_name = {p.name: p for p in pops}

    projs = []
    for k, e in enumerate(spec.projections):
        density = min(1.0, float(e.convergence) / sizes[e.pre])
        proj = random_sparse_projection(
            by_name[e.pre], by_name[e.post], density, e.delay_range,
            seed=seed + k,
            inhibitory_fraction=e.inhibitory_fraction,
            name=f"{e.pre}->{e.post}",
        )
        proj.lif = by_name[e.post].lif
        projs.append(proj)

    net = SNNNetwork(
        populations=pops, projections=projs,
        name=f"cerebellum-{n_neurons}-s{seed}",
    )
    input_names = {p.name for p in net.input_populations}
    want_inputs = {p.name for p in spec.populations if p.is_input}
    if input_names != want_inputs:
        raise AssertionError(
            f"generator produced inputs {sorted(input_names)}; "
            f"spec declares {sorted(want_inputs)}"
        )
    for i, p in enumerate(net.populations):
        if p.name in input_names:
            continue
        if not any(
            net.projections[j].n_synapses for j in net.in_edges[i]
        ):
            raise AssertionError(
                f"population {p.name!r} generated with zero incoming "
                f"synapses (n_neurons={n_neurons}, seed={seed}) — "
                "raise its sources' convergence or sizes"
            )
    return ScaffoldNetwork(
        network=net,
        spec=spec,
        n_neurons=n_neurons,
        seed=seed,
        sizes=sizes,
        convergence=conv_real,
        input_rates={
            p.name: p.rate for p in spec.populations if p.is_input
        },
    )


def scaffold_policies(net: SNNNetwork) -> List[str]:
    """Per-projection compile policy for a scaffold-scale network.

    CSR projections whose dense form would break the
    ``DENSE_ELEMENT_CAP`` can only compile on the **serial** paradigm
    (the parallel compiler densifies); everything else gets the paper's
    ``ideal`` two-way compile-and-measure.  The resulting mix is the
    per-size paradigm record the scale benchmark reports.
    """
    return ["serial" if over_dense_cap(e) else "ideal" for e in net.projections]


def compile_scaffold(
    scaffold: ScaffoldNetwork,
    *,
    hw=DEFAULT_S2,
    policies: Optional[List[str]] = None,
):
    """Compile a scaffold with scale-aware per-projection policies.

    Returns the :class:`~repro_torch.core.switching.CompileReport`; the chosen
    paradigm per projection is ``[l.paradigm for l in report.layers]``.
    """
    from ..core.switching import CompileReport, SwitchingCompiler

    net = scaffold.network
    policies = policies or scaffold_policies(net)
    if len(policies) != len(net.projections):
        raise ValueError(
            f"{len(policies)} policies for {len(net.projections)} projections"
        )
    compilers = {p: SwitchingCompiler(p, hw=hw) for p in set(policies)}
    return CompileReport(layers=[
        compilers[p].compile_layer(l)
        for p, l in zip(policies, net.layers)
    ])
