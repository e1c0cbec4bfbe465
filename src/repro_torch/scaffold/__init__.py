"""Procedural cerebellum-class network generator (the scale scenario).

SpiNNCer-style scaffold networks: named populations with biologically
shaped sparse convergence, several independent external spike sources
(mossy + climbing fibers), Poisson stimulus, all scaled by one
``n_neurons`` knob from 1k to ~100k neurons.  Small slices validate
bit-identically against the numpy oracle; large sizes are the standing
scale-trajectory benchmark (``benchmarks/bench_scaffold.py``).
"""
from .cerebellum import (
    CEREBELLUM,
    CerebellumSpec,
    PopulationSpec,
    ProjectionSpec,
    ScaffoldNetwork,
    build_cerebellum,
    compile_scaffold,
    scaffold_policies,
)
from .stimulus import poisson_stimulus

__all__ = [
    "CEREBELLUM",
    "CerebellumSpec",
    "PopulationSpec",
    "ProjectionSpec",
    "ScaffoldNetwork",
    "build_cerebellum",
    "compile_scaffold",
    "poisson_stimulus",
    "scaffold_policies",
]
