"""Network-level inference through the switching system, torch port.

Runs a compiled :class:`~repro_torch.core.switching.CompileReport`
end-to-end: each projection executes under the paradigm the switching
system chose for it (serial -> event/sparse/dense current step, parallel ->
int8 WDM matmul); within a timestep forward projections cascade in
topological order and back-edges read one-step-delayed feedback.

By default the whole mixed application graph runs as one fused loop over
timesteps (:class:`~repro_torch.core.runtime.executor.NetworkExecutable`)
with the lowered executables cached on the report.  Two independent
references back it:

* ``run_network_layerwise`` — one projection at a time, each through its
  own single-layer runner with a host round-trip between layers; chains
  only.
* ``run_graph_reference`` — the brute-force unrolled numpy oracle for
  arbitrary graphs (recurrent edges included).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..layer import SNNNetwork
from ..parallel_compiler import ParallelProgram
from ..serial_compiler import SerialProgram
from ..switching import CompileReport
from .executor import network_executable
from .parallel_runtime import run_parallel
from .reference import run_graph_reference
from .serial_runtime import run_serial

__all__ = ["run_network", "run_network_layerwise", "run_graph_reference"]


def run_network(
    net: SNNNetwork,
    report: CompileReport,
    spikes: np.ndarray,          # (T, B, n_input) 0/1
    *,
    fused: bool = True,
    device=None,
) -> List[np.ndarray]:
    """Returns the per-projection spike trains [(T, B, n_l) ...]."""
    if len(report.layers) != len(net.layers):
        raise ValueError("report does not match network")
    if fused:
        return network_executable(net, report, device=device).run(spikes)
    return run_network_layerwise(net, report, spikes, device=device)


def run_network_layerwise(
    net: SNNNetwork,
    report: CompileReport,
    spikes: np.ndarray,
    *,
    device=None,
) -> List[np.ndarray]:
    """Per-layer baseline: one loop + host round-trip + lowering per layer.

    Chains only — a graph with fan-in/fan-out or back-edges has no
    per-layer cascade order; use the fused path or
    :func:`run_graph_reference`.
    """
    if len(report.layers) != len(net.layers):
        raise ValueError("report does not match network")
    if not net.is_chain:
        raise ValueError(
            "run_network_layerwise supports feed-forward chains only; "
            "run the fused executor or run_graph_reference for graphs"
        )
    outs = []
    x = spikes
    for layer, compiled in zip(net.layers, report.layers):
        prog = compiled.program
        if isinstance(prog, SerialProgram):
            z = run_serial(layer, x, layer.lif, program=prog, device=device)
        elif isinstance(prog, ParallelProgram):
            z = run_parallel(layer, x, layer.lif, program=prog, device=device)
        else:  # pragma: no cover
            raise TypeError(type(prog))
        outs.append(z)
        x = z
    return outs
