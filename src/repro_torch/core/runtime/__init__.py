from .reference import (
    LIFState,
    delay_stacked_weights,
    init_state,
    reference_step,
    run_graph_reference,
    run_reference,
)
from .serial_runtime import (
    SerialExecutable,
    dense_serial_weights,
    lower_serial,
    run_serial,
    serial_project,
    serial_project_dense,
    serial_project_sparse,
    serial_step,
    serial_step_dense,
    serial_step_sparse,
    sparse_serial_operands,
)
from .parallel_runtime import (
    ParallelExecutable,
    lower_parallel,
    parallel_project,
    parallel_step,
    run_parallel,
)
from .executor import (
    GraphPlan,
    LayerMeta,
    NetworkExecutable,
    OutputValidationError,
    get_layer_executable,
    network_executable,
    release_network_executable,
    validate_spike_outputs,
)
from .network import run_network, run_network_layerwise

from . import parallel_runtime as _par_rt
from . import serial_runtime as _ser_rt


def lowering_counts() -> dict:
    """Total lower_serial / lower_parallel calls so far in this process."""
    return {"serial": _ser_rt.LOWER_COUNT, "parallel": _par_rt.LOWER_COUNT}


__all__ = [
    "run_network", "run_network_layerwise", "run_graph_reference",
    "LIFState", "init_state", "reference_step", "run_reference",
    "delay_stacked_weights",
    "SerialExecutable", "lower_serial", "run_serial",
    "serial_project", "serial_project_dense", "serial_project_sparse",
    "serial_step", "serial_step_dense", "serial_step_sparse",
    "dense_serial_weights", "sparse_serial_operands",
    "ParallelExecutable", "lower_parallel", "parallel_project",
    "parallel_step", "run_parallel",
    "GraphPlan", "LayerMeta", "NetworkExecutable",
    "OutputValidationError", "validate_spike_outputs",
    "get_layer_executable", "network_executable",
    "release_network_executable", "lowering_counts",
]
