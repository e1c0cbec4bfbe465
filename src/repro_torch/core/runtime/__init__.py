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
    serial_update,
    serial_update_dense,
    serial_update_sparse,
    source_major_index,
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
from .profiler import ActivityProfile, profile_outputs, profile_run
from .temporal_runtime import (
    TemporalReport,
    choose_temporal_mode,
    temporal_lif,
    temporal_project_dense,
    temporal_project_sparse,
    temporal_step,
)

from . import parallel_runtime as _par_rt
from . import serial_runtime as _ser_rt


def lowering_counts() -> dict:
    """Total lower_serial / lower_parallel calls so far in this process."""
    return {"serial": _ser_rt.LOWER_COUNT, "parallel": _par_rt.LOWER_COUNT}


def lowering_total() -> int:
    """Sum of all lowering invocations — the serving layer's staleness probe.

    The executable pool snapshots this at warmup and asserts it never moves
    under steady-state traffic (zero re-lowerings per bucket hit).
    """
    return sum(lowering_counts().values())


__all__ = [
    "run_network", "run_network_layerwise", "run_graph_reference",
    "LIFState", "init_state", "reference_step", "run_reference",
    "delay_stacked_weights",
    "SerialExecutable", "lower_serial", "run_serial",
    "serial_project", "serial_project_dense", "serial_project_sparse",
    "serial_step", "serial_step_dense", "serial_step_sparse",
    "serial_update", "serial_update_dense", "serial_update_sparse",
    "dense_serial_weights", "sparse_serial_operands", "source_major_index",
    "ParallelExecutable", "lower_parallel", "parallel_project",
    "parallel_step", "run_parallel",
    "GraphPlan", "LayerMeta", "NetworkExecutable",
    "OutputValidationError", "validate_spike_outputs",
    "get_layer_executable", "network_executable",
    "release_network_executable", "lowering_counts", "lowering_total",
    "ActivityProfile", "profile_outputs", "profile_run",
    "TemporalReport", "choose_temporal_mode", "temporal_lif",
    "temporal_project_dense", "temporal_project_sparse", "temporal_step",
]
