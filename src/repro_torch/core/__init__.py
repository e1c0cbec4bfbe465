# Host side of the port: the serial/parallel SNN compilation paradigms,
# the Table I cost model, the 16k-layer dataset, the AdaBoost prejudging
# classifier and the fast-switching compiling system (NumPy copies of the
# reference package's modules; the runtime under ``runtime/`` is torch).
from .hw import SpiNNaker2Config, TPUv5eConfig, DEFAULT_S2, DEFAULT_TPU
from .layer import (
    LayerCharacter,
    LIFParams,
    Population,
    Projection,
    SNNLayer,
    SNNNetwork,
    feedforward_network,
    random_layer,
    random_projection,
)
from .dataset import (
    LABEL_PARALLEL,
    LABEL_SERIAL,
    ParadigmDataset,
    generate_dataset,
    load_or_generate,
)
from .parallel_compiler import (
    OptFlags,
    ParallelProgram,
    compile_parallel,
    parallel_pe_count_exact,
)
from .serial_compiler import (
    SerialProgram,
    compile_serial,
    serial_pe_count,
    serial_pe_count_exact,
)
from .switching import (
    CompileReport,
    CompiledLayer,
    SwitchingCompiler,
    average_pes_by_delay,
    train_switch_classifier,
)

__all__ = [
    "SpiNNaker2Config", "TPUv5eConfig", "DEFAULT_S2", "DEFAULT_TPU",
    "LayerCharacter", "LIFParams", "Population", "Projection",
    "SNNLayer", "SNNNetwork",
    "feedforward_network", "random_layer", "random_projection",
    "LABEL_PARALLEL", "LABEL_SERIAL", "ParadigmDataset",
    "generate_dataset", "load_or_generate",
    "OptFlags", "ParallelProgram", "compile_parallel",
    "parallel_pe_count_exact",
    "SerialProgram", "compile_serial", "serial_pe_count",
    "serial_pe_count_exact",
    "CompileReport", "CompiledLayer", "SwitchingCompiler",
    "average_pes_by_delay", "train_switch_classifier",
]
