"""Hand-written CUDA kernels of the port, each beside its plain version.

Every kernel package holds ``ops.py`` (the wrapper: the plain version for
CPU tensors, the CUDA kernel for CUDA tensors, never a fallback between
them), ``ref.py`` (the plain PyTorch version) and a source under
``csrc/``.  Each wrapper counts its launches in a plain integer,
``ops.LAUNCHES``, so a run can show that it went through the kernel.
"""
from __future__ import annotations

from .lif_update import ops as _lif_ops
from .sparse_gather import ops as _gather_ops
from .spike_wdm_matmul import ops as _wdm_ops

#: kernel name -> its wrapper module (the name is also its ``csrc`` stem)
KERNEL_OPS = {
    "lif_update": _lif_ops,
    "spike_wdm_matmul": _wdm_ops,
    "sparse_gather": _gather_ops,
}


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {name: mod.LAUNCHES for name, mod in KERNEL_OPS.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_OPS.values():
        mod.LAUNCHES = 0


def build_kernels() -> None:
    """Compile every kernel source now (one ``nvcc`` each, in parallel)."""
    from . import _build

    _build.build_all(KERNEL_OPS)


__all__ = ["KERNEL_OPS", "build_kernels", "launch_counts", "reset_launch_counts"]
