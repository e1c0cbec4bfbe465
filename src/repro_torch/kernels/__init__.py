"""Hand-written CUDA kernels of the port, each beside its plain version.

Every kernel package holds ``ops.py`` (the wrapper: the plain version for
CPU tensors, the CUDA kernel for CUDA tensors, never a fallback between
them), ``ref.py`` (the plain PyTorch version) and a source under
``csrc/``.  Each wrapper counts its launches in ``ops.LAUNCHES``, a dict
of plain integers keyed by entry point (a source may have several), so a
run can show that it went through the kernel.
"""
from __future__ import annotations

from .event_scatter import ops as _event_ops
from .lif_parallel_scan import ops as _scan_ops
from .lif_update import ops as _lif_ops
from .sparse_gather import ops as _gather_ops
from .spike_wdm_matmul import ops as _wdm_ops
from .ssd_chunk import ops as _ssd_ops

#: kernel source (its ``csrc`` stem) -> its wrapper module
KERNEL_OPS = {
    "lif_update": _lif_ops,
    "spike_wdm_matmul": _wdm_ops,
    "sparse_gather": _gather_ops,
    "lif_parallel_scan": _scan_ops,
    "ssd_chunk": _ssd_ops,
    "event_scatter": _event_ops,
}


def launch_counts() -> dict:
    """Launches of each kernel entry point since the last reset."""
    return {entry: n for mod in KERNEL_OPS.values()
            for entry, n in mod.LAUNCHES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_OPS.values():
        for entry in mod.LAUNCHES:
            mod.LAUNCHES[entry] = 0


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (entry point -> launches, negative to take away) to
    the kernels' counts: a replayed CUDA graph launches its kernels without
    their wrappers."""
    for mod in KERNEL_OPS.values():
        for entry in mod.LAUNCHES:
            mod.LAUNCHES[entry] += counts.get(entry, 0)


def build_kernels() -> None:
    """Compile every kernel source now (one ``nvcc`` each, in parallel)."""
    from . import _build

    _build.build_all(KERNEL_OPS)


__all__ = ["KERNEL_OPS", "add_launch_counts", "build_kernels", "launch_counts",
           "reset_launch_counts"]
