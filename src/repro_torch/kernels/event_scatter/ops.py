"""Wrapper of the event-driven scatter: the plain sweep on CPU, the CUDA
kernel on CUDA."""
from __future__ import annotations

import ctypes

import torch

from .. import _common
from .ref import event_scatter_ref

#: Launches of the CUDA kernel by entry point (the plain version counts none).
LAUNCHES = {"event_scatter": 0}

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]
_fn = None


def event_scatter(
    row_weight: torch.Tensor,   # (R,) f32, rows source-major
    row_delay: torch.Tensor,    # (R,) i32 in [1, d_slots)
    row_src: torch.Tensor,      # (R,) i32 (the plain version's gather index)
    row_tgt: torch.Tensor,      # (R,) i32 in [0, n_target)
    row_ptr: torch.Tensor,      # (S + 1,) i32: source s owns rows
                                # row_ptr[s] .. row_ptr[s + 1]
    x: torch.Tensor,            # (B, S) f32 spikes, any strides
    t: int,
    *,
    d_slots: int,
    n_target: int,
) -> torch.Tensor:
    """``out[b, (delay[r] + t) mod d_slots, tgt[r]] += x[b, s] * weight[r]``
    for the rows ``r`` of every source ``s``; ``(B, d_slots, n_target)`` f32.

    CPU tensors run :func:`event_scatter_ref`, which sweeps every row
    through ``row_src``; CUDA tensors run ``csrc/event_scatter.cu``, which
    reads only the rows of the sources with ``x[b, s] != 0`` through
    ``row_ptr`` (:func:`~repro_torch.core.runtime.serial_runtime.\
source_major_index` builds it), or raise.  ``x`` may be any strided view:
    the kernel reads it through ``x.stride()``.  The kernel trusts the
    index and the rows: ``row_ptr`` monotone from 0 to R, delays in ``[0,
    d_slots)``, targets in ``[0, n_target)``.
    """
    r = row_weight.shape[0]
    if (x.ndim != 2 or row_ptr.ndim != 1 or row_ptr.shape[0] != x.shape[1] + 1
            or any(a.shape != (r,) for a in (row_delay, row_src, row_tgt))):
        raise ValueError(
            f"event_scatter: need rows (R,), row_ptr (S + 1,) and x (B, S); got "
            f"{tuple(row_weight.shape)}, {tuple(row_delay.shape)}, "
            f"{tuple(row_src.shape)}, {tuple(row_tgt.shape)}, "
            f"{tuple(row_ptr.shape)}, {tuple(x.shape)}"
        )
    if _common.on_cpu(row_weight, row_delay, row_src, row_tgt, row_ptr, x):
        return event_scatter_ref(row_weight, row_delay, row_src, row_tgt, x, t,
                                 d_slots=d_slots, n_target=n_target)
    dev = _common.check_cuda("event_scatter", strided=("x",), row_weight=row_weight,
                             row_delay=row_delay, row_src=row_src,
                             row_tgt=row_tgt, row_ptr=row_ptr, x=x)
    _common.check_dtype("event_scatter", torch.float32, row_weight=row_weight, x=x)
    _common.check_dtype("event_scatter", torch.int32, row_delay=row_delay,
                        row_tgt=row_tgt, row_ptr=row_ptr)
    batch, n_source = x.shape
    out = torch.zeros((batch, d_slots, n_target), dtype=torch.float32, device=dev)
    if r == 0 or out.numel() == 0 or n_source == 0:
        return out
    global _fn
    if _fn is None:
        _fn = _common.load("event_scatter", "event_scatter_f32", _ARGTYPES)
    status = _fn(
        row_weight.data_ptr(), row_delay.data_ptr(), row_tgt.data_ptr(),
        row_ptr.data_ptr(), x.data_ptr(), out.data_ptr(), n_source, batch,
        *x.stride(), int(t), d_slots, n_target, _common.stream(dev),
    )
    _common.check(status, "event_scatter")
    LAUNCHES["event_scatter"] += 1
    return out


__all__ = ["event_scatter", "event_scatter_ref", "LAUNCHES"]
