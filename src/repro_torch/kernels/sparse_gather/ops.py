"""Wrapper of the ELL gather-accumulate: plain version on CPU, K3 on CUDA."""
from __future__ import annotations

import ctypes

import torch

from .. import _common
from .ref import sparse_gather_ref

#: Launches of the CUDA kernel by entry point (the plain version counts none).
LAUNCHES = {"sparse_gather": 0}

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
_fn = None


def sparse_gather(
    ell_val: torch.Tensor,   # (R, L) f32 weights, 0 in padding lanes
    ell_idx: torch.Tensor,   # (R, L) i32 source indices in [0, S)
    x: torch.Tensor,         # (S, B) f32 presynaptic spikes, any strides
) -> torch.Tensor:
    """``out[r, b] = sum_l ell_val[r, l] * x[ell_idx[r, l], b]``.  (R, B) f32.

    ``ell_val`` and ``ell_idx`` must be contiguous on either device; ``x``
    may be any strided view (the kernel reads it through ``x.stride()``),
    so a ``(B, S)`` spike matrix goes in as ``x_t.t()`` without a copy.
    CPU tensors run :func:`sparse_gather_ref`; CUDA tensors run the CUDA
    kernel ``csrc/sparse_gather.cu`` or raise.  The kernel trusts the
    indices to lie in ``[0, S)``; :func:`sparse_serial_operands` builds
    them from the lowered rows, whose sources do.
    """
    if ell_val.ndim != 2 or ell_val.shape != ell_idx.shape or x.ndim != 2:
        raise ValueError(
            f"sparse_gather: need (R, L), (R, L), (S, B); got "
            f"{tuple(ell_val.shape)}, {tuple(ell_idx.shape)}, {tuple(x.shape)}"
        )
    _common.check_contiguous("sparse_gather", ell_val=ell_val, ell_idx=ell_idx)
    if _common.on_cpu(ell_val, ell_idx, x):
        return sparse_gather_ref(ell_val, ell_idx, x)
    dev = _common.check_cuda("sparse_gather", ell_val=ell_val, ell_idx=ell_idx,
                             x=x, strided=("x",))
    _common.check_dtype("sparse_gather", torch.float32, ell_val=ell_val, x=x)
    _common.check_dtype("sparse_gather", torch.int32, ell_idx=ell_idx)
    (r, lanes), b = ell_val.shape, x.shape[1]
    if lanes == 0 or x.shape[0] == 0:
        return torch.zeros((r, b), dtype=torch.float32, device=dev)
    out = torch.empty((r, b), dtype=torch.float32, device=dev)
    if r * b == 0:
        return out
    global _fn
    if _fn is None:
        _fn = _common.load("sparse_gather", "sparse_gather_f32", _ARGTYPES)
    status = _fn(
        ell_val.data_ptr(), ell_idx.data_ptr(), x.data_ptr(), out.data_ptr(),
        r, lanes, b, *x.stride(), _common.stream(dev),
    )
    _common.check(status, "sparse_gather")
    LAUNCHES["sparse_gather"] += 1
    return out


__all__ = ["sparse_gather", "sparse_gather_ref", "LAUNCHES"]
