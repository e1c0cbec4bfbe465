"""Wrapper of the affine membrane scan: plain version on CPU, K4 on CUDA."""
from __future__ import annotations

import ctypes

import torch

from .. import _common
from .ref import lif_parallel_scan_ref

#: Launches of the CUDA kernel (never incremented by the plain version).
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 2 + [
    ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
]
_fn = None


def lif_parallel_scan(c: torch.Tensor, *, alpha: float) -> torch.Tensor:
    """All-timesteps ``v[t] = alpha*v[t-1] + c[t]`` for ``c`` of shape (T, F).

    CPU tensors run :func:`lif_parallel_scan_ref`; CUDA tensors run the
    CUDA kernel ``csrc/lif_parallel_scan.cu`` or raise.  Both walk T in
    order with separately rounded f32 ops, so they agree bit for bit at
    any ``alpha``.  ``alpha`` enters the kernel as f32, rounded once.
    """
    if c.ndim != 2:
        raise ValueError(
            f"lif_parallel_scan: need (T, F); got {tuple(c.shape)}"
        )
    if _common.on_cpu(c):
        return lif_parallel_scan_ref(c, alpha=alpha)
    dev = _common.check_cuda("lif_parallel_scan", c=c)
    _common.check_dtype("lif_parallel_scan", torch.float32, c=c)
    v = torch.empty_like(c)
    steps, feat = c.shape
    if steps == 0 or feat == 0:
        return v                     # a zero-size grid is an invalid launch
    global _fn, LAUNCHES
    if _fn is None:
        _fn = _common.load("lif_parallel_scan", "affine_scan_f32", _ARGTYPES)
    status = _fn(
        c.data_ptr(), v.data_ptr(), steps, feat, ctypes.c_float(alpha),
        _common.stream(dev),
    )
    _common.check(status, "lif_parallel_scan")
    LAUNCHES += 1
    return v


__all__ = ["lif_parallel_scan", "lif_parallel_scan_ref", "LAUNCHES"]
