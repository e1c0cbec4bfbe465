"""Wrapper of the int8 WDM matmul: plain version on CPU, K2 on CUDA."""
from __future__ import annotations

import ctypes

import torch

from .. import _common
from .ref import spike_wdm_matmul_ref

#: Launches of the CUDA kernel (never incremented by the plain version).
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_MAX_BATCH = 65535          # the kernel's grid puts the batch on gridDim.y
_fn = None


def spike_wdm_matmul(wdm: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) WDM x int8 (N, K) stacked spikes -> int32 (N, M).

    ``out[n, m] = sum_k wdm[m, k] * stacked[n, k]``, with no saturation.
    CPU tensors run :func:`spike_wdm_matmul_ref`; CUDA tensors run the
    CUDA kernel ``csrc/spike_wdm_matmul.cu`` or raise.  ``K == 0`` returns
    zeros without a launch.
    """
    if _common.on_cpu(wdm, stacked):
        return spike_wdm_matmul_ref(wdm, stacked)
    dev = _common.check_cuda("spike_wdm_matmul", wdm=wdm, stacked=stacked)
    _common.check_dtype("spike_wdm_matmul", torch.int8, wdm=wdm, stacked=stacked)
    if wdm.ndim != 2 or stacked.ndim != 2 or wdm.shape[1] != stacked.shape[1]:
        raise ValueError(
            f"spike_wdm_matmul: need (M, K) and (N, K); got "
            f"{tuple(wdm.shape)} and {tuple(stacked.shape)}"
        )
    (m, k), n = wdm.shape, stacked.shape[0]
    if n > _MAX_BATCH:
        raise ValueError(f"spike_wdm_matmul: batch {n} > {_MAX_BATCH}")
    if k == 0 or m * n == 0:
        return torch.zeros((n, m), dtype=torch.int32, device=dev)
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    global _fn, LAUNCHES
    if _fn is None:
        _fn = _common.load("spike_wdm_matmul", "spike_wdm_matmul_s8", _ARGTYPES)
    status = _fn(
        wdm.data_ptr(), stacked.data_ptr(), out.data_ptr(), m, k, n,
        _common.stream(dev),
    )
    _common.check(status, "spike_wdm_matmul")
    LAUNCHES += 1
    return out


__all__ = ["spike_wdm_matmul", "spike_wdm_matmul_ref", "LAUNCHES"]
