"""Wrappers of the int8 WDM matmul and of the parallel projection's current
(the ring gather folded into the matmul): plain versions on CPU, K2 on
CUDA."""
from __future__ import annotations

import ctypes

import torch

from .. import _common
from .ref import spike_wdm_matmul_ref, spike_wdm_project_ref

#: Launches of the CUDA kernels by entry point (the plain versions count none).
LAUNCHES = {"spike_wdm_matmul": 0, "spike_wdm_project": 0}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PROJECT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_int64, ctypes.c_void_p,
]
_fn = None
_project_fn = None


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
    if k == 0 or m * n == 0:
        return torch.zeros((n, m), dtype=torch.int32, device=dev)
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    global _fn
    if _fn is None:
        _fn = _common.load("spike_wdm_matmul", "spike_wdm_matmul_s8", _ARGTYPES)
    status = _fn(
        wdm.data_ptr(), stacked.data_ptr(), out.data_ptr(), m, k, n,
        _common.stream(dev),
    )
    _common.check(status, "spike_wdm_matmul")
    LAUNCHES["spike_wdm_matmul"] += 1
    return out


def spike_wdm_project(
    wdm: torch.Tensor,
    col_source: torch.Tensor,
    col_delay: torch.Tensor,
    x_hist: torch.Tensor,
    t: int,
) -> torch.Tensor:
    """The parallel projection's (B, M) f32 current at step ``t``.

    ``wdm`` (M, K) int8, ``col_source``/``col_delay`` (K,) int32 (the input
    merging table), ``x_hist`` the ``(B, d, S)`` int8 spike-history ring.
    CPU tensors run :func:`spike_wdm_project_ref` (column gather, product,
    cast); CUDA tensors run one launch of ``csrc/spike_wdm_matmul.cu`` that
    gathers each lane's stacked row from the ring itself, or raise.
    Bitwise equal to the plain version.  ``K == 0`` returns zeros without a
    launch.
    """
    if _common.on_cpu(wdm, col_source, col_delay, x_hist):
        return spike_wdm_project_ref(wdm, col_source, col_delay, x_hist, t)
    dev = _common.check_cuda("spike_wdm_project", wdm=wdm, col_source=col_source,
                             col_delay=col_delay, x_hist=x_hist)
    _common.check_dtype("spike_wdm_project", torch.int8, wdm=wdm, x_hist=x_hist)
    _common.check_dtype("spike_wdm_project", torch.int32, col_source=col_source,
                        col_delay=col_delay)
    if (wdm.ndim != 2 or x_hist.ndim != 3
            or col_source.shape != (wdm.shape[1],)
            or col_delay.shape != (wdm.shape[1],)):
        raise ValueError(
            f"spike_wdm_project: need wdm (M, K), col_source and col_delay "
            f"(K,), x_hist (B, d, S); got {tuple(wdm.shape)}, "
            f"{tuple(col_source.shape)}, {tuple(col_delay.shape)}, "
            f"{tuple(x_hist.shape)}"
        )
    (m, k), (n, depth, n_source) = wdm.shape, x_hist.shape
    if depth < 1:
        raise ValueError("spike_wdm_project: the ring needs depth >= 1")
    if k == 0 or m * n == 0:
        return torch.zeros((n, m), dtype=torch.float32, device=dev)
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    global _project_fn
    if _project_fn is None:
        _project_fn = _common.load("spike_wdm_matmul", "spike_wdm_project_s8",
                                   _PROJECT_ARGTYPES)
    status = _project_fn(
        wdm.data_ptr(), x_hist.data_ptr(), col_source.data_ptr(),
        col_delay.data_ptr(), out.data_ptr(), m, k, n, depth, n_source,
        int(t), _common.stream(dev),
    )
    _common.check(status, "spike_wdm_project")
    LAUNCHES["spike_wdm_project"] += 1
    return out


__all__ = [
    "spike_wdm_matmul", "spike_wdm_matmul_ref", "spike_wdm_project",
    "spike_wdm_project_ref", "LAUNCHES",
]
