"""Plain PyTorch version of the stacked-spike x weight-delay-map matmul."""
from __future__ import annotations

import torch


def spike_wdm_matmul_ref(wdm: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """int8 ``wdm`` (M, K) and int8 ``stacked`` (N, K) -> int32 (N, M).

    ``out[n, m] = sum_k wdm[m, k] * stacked[n, k]``: the reference's
    ``(M, K) @ (K, N)`` product with the batch axis leading on both sides
    (the port's batch-major layout).  PyTorch has no int32 matmul on CUDA,
    so the product runs in float64 and is cast back: exact, because every
    partial sum is an integer of magnitude at most ``2^14 * K`` < 2^53.
    """
    if wdm.dtype != torch.int8 or stacked.dtype != torch.int8:
        raise TypeError("operands must be int8 (SpiNNaker2 MAC operand precision)")
    return (stacked.to(torch.float64) @ wdm.to(torch.float64).T).to(torch.int32)
