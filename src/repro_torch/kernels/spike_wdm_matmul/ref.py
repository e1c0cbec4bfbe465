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


def spike_wdm_project_ref(
    wdm: torch.Tensor,
    col_source: torch.Tensor,
    col_delay: torch.Tensor,
    x_hist: torch.Tensor,
    t: int,
) -> torch.Tensor:
    """The parallel projection's current at step ``t``: (B, M) f32.

    The stacked input is read from the ``(B, d, S)`` int8 spike-history
    ring through the input merging table, column c being ``x_hist[:,
    (t - col_delay[c]) mod d, col_source[c]]`` (torch's ``%`` on integer
    tensors is a floor-mod, like the reference's ``jnp`` ``%``), as one
    column gather on the ``(B, d * S)`` view; then the int8 product and
    the cast to f32 (exact: every sum is an integer below 2^24).
    """
    batch, d, n_source = x_hist.shape
    slot = (t - col_delay.long()) % d                             # (C,)
    stacked = x_hist.reshape(batch, d * n_source).index_select(
        1, slot * n_source + col_source
    )                                        # (B, C) int8, a fresh copy
    return spike_wdm_matmul_ref(wdm, stacked).to(torch.float32)
