"""Plain PyTorch version of the ELL gather-accumulate step."""
from __future__ import annotations

import torch


def sparse_gather_ref(
    ell_val: torch.Tensor,   # (R, L) f32 weights, 0 in padding lanes
    ell_idx: torch.Tensor,   # (R, L) i32 source indices, 0 in padding lanes
    x: torch.Tensor,         # (S, B) f32 presynaptic spikes
):
    """``out[r, b] = sum_l ell_val[r, l] * x[ell_idx[r, l], b]``.

    Padding lanes carry weight 0, so their gathered (row-0) spikes never
    contribute.  All weights are int8-magnitude integers and spikes are
    0/1, so the f32 accumulation is exact and order-independent."""
    gathered = x[ell_idx.reshape(-1).long()].reshape(*ell_idx.shape, x.shape[1])
    return (gathered * ell_val[..., None]).sum(1)    # (R, B)
