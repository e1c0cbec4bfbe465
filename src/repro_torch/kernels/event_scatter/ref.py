"""Plain PyTorch version of the event form's update half: the sweep."""
from __future__ import annotations

import torch


def event_scatter_ref(
    row_weight: torch.Tensor,   # (R,) f32 signed weight
    row_delay: torch.Tensor,    # (R,) i32 in [1, d_slots)
    row_src: torch.Tensor,      # (R,) i32 source index in [0, S)
    row_tgt: torch.Tensor,      # (R,) i32 target index in [0, n_target)
    x: torch.Tensor,            # (B, S) f32 spikes
    t: int,
    *,
    d_slots: int,
    n_target: int,
) -> torch.Tensor:
    """``out[b, (delay[r] + t) mod d_slots, tgt[r]] += x[b, src[r]] *
    weight[r]`` over every row ``r``, whether its source fired or not;
    ``(B, d_slots, n_target)`` f32.

    One flat ``index_add_`` over all ``B * R`` (batch, row) pairs with
    batch-offset segment ids (the reference's XLA ``segment_sum``).  On
    CUDA ``index_add_`` accumulates with atomics, so the order of the sums
    changes from run to run; the result is still exact, because every
    weight is an int8-magnitude integer and every current an integer below
    2^24."""
    batch = x.shape[0]
    fired = x[:, row_src.long()]                     # (B, R)
    contrib = fired * row_weight[None, :]            # (B, R)
    slot = (row_delay + t) % d_slots                 # (R,) floor-mod
    seg = slot * n_target + row_tgt                  # ring-flat segment ids
    # batch b's rows are offset into their own block of d_slots * n_target
    # segments
    seg_flat = (
        torch.arange(batch, dtype=torch.int64, device=x.device)[:, None]
        * (d_slots * n_target)
        + seg[None, :]
    ).reshape(-1)                                    # (B*R,)
    return torch.zeros(
        batch * d_slots * n_target, dtype=torch.float32, device=x.device
    ).index_add_(0, seg_flat, contrib.reshape(-1)).view(batch, d_slots, n_target)
