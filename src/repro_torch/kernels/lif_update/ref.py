"""Plain PyTorch version of the fused LIF neural-update step (Eq. 1)."""
from __future__ import annotations

import torch


def lif_update_ref(
    i_t: torch.Tensor,    # f32 input current, any shape
    v: torch.Tensor,      # f32 membrane potential, same shape
    z: torch.Tensor,      # f32 previous spikes (0/1), same shape
    *,
    alpha: float,
    v_th: float,
):
    """``v' = i + alpha*v - z*v_th``; ``z' = [v' >= v_th]``.

    Each operation is one separately rounded f32 op with the scalars
    rounded to f32 once, as in the reference's elementwise expression."""
    v_new = i_t + alpha * v - z * v_th
    z_new = (v_new >= v_th).to(torch.float32)
    return v_new, z_new
