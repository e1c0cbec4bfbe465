"""Plain PyTorch versions of the reset-free affine membrane scan and of the
iterative reset mode's fixed point built on it."""
from __future__ import annotations

import torch


def lif_parallel_scan_ref(c: torch.Tensor, *, alpha: float) -> torch.Tensor:
    """``v[t] = alpha*v[t-1] + c[t]`` for ``c`` of shape ``(T, ...)``, zero init.

    The sequential recurrence, one separately rounded f32 multiply and add
    a step (``alpha`` rounded to f32 once), so ``v[0] = c[0]`` exactly.
    The reference package resolves the same recurrence as a tree
    (``associative_scan``); the two orders agree exactly for alpha in
    {0, 1} and wherever every partial sum is representable, and differ by
    rounding otherwise.
    """
    v = torch.empty_like(c)
    if c.shape[0] == 0:
        return v
    acc = c[0]
    v[0] = acc
    for t in range(1, c.shape[0]):
        acc = alpha * acc + c[t]
        v[t] = acc
    return v


def lif_fixed_point_ref(
    i_flat: torch.Tensor, *, alpha: float, v_th: float, cap: int
):
    """The iterative reset mode's fixed point over a ``(T, F)`` current train.

    Pass k feeds the spikes of pass k-1 into the reset currents ``c[t] =
    i[t] - z[t-1]*v_th``, scans them and thresholds; passes repeat while a
    spike flipped and fewer than ``cap`` ran: the reference's
    ``lax.while_loop`` with the same stopping rule, reading the flip count
    back to the host once a pass.  Returns ``(z, passes, residual)``: the
    f32 0/1 spikes and two host ints, the residual being the last pass's
    flip count (0 on convergence, positive only when the cap cut the loop).
    """
    vth = float(v_th)                                  # enters the ops as f32
    z = torch.zeros_like(i_flat)
    iters, diff = 0, 1
    while diff > 0 and iters < cap:
        zprev = torch.cat([torch.zeros_like(z[:1]), z[:-1]])
        v = lif_parallel_scan_ref(i_flat - zprev * vth, alpha=alpha)
        z_new = (v >= vth).to(torch.float32)
        # the one host read of the pass: go on while any spike flipped
        diff = int((z_new != z).sum())
        iters, z = iters + 1, z_new
    return z, iters, diff
