"""Plain PyTorch version of the reset-free affine membrane scan."""
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
