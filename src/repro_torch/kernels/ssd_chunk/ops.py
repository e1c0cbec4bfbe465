"""Wrapper of the SSD intra-chunk block: plain version on CPU, K5 on CUDA."""
from __future__ import annotations

import ctypes

import torch

from .. import _common
from .ref import ssd_chunk_ref

#: Launches of the CUDA kernel (never incremented by the plain version).
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
_fn = None


def _shapes(x, b, c, la):
    """(G, Q, H, P, N) of a single-chunk or batched call, or raise."""
    if x.ndim not in (3, 4):
        raise ValueError(f"ssd_chunk: x must be (Q, H, P) or (G, Q, H, P); "
                         f"got {tuple(x.shape)}")
    lead = x.shape[:-1]                          # ([G,] Q, H)
    n = b.shape[-1]
    if b.shape != lead + (n,) or c.shape != b.shape or la.shape != lead:
        raise ValueError(
            f"ssd_chunk: need x {tuple(lead)}+(P,), b and c {tuple(lead)}+(N,), "
            f"la {tuple(lead)}; got {tuple(x.shape)}, {tuple(b.shape)}, "
            f"{tuple(c.shape)}, {tuple(la.shape)}"
        )
    g = x.shape[0] if x.ndim == 4 else 1
    q, h, p = x.shape[-3:]
    return g, q, h, p, n


def ssd_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              la: torch.Tensor):
    """Mamba-2 SSD intra-chunk output and chunk state over ``G`` chunks.

    ``x`` ([G,] Q, H, P) is the input already scaled by ``dt``, ``b``/``c``
    ([G,] Q, H, N) the per-head B and C (a group shared by several heads is
    materialised per head by the caller), ``la`` ([G,] Q, H) the log
    decays.  Returns ``y`` ([G,] Q, H, P) and ``state`` ([G,] H, N, P).
    Without ``G`` it is the reference's single-chunk call.

    CPU tensors run :func:`ssd_chunk_ref`; CUDA tensors run the CUDA kernel
    ``csrc/ssd_chunk.cu`` (contiguous f32 operands) or raise.  The two
    agree within the reference's ``rtol = atol = 1e-4``: they sum in other
    orders, and the kernel uses fused multiply-adds.
    """
    g, q, h, p, n = _shapes(x, b, c, la)
    if _common.on_cpu(x, b, c, la):
        return ssd_chunk_ref(x, b, c, la)
    dev = _common.check_cuda("ssd_chunk", x=x, b=b, c=c, la=la)
    _common.check_dtype("ssd_chunk", torch.float32, x=x, b=b, c=c, la=la)
    y = torch.empty_like(x)
    state = torch.empty(x.shape[:-3] + (h, n, p), dtype=torch.float32,
                        device=dev)
    if g * q * h * p * n == 0:
        # a zero-size grid is an invalid launch; an empty chunk sums to 0
        return y.zero_(), state.zero_()
    global _fn, LAUNCHES
    if _fn is None:
        _fn = _common.load("ssd_chunk", "ssd_chunk_f32", _ARGTYPES)
    status = _fn(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), la.data_ptr(),
        y.data_ptr(), state.data_ptr(), g, q, h, p, n, _common.stream(dev),
    )
    _common.check(status, "ssd_chunk")
    LAUNCHES += 1
    return y, state


__all__ = ["ssd_chunk", "ssd_chunk_ref", "LAUNCHES"]
