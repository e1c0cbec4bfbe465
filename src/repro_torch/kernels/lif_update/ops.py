"""Wrapper of the fused LIF update: plain version on CPU, K1 on CUDA."""
from __future__ import annotations

import ctypes

import torch

from .. import _common
from .ref import lif_update_ref

#: Launches of the CUDA kernel (never incremented by the plain version).
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
]
_fn = None


def lif_update(
    i_t: torch.Tensor,
    v: torch.Tensor,
    z: torch.Tensor,
    *,
    alpha: float,
    v_th: float,
):
    """Fused ``V' = I + alpha*V - z*V_th``; ``z' = V' >= V_th``.

    Elementwise, so any layout works as long as the three f32 maps share
    one shape (the executor passes its batch-major ``(B, N)`` carry).
    CPU tensors run :func:`lif_update_ref`; CUDA tensors run the CUDA
    kernel ``csrc/lif_update.cu`` or raise.  ``alpha`` and ``v_th`` enter
    the kernel as f32, rounded once, like the reference's scalars.
    """
    if _common.on_cpu(i_t, v, z):
        return lif_update_ref(i_t, v, z, alpha=alpha, v_th=v_th)
    dev = _common.check_cuda("lif_update", i_t=i_t, v=v, z=z)
    _common.check_dtype("lif_update", torch.float32, i_t=i_t, v=v, z=z)
    if not (i_t.shape == v.shape == z.shape):
        raise ValueError(
            f"lif_update: shapes differ: {i_t.shape}, {v.shape}, {z.shape}"
        )
    v_new = torch.empty_like(i_t)
    z_new = torch.empty_like(i_t)
    n = i_t.numel()
    if n == 0:
        return v_new, z_new          # a zero-size grid is an invalid launch
    global _fn, LAUNCHES
    if _fn is None:
        _fn = _common.load("lif_update", "lif_update_f32", _ARGTYPES)
    status = _fn(
        i_t.data_ptr(), v.data_ptr(), z.data_ptr(),
        v_new.data_ptr(), z_new.data_ptr(), n,
        ctypes.c_float(alpha), ctypes.c_float(v_th), _common.stream(dev),
    )
    _common.check(status, "lif_update")
    LAUNCHES += 1
    return v_new, z_new


__all__ = ["lif_update", "lif_update_ref", "LAUNCHES"]
