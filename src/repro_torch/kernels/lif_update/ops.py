"""Wrappers of the fused LIF update and of the population step: plain
versions on CPU, K1 on CUDA."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import _common
from .ref import (
    CurrentEdge,
    Edge,
    RingEdge,
    lif_step_ref,
    lif_update_ref,
    ring_deliver_ref,
)

#: Launches of the CUDA kernels by entry point (the plain versions count none).
LAUNCHES = {"lif_update": 0, "lif_step": 0}

#: In-edges one ``lif_step`` launch takes (``kMaxEdges`` in the source).
MAX_EDGES = 8

_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
]


class _EdgeDesc(ctypes.Structure):
    """``struct Edge`` of ``csrc/lif_update.cu``: seven 8-byte fields."""

    _fields_ = [
        ("upd", ctypes.c_void_p), ("ring", ctypes.c_void_p),
        ("s0", ctypes.c_int64), ("s1", ctypes.c_int64), ("s2", ctypes.c_int64),
        ("shift", ctypes.c_int64), ("d_slots", ctypes.c_int64),
    ]


_STEP_ARGTYPES = [
    ctypes.POINTER(_EdgeDesc), ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]
_fn = None
_step_fn = None
_empty_fn = None


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
    one shape (the single-projection runtimes pass a batch-major ``(B, N)``
    state).  CPU tensors run :func:`lif_update_ref`; CUDA tensors run the
    CUDA kernel ``csrc/lif_update.cu`` or raise.  ``alpha`` and ``v_th``
    enter the kernel as f32, rounded once, like the reference's scalars.
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
    global _fn
    if _fn is None:
        _fn = _common.load("lif_update", "lif_update_f32", _ARGTYPES)
    status = _fn(
        i_t.data_ptr(), v.data_ptr(), z.data_ptr(),
        v_new.data_ptr(), z_new.data_ptr(), n,
        ctypes.c_float(alpha), ctypes.c_float(v_th), _common.stream(dev),
    )
    _common.check(status, "lif_update")
    LAUNCHES["lif_update"] += 1
    return v_new, z_new


def _edge_tensors(edges: Sequence[Edge]):
    for e in edges:
        if isinstance(e, RingEdge):
            yield e.ring
            yield e.upd
        else:
            yield e.i


def _describe(edges: Sequence[Edge], batch: int, n: int):
    """The launch's edge descriptors (``struct Edge`` x MAX_EDGES, the
    first ``len(edges)`` filled), each edge checked against ``(B, N)``."""
    desc = (_EdgeDesc * MAX_EDGES)()
    for d, e in zip(desc, edges):
        if isinstance(e, RingEdge):
            ring, upd = e.ring, e.upd
            d_slots = ring.shape[0]
            if ring.dtype != torch.float32 or upd.dtype != torch.float32:
                raise TypeError("lif_step: rings and updates must be float32")
            if ring.shape != (d_slots, batch, n) or upd.shape != ring.shape:
                raise ValueError(
                    f"lif_step: a ring edge needs ring and update of shape "
                    f"{(d_slots, batch, n)}; got {tuple(ring.shape)}, "
                    f"{tuple(upd.shape)}")
            if not ring.is_contiguous():
                raise ValueError("lif_step: ring must be contiguous")
            d.ring, d.d_slots, d.shift = ring.data_ptr(), d_slots, int(e.shift)
            d.s0, d.s1, d.s2 = upd.stride()
            d.upd = upd.data_ptr()
        else:
            i = e.i
            if i.dtype != torch.float32:
                raise TypeError("lif_step: currents must be float32")
            if i.shape != (batch, n):
                raise ValueError(f"lif_step: a current edge needs shape "
                                 f"{(batch, n)}; got {tuple(i.shape)}")
            d.upd = i.data_ptr()
            d.s1, d.s2 = i.stride()
    return desc


def lif_step(
    edges: Sequence[Edge],
    v: torch.Tensor,
    z: torch.Tensor,
    out: torch.Tensor,
    t: int,
    *,
    alpha: float,
    v_th: float,
) -> torch.Tensor:
    """One population's step at time ``t``, in one launch on the card for
    up to :data:`MAX_EDGES` in-edges.

    ``edges`` are the population's in-edges in order
    (:class:`CurrentEdge`, :class:`RingEdge`); ``v`` the ``(B, N)`` f32
    membrane carry and ``z`` the ``(B, N)`` int8 spike carry, both updated
    in place; ``out`` the ``(B, N)`` f32 row of the output train the step
    writes.  Each ring edge's update lands in its ring and the ring's
    current slot is taken and zeroed; the currents are summed in order; the
    population fires as :func:`lif_update`.  CPU tensors run
    :func:`lif_step_ref`; CUDA tensors run ``csrc/lif_update.cu``'s
    ``lif_step_kernel`` or raise: one launch takes :data:`MAX_EDGES` edges,
    and each further launch :data:`MAX_EDGES` - 1 more, reading the
    partial sum that the one before left in ``out`` (which must not overlap
    an in-edge's buffers).  Bitwise equal to the plain version on every
    output and ring.  The launches allocate nothing, copy nothing to the
    device and read nothing back.  Returns ``out``.
    """
    if _common.on_cpu(v, z, out, *_edge_tensors(edges)):
        return lif_step_ref(edges, v, z, out, t, alpha=alpha, v_th=v_th)
    dev = v.device
    if dev.type != "cuda" or any(x.device != dev for x in
                                 (z, out, *_edge_tensors(edges))):
        raise ValueError("lif_step: all operands must lie on one CUDA device")
    if v.dtype != torch.float32 or out.dtype != torch.float32 or z.dtype != torch.int8:
        raise TypeError(f"lif_step: need f32 v and out and int8 z; got "
                        f"{v.dtype}, {out.dtype}, {z.dtype}")
    if v.ndim != 2 or v.shape != z.shape or v.shape != out.shape:
        raise ValueError(f"lif_step: v, z and out must share one (B, N) shape; "
                         f"got {tuple(v.shape)}, {tuple(z.shape)}, {tuple(out.shape)}")
    _common.check_contiguous("lif_step", v=v, z=z, out=out)
    batch, n = v.shape
    edges = list(edges)
    chunks = [edges[:MAX_EDGES]]
    for j in range(MAX_EDGES, len(edges), MAX_EDGES - 1):
        chunks.append([CurrentEdge(out)] + edges[j:j + MAX_EDGES - 1])
    descs = [_describe(chunk, batch, n) for chunk in chunks]
    if batch * n == 0:
        return out                   # a zero-size grid is an invalid launch
    global _step_fn
    if _step_fn is None:
        _step_fn = _common.load("lif_update", "lif_step_f32", _STEP_ARGTYPES)
    for j, (chunk, desc) in enumerate(zip(chunks, descs)):
        status = _step_fn(
            desc, len(chunk), v.data_ptr(), z.data_ptr(), out.data_ptr(),
            batch, n, int(t), ctypes.c_float(alpha), ctypes.c_float(v_th),
            int(j == len(chunks) - 1), _common.stream(dev),
        )
        _common.check(status, "lif_step")
        LAUNCHES["lif_step"] += 1
    return out


def empty_launch(device=None) -> None:
    """Launch a kernel that does nothing on ``device``'s current stream (the
    card's launch floor, for timing); counts no launch of K1."""
    global _empty_fn
    if _empty_fn is None:
        _empty_fn = _common.load("lif_update", "empty_launch", [ctypes.c_void_p])
    dev = torch.device("cuda" if device is None else device)
    _common.check(_empty_fn(_common.stream(dev)), "empty_launch")


__all__ = [
    "CurrentEdge", "RingEdge", "MAX_EDGES", "LAUNCHES", "empty_launch",
    "lif_step", "lif_step_ref", "lif_update", "lif_update_ref",
    "ring_deliver_ref",
]
