"""Wrapper of the SSD intra-chunk block: plain version on CPU, K5 on CUDA,
shapes only on the meta device, with a gradient (:class:`SSDChunk`, its
backward in :mod:`.backward`).  :func:`ssd_chunk_cost` counts one call's
work."""
from __future__ import annotations

import ctypes

import torch

from .. import _common
from .backward import ssd_chunk_backward
from .ref import ssd_chunk_ref

#: Launches of the CUDA kernel by entry point (the plain version counts none).
LAUNCHES = {"ssd_chunk": 0}

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 6
             + [ctypes.c_int, ctypes.c_void_p])
_fn = _scratch_floats = None
#: the meta route's operator library, defined at its first call
_meta_lib = None


def _shapes(x, b, c, la):
    """(G, Q, H, Hg, P, N) of a single-chunk or batched call, or raise."""
    if x.ndim not in (3, 4):
        raise ValueError(f"ssd_chunk: x must be (Q, H, P) or (G, Q, H, P); "
                         f"got {tuple(x.shape)}")
    lead = x.shape[:-2]                          # ([G,] Q)
    h = x.shape[-2]
    hg, n = b.shape[-2:] if b.ndim == x.ndim else (0, 0)
    if (b.shape != lead + (hg, n) or c.shape != b.shape
            or la.shape != lead + (h,)):
        raise ValueError(
            f"ssd_chunk: need x {tuple(lead)}+(H, P), b and c {tuple(lead)}+"
            f"(Hg, N), la {tuple(lead)}+(H,); got {tuple(x.shape)}, "
            f"{tuple(b.shape)}, {tuple(c.shape)}, {tuple(la.shape)}"
        )
    if hg == 0 or h % hg:
        raise ValueError(f"ssd_chunk: H = {h} heads must be a multiple of "
                         f"the Hg = {hg} groups of b and c")
    g = x.shape[0] if x.ndim == 4 else 1
    return g, x.shape[-3], h, hg, x.shape[-1], n


def ssd_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              la: torch.Tensor):
    """Mamba-2 SSD intra-chunk output and chunk state over ``G`` chunks.

    ``x`` ([G,] Q, H, P) is the input already scaled by ``dt``, ``b``/``c``
    ([G,] Q, Hg, N) B and C per group of ``H / Hg`` heads (head ``h`` reads
    group ``h // (H / Hg)``; ``Hg = H`` is the reference's per-head call),
    ``la`` ([G,] Q, H) the log decays.  Returns ``y`` ([G,] Q, H, P) and
    ``state`` ([G,] H, N, P).  Without ``G`` it is the reference's
    single-chunk call.  Every operand must be contiguous, on either device.

    CPU tensors run :func:`ssd_chunk_ref`; meta tensors (a dry run) give
    outputs of the kernel's shapes and dtype through the operator
    ``repro_torch::ssd_chunk``, whose FLOPs ``torch.utils.flop_counter``
    takes from :func:`ssd_chunk_cost`; CUDA tensors run the CUDA kernel
    ``csrc/ssd_chunk.cu`` (f32 operands) or raise: one call of its C entry
    launches two grids, the group scores ``C.B^T`` into a scratch buffer,
    then the per-head blocks.  The two agree within the reference's
    ``rtol = atol = 1e-4``: they sum in other orders, and the kernel's
    products are three TF32 products each (3xTF32).
    """
    _shapes(x, b, c, la)
    _common.check_contiguous("ssd_chunk", x=x, b=b, c=c, la=la)
    return SSDChunk.apply(x, b, c, la)


class SSDChunk(torch.autograd.Function):
    """``ssd_chunk`` with a gradient.  The forward is the device's route
    (the plain version on the CPU, K5 on the card; under activation
    checkpointing the recompute launches K5 again) and saves its four
    inputs; the backward is :func:`ssd_chunk_backward` on either device.
    It never reruns the forward."""

    @staticmethod
    def forward(ctx, x, b, c, la):
        ctx.save_for_backward(x, b, c, la)
        return _forward(x, b, c, la)

    @staticmethod
    def backward(ctx, gy, gstate):
        with torch.profiler.record_function("ssd_chunk_backward"):
            return ssd_chunk_backward(*ctx.saved_tensors, gy, gstate)


def ssd_chunk_cost(g: int, q: int, h: int, p: int, n: int, hg: int):
    """(flops, bytes) of one call over ``g`` chunks of ``q`` positions,
    ``h`` heads of width ``p``, state ``n`` and ``hg`` groups of B and C.

    The products the function needs: the scores ``C.B^T`` once a group
    (they carry no decay, so a group's heads share them) and over ``j <=
    i`` only (the causal half is zero by construction), the decayed scores
    times X a head, and the chunk state's.  Bytes: each f32 operand read
    once (B and C once a group), ``y`` and the state written once."""
    pairs = q * (q + 1) // 2
    flops = g * hg * pairs * 2 * n + g * h * (pairs * 2 * p + 2 * q * n * p)
    n_bytes = 4 * (2 * g * q * h * p + 2 * g * q * hg * n + g * q * h
                   + g * h * n * p)
    return flops, n_bytes


def _meta_outputs(x, b, c, la):
    """The kernel's outputs, shapes and dtype only."""
    h, n, p = x.shape[-2], b.shape[-1], x.shape[-1]
    return (torch.empty_like(x),
            x.new_empty(x.shape[:-3] + (h, n, p), dtype=torch.float32))


def _meta_flops(x_shape, b_shape, c_shape, la_shape, out_shape=None, **kwargs):
    g = x_shape[0] if len(x_shape) == 4 else 1
    q, h, p = x_shape[-3:]
    hg, n = b_shape[-2:]
    return ssd_chunk_cost(g, q, h, p, n, hg)[0]


def _meta_op():
    """``repro_torch::ssd_chunk``: a Meta kernel only (no other device has
    one), with its FLOPs registered for ``torch.utils.flop_counter``."""
    global _meta_lib
    if _meta_lib is None:
        from torch.utils.flop_counter import register_flop_formula

        lib = torch.library.Library("repro_torch", "FRAGMENT")
        lib.define("ssd_chunk(Tensor x, Tensor b, Tensor c, Tensor la) "
                   "-> (Tensor, Tensor)")
        lib.impl("ssd_chunk", _meta_outputs, "Meta")
        register_flop_formula(torch.ops.repro_torch.ssd_chunk)(_meta_flops)
        _meta_lib = lib
    return torch.ops.repro_torch.ssd_chunk.default


def _forward(x, b, c, la):
    if _common.on_cpu(x, b, c, la):
        return ssd_chunk_ref(x, b, c, la)
    g, q, h, hg, p, n = _shapes(x, b, c, la)
    if _common.on_meta(x, b, c, la):
        _common.check_dtype("ssd_chunk", torch.float32, x=x, b=b, c=c, la=la)
        return _meta_op()(x, b, c, la)
    dev = _common.check_cuda("ssd_chunk", x=x, b=b, c=c, la=la)
    _common.check_dtype("ssd_chunk", torch.float32, x=x, b=b, c=c, la=la)
    y = torch.empty_like(x)
    state = torch.empty(x.shape[:-3] + (h, n, p), dtype=torch.float32,
                        device=dev)
    if g * q * h * p * n == 0:
        # a zero-size grid is an invalid launch; an empty chunk sums to 0
        return y.zero_(), state.zero_()
    global _fn, _scratch_floats
    if _fn is None:
        _fn = _common.load("ssd_chunk", "ssd_chunk_f32", _ARGTYPES)
        _scratch_floats = _common.load("ssd_chunk", "ssd_chunk_scratch_floats",
                                       [ctypes.c_int64] * 3, ctypes.c_int64)
    # the kernel's group scores C.B^T (tiles below the diagonal)
    scores = torch.empty(_scratch_floats(g, q, hg), dtype=torch.float32, device=dev)
    # 16-byte copies need every row of x, b and c 16-byte aligned
    vec = int(p % 4 == 0 and n % 4 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, b, c)))
    status = _fn(
        x.data_ptr(), b.data_ptr(), c.data_ptr(), la.data_ptr(),
        y.data_ptr(), state.data_ptr(), scores.data_ptr(), g, q, h, hg, p, n, vec,
        _common.stream(dev),
    )
    _common.check(status, "ssd_chunk")
    LAUNCHES["ssd_chunk"] += 1
    return y, state


__all__ = ["SSDChunk", "ssd_chunk", "ssd_chunk_backward", "ssd_chunk_cost",
           "ssd_chunk_ref", "LAUNCHES"]
