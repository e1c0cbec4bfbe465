"""Wrappers of the affine membrane scan and of the iterative fixed point:
plain versions on CPU, K4 on CUDA."""
from __future__ import annotations

import ctypes

import torch

from .. import _common
from .ref import lif_fixed_point_ref, lif_parallel_scan_ref

#: Launches of the CUDA kernels by entry point (the plain versions count none).
LAUNCHES = {"lif_parallel_scan": 0, "lif_fixed_point": 0}

_ARGTYPES = [ctypes.c_void_p] * 2 + [
    ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p,
]
_FP_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
#: features a block of the fixed-point kernel runs, and steps a spike word
#: holds (``kFeat`` and ``kChunk`` in the source)
_FEAT, _CHUNK = 32, 32
_fn = None
_fp_fn = None
_limits_of = {}


def lif_parallel_scan(c: torch.Tensor, *, alpha: float) -> torch.Tensor:
    """All-timesteps ``v[t] = alpha*v[t-1] + c[t]`` for ``c`` of shape (T, F).

    CPU tensors run :func:`lif_parallel_scan_ref`; CUDA tensors run the
    CUDA kernel ``csrc/lif_parallel_scan.cu`` or raise.  Both walk T in
    order with separately rounded f32 ops, so they agree bit for bit at
    any ``alpha``.  ``alpha`` enters the kernel as f32, rounded once.
    """
    if c.ndim != 2:
        raise ValueError(
            f"lif_parallel_scan: need (T, F); got {tuple(c.shape)}"
        )
    if _common.on_cpu(c):
        return lif_parallel_scan_ref(c, alpha=alpha)
    dev = _common.check_cuda("lif_parallel_scan", c=c)
    _common.check_dtype("lif_parallel_scan", torch.float32, c=c)
    v = torch.empty_like(c)
    steps, feat = c.shape
    if steps == 0 or feat == 0:
        return v                     # a zero-size grid is an invalid launch
    global _fn
    if _fn is None:
        _fn = _common.load("lif_parallel_scan", "affine_scan_f32", _ARGTYPES)
    status = _fn(
        c.data_ptr(), v.data_ptr(), steps, feat, ctypes.c_float(alpha),
        _common.stream(dev),
    )
    _common.check(status, "lif_parallel_scan")
    LAUNCHES["lif_parallel_scan"] += 1
    return v


def _limits(device: torch.device):
    key = torch.device(device).index or 0
    if key not in _limits_of:
        fn = _common.load("lif_parallel_scan", "fixed_point_limits",
                          [ctypes.POINTER(ctypes.c_int64)] * 2)
        staged, most = ctypes.c_int64(), ctypes.c_int64()
        with torch.cuda.device(key):
            status = fn(ctypes.byref(staged), ctypes.byref(most))
        if status != 0:
            raise RuntimeError("lif_fixed_point: cannot read the device's "
                               "shared-memory limit")
        _limits_of[key] = (staged.value, most.value)
    return _limits_of[key]


def staged_steps_limit(device: torch.device) -> int:
    """The longest train whose currents the fixed-point kernel stages in
    shared memory on ``device``; longer trains are read from device memory
    on each pass (their spikes, a bit a step, stay in shared memory up to
    :func:`shared_words_limit`)."""
    return _limits(device)[0]


def shared_words_limit(device: torch.device) -> int:
    """The longest train whose spike words (a bit a step) the fixed-point
    kernel keeps in shared memory on ``device``; a longer train keeps them
    in a device-memory scratch buffer the wrapper allocates."""
    return _limits(device)[1]


def _check_fixed_point_args(i_flat: torch.Tensor, cap: int) -> None:
    if i_flat.ndim != 2:
        raise ValueError(
            f"lif_fixed_point: need (T, F); got {tuple(i_flat.shape)}"
        )
    if int(cap) < 1:
        raise ValueError(f"lif_fixed_point: cap must be >= 1; got {cap}")


def lif_fixed_point_launch(
    i_flat: torch.Tensor, *, alpha: float, v_th: float, cap: int
):
    """:func:`lif_fixed_point` without the host read: returns ``(z,
    stats)``, ``stats`` an int32 tensor ``(passes, residual)`` on the
    tensor's device, so that the launch can be timed or captured."""
    _check_fixed_point_args(i_flat, cap)
    if _common.on_cpu(i_flat):
        z, iters, residual = lif_fixed_point_ref(
            i_flat, alpha=alpha, v_th=v_th, cap=cap)
        return z, torch.tensor([iters, residual], dtype=torch.int32)
    dev = _common.check_cuda("lif_fixed_point", i_flat=i_flat)
    _common.check_dtype("lif_fixed_point", torch.float32, i_flat=i_flat)
    steps, feat = i_flat.shape
    z = torch.empty_like(i_flat)
    if steps == 0 or feat == 0:        # the reference loop: one empty pass
        return z, torch.tensor([1, 0], dtype=torch.int32, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)
    global _fp_fn
    if _fp_fn is None:
        _fp_fn = _common.load("lif_parallel_scan", "lif_fixed_point_f32",
                              _FP_ARGTYPES)
    staged, most = _limits(dev)
    # where the block keeps its train: currents and spike words in shared
    # memory (0), the spike words only (1), or neither (2: the words in a
    # device-memory scratch buffer, one per feature and 32 steps)
    mode = 0 if steps <= staged else 1 if steps <= most else 2
    scratch = None
    if mode == 2:
        blocks = -(-feat // _FEAT)
        scratch = torch.empty(blocks * _FEAT * -(-steps // _CHUNK),
                              dtype=torch.int32, device=dev)
    status = _fp_fn(
        i_flat.data_ptr(), z.data_ptr(), stats.data_ptr(),
        None if scratch is None else scratch.data_ptr(), steps, feat,
        ctypes.c_float(alpha), ctypes.c_float(v_th), int(cap), mode,
        _common.stream(dev),
    )
    _common.check(status, "lif_fixed_point")
    LAUNCHES["lif_fixed_point"] += 1
    return z, stats


def lif_fixed_point(
    i_flat: torch.Tensor, *, alpha: float, v_th: float, cap: int
):
    """The iterative reset mode's fixed point over a ``(T, F)`` f32 train.

    Returns ``(z, passes, residual)`` like :func:`lif_fixed_point_ref`:
    f32 0/1 spikes and two host ints.  CPU tensors run the plain version,
    one host read a pass; CUDA tensors run the whole loop in one launch of
    ``csrc/lif_parallel_scan.cu`` (each feature runs its own passes) and
    read the two ints back once, or raise.  Bitwise equal to the plain
    version, passes and residual included.  ``cap >= 1``; an empty train
    gives zeros with ``(1, 0)`` and no launch, as the plain loop does.
    """
    _check_fixed_point_args(i_flat, cap)
    if _common.on_cpu(i_flat):
        return lif_fixed_point_ref(i_flat, alpha=alpha, v_th=v_th, cap=cap)
    z, stats = lif_fixed_point_launch(i_flat, alpha=alpha, v_th=v_th, cap=cap)
    iters, residual = stats.tolist()         # the one host read
    return z, iters, residual


__all__ = [
    "lif_fixed_point", "lif_fixed_point_launch", "lif_fixed_point_ref",
    "lif_parallel_scan", "lif_parallel_scan_ref", "shared_words_limit",
    "staged_steps_limit", "LAUNCHES",
]
