"""Argument checks and ``ctypes`` plumbing shared by the kernel wrappers."""
from __future__ import annotations

import ctypes

import torch

from . import _build


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True iff every tensor lies on the CPU (the plain versions' case).

    Anything else goes to the kernel, whose wrapper raises unless every
    tensor is a CUDA tensor on one device."""
    return all(t.device.type == "cpu" for t in tensors)


def on_meta(*tensors: torch.Tensor) -> bool:
    """True iff every tensor lies on the meta device (a dry run: shapes
    and dtypes, no storage)."""
    return all(t.device.type == "meta" for t in tensors)


def check_cuda(name: str, strided=(), **tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device and contiguous, except those named in
    ``strided`` (whose kernel takes their strides); returns that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name}: all operands must lie on one CUDA device; got "
            + ", ".join(f"{k} on {t.device}" for k, t in tensors.items())
        )
    check_contiguous(name, **{k: t for k, t in tensors.items() if k not in strided})
    return next(iter(devices))


def check_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def check_dtype(name: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    for k, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {k} must be {dtype}; got {t.dtype}")


def load(name: str, entry: str, argtypes, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry ``entry`` of ``csrc/<name>.cu`` with its types set."""
    fn = getattr(_build.load(name), entry)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


check = _build.check
