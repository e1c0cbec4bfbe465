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


def check_cuda(name: str, **tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device and contiguous; returns that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name}: all operands must lie on one CUDA device; got "
            + ", ".join(f"{k} on {t.device}" for k, t in tensors.items())
        )
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return next(iter(devices))


def check_dtype(name: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    for k, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {k} must be {dtype}; got {t.dtype}")


def load(name: str, entry: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``entry`` of ``csrc/<name>.cu`` with its argtypes set."""
    fn = getattr(_build.load(name), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


check = _build.check
