"""Default-device resolution for the port's entry points.

Every entry point takes ``device=None``.  ``None`` means the CUDA card —
the port exists to run there — and raises when no card is visible, so a
caller never falls back to the CPU without asking.  ``device="cpu"`` runs
the kernels' plain PyTorch versions (the CPU tests do this).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` -> ``cuda`` or raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def require_full_f32(device: torch.device) -> None:
    """Raise if float32 matrix products on ``device`` would run in TF32.

    The SNN's dense currents are exact only in full f32, and the language
    models hold the reference's f32 products; the port never flips the
    global flag itself, it refuses to run with it on."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the dense spike "
            "currents need full float32 products to stay exact, and the "
            "language models the reference's float32 products"
        )
