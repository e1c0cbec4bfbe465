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
