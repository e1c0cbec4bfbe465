"""PyTorch/CUDA port of the SNN switching system.

The reference is the JAX package ``repro``; this package keeps its module
layout and names so each counterpart is easy to find, but imports nothing
of it (and never JAX).  The host side (graph IR, paradigm compilers, cost
model, dataset, AdaBoost, switching compiler) is a NumPy copy under
:mod:`repro_torch.core`; the runtime under :mod:`repro_torch.core.runtime`
is torch, and the three per-step kernels of the fused executor are
hand-written CUDA C++ for Hopper (``csrc/``), bound with ``ctypes`` by
:mod:`repro_torch.kernels`.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`); with no device given and
no CUDA present they raise rather than carry on on the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
