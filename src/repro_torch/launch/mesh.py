"""Mesh builders over the ranks of a ``torch.distributed`` process group
(the port of ``repro.launch.mesh``).

Functions, not module constants, so importing this module touches no
process group.  The port runs one process a card: a mesh's entries are
ranks of the default group, laid out row-major as the reference lays out
its devices, so rank ``r`` of a ``(d, m)`` mesh sits at ``(r // m, r %
m)``.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from ..distributed.sharding import _device_mesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh is built over the ranks of a torch.distributed process "
            "group, and none is initialized: start one process a card "
            "(`torchrun --nproc-per-node N`) or call init_process_group"
        )
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks when ``multi_pod``,
    over the first ranks of the world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _world()
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}; have {have} (one process a "
            "card: start the world with as many ranks)"
        )
    return _device_mesh(range(n), shape, axes)


def make_host_mesh(model_parallel: int = 1):
    """A ``(world // model_parallel, model_parallel)`` ``("data",
    "model")`` mesh over the first ranks of the world (tests, examples,
    one card: ``(1, 1)``)."""
    n = _world()
    data = n // model_parallel
    if data < 1:
        raise ValueError(
            f"model_parallel {model_parallel} exceeds the world's {n} ranks")
    return _device_mesh(range(data * model_parallel), (data, model_parallel),
                        ("data", "model"))
