"""Mesh builders over the ranks of a ``torch.distributed`` process group
(the port of ``repro.launch.mesh``).

Functions, not module constants, so importing this module touches no
process group.  The port runs one process a card: a mesh's entries are
ranks of the default group, laid out row-major as the reference lays out
its devices, so rank ``r`` of a ``(d, m)`` mesh sits at ``(r // m, r %
m)``.

:func:`fake_world` is the counterpart of the reference's
``--xla_force_host_platform_device_count=512``: a world of ``n`` ranks in
one process with no card (``torch.distributed``'s ``"fake"`` backend,
whose collectives move nothing), over which the builders give a mesh on
the meta device.  The dry run traces one rank's step on it.
"""
from __future__ import annotations

import contextlib
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


def make_mesh(shape, axes):
    """A mesh of ``shape`` with axis names ``axes`` over the first ranks of
    the world (row-major, as the builders above lay theirs out)."""
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}; have "
                           f"{_world()}")
    return _device_mesh(range(n), tuple(shape), tuple(axes))


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


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A process group of ``world_size`` ranks in this process, this
    process being ``rank``; its collectives return without moving data
    (the dry run counts them from the trace).  Raises if a process group
    already runs."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized")
    # the fake backend registers itself when this module is imported
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
