"""Logical-axis sharding rules and the SNN executor's placement primitives.

The reference's rules engine (MaxText-style indirection: every dimension
carries a *logical* name, a rules table maps logical names onto mesh
axes) ported as pure functions over a mesh's axis sizes, so the same
specs come out whether the mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh`, a dict of sizes or
any object whose ``shape`` maps axis names to sizes:

* :func:`make_rules`, :func:`spec_for`, :func:`spec_for_shape` (with the
  fit that degrades any rule that does not divide a dimension to
  replication) and :func:`tree_shardings`;
* :class:`PartitionSpec`, the stand-in for ``jax.sharding.PartitionSpec``:
  a tuple of mesh-axis names (or tuples of names) or ``None`` per dim;
* :func:`local_slices` and :func:`local_shard`, which give the block of a
  spec that a mesh coordinate holds, as JAX's ``devices_indices_map``
  gives it (axes listed together split a dimension major to minor).

The port runs SPMD over ``torch.distributed``: one process a card, the
default process group over all of them.  The reference's device ``r`` of
:func:`snn_mesh`'s ``reshape(n // m, m)`` is the port's rank ``r`` at
mesh coordinate ``(r // m, r % m)``.

* :func:`snn_mesh` builds the ``("data", "model")`` mesh over the world;
  ``None`` for a world of one process (the identity).
* :func:`placement_put` gives a tensor to the rank that a placement
  names; the other ranks do not keep it.
* :func:`snn_rules` is the logical-axis rules table of the SNN runtime.

``sharding_ctx`` and ``constrain`` (the language models' activation
constraints) belong to the LM half of multi-card placement and are not
ported yet (:data:`MULTI_CARD_ITEM`).
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.distributed as dist

#: Where the multi-card placement stands: the queue item that ports the
#: language models' half of it.
MULTI_CARD_ITEM = (
    "the language models' multi-card placement (launch.steps' sharding "
    "trees, make_train_step_compressed, the dry run's --mesh multi) is not "
    "ported yet (ROADMAP.md §1 item 3: multi-card placement, the LM half); "
    "the SNN executor's shard(mesh=) and shard(assignment=) run over "
    "torch.distributed ranks"
)

#: What to do when several cards are visible and no process group runs.
ONE_PROCESS_A_CARD = (
    "{n} CUDA cards are visible but no torch.distributed process group is "
    "initialized: the port runs one process a card; start it with "
    "`torchrun --nproc-per-node {n}` (or init_process_group yourself) "
    "before building a mesh"
)


class PartitionSpec(tuple):
    """A tuple of mesh-axis names (a name, a tuple of names, or ``None``)
    per tensor dimension: the stand-in for ``jax.sharding.PartitionSpec``,
    which reads a tuple of one name as the bare name, as JAX does."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def visible_cards() -> int:
    """The number of visible CUDA cards; raises when there is none."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        raise RuntimeError(
            "no CUDA device is visible; pass n_devices= to plan a placement "
            "without a card"
        )
    return torch.cuda.device_count()


def world_size() -> int:
    """Ranks in the default process group; 1 when none is initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def require_process_group() -> None:
    """Raise unless a process group runs or at most one card is visible."""
    if dist.is_initialized():
        return
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > 1:
        raise RuntimeError(ONE_PROCESS_A_CARD.format(n=n))


def make_rules(*, fsdp: bool = False, multi_pod: bool = False,
               seq_axis: Optional[str] = None,
               kv_seq_shard: bool = False) -> dict:
    """The language models' logical-axis rules (the reference's table)."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "vocab": ("model",),
        "heads": ("model",),
        "mlp": ("model",),
        "expert": ("model",),
        "expert_ff": (),
        "embed": ("data",) if fsdp else (),
        "seq": (seq_axis,) if seq_axis else (),
        "kv_seq": ("model",) if kv_seq_shard else (),
        "layers": (),
        None: (),
    }


def snn_rules() -> dict:
    """Logical-axis rules for the SNN runtime's fused executor.

    The SNN runtime names its dimensions after the paper's structures and
    maps them onto the standard 2-axis ``("data", "model")`` mesh:

        batch   -> "data"     # DP over requests (the micro-batch axis)
        neurons -> "model"    # TP of a layer's target population (the
                              # WDM's n_target rows — "subordinate PEs")
        rows    -> "model"    # serial synaptic rows split like the paper
                              # splits dense matrices across adjacent PEs
        steps   -> None       # the loop axis is never sharded
        cols    -> None       # WDM stacked-input columns stay whole so the
                              # ring gather needs no collective
    """
    return {
        "batch": ("data",),
        "neurons": ("model",),
        "rows": ("model",),
        "steps": (),
        "cols": (),
        None: (),
    }


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh, a dict, or an object whose
    ``shape`` is such a dict."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def spec_for(axes, rules) -> PartitionSpec:
    """axes: tuple of logical names (or None) per dim -> PartitionSpec."""
    return P(*(tuple(m for m in rules.get(a, ()) if m is not None) or None
               for a in axes))


def _fit_axes(mesh_axes, dim: int, mesh):
    """Longest prefix of mesh axes whose size product divides ``dim``.

    Logical rules that do not divide a given tensor (kv=1 heads, odd fused
    projections, a batch of 1) degrade to replication on the offending
    axes.
    """
    sizes = mesh_sizes(mesh)
    axes = tuple(m for m in mesh_axes if m is not None)
    while axes:
        if dim % math.prod(sizes[m] for m in axes) == 0:
            return axes
        axes = axes[:-1]
    return ()


def spec_for_shape(axes, rules, shape, mesh) -> PartitionSpec:
    """The rules' spec for a tensor of ``shape``, each dim fitted."""
    parts = []
    used = set()  # a mesh axis may appear at most once per spec
    for dim, a in zip(shape, axes):
        rule = tuple(m for m in rules.get(a, ()) if m is not None)
        fit = _fit_axes(rule, int(dim), mesh)
        fit = tuple(m for m in fit if m not in used)
        used.update(fit)
        parts.append(fit or None)
    return P(*parts)


def tree_shardings(spec_tree, shape_tree, mesh, rules: dict):
    """Map a tree of logical-axis tuples and the same tree of shaped
    leaves (tensors, or anything with ``.shape``) to ``(mesh,
    PartitionSpec)`` per leaf; every plain tuple of the spec tree is a
    leaf, as in the reference."""
    if isinstance(spec_tree, tuple) and not hasattr(type(spec_tree), "_fields"):
        return mesh, spec_for_shape(spec_tree, rules, shape_tree.shape, mesh)
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, shape_tree[k], mesh, rules)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        kids = [tree_shardings(s, x, mesh, rules)
                for s, x in zip(spec_tree, shape_tree)]
        return type(spec_tree)(*kids) if isinstance(spec_tree, tuple) else kids
    return spec_tree


def local_slices(spec, shape, mesh, coord: Mapping[str, int]):
    """The block of a ``spec``-sharded tensor of ``shape`` held at mesh
    coordinate ``coord`` (``{axis name: index}``), one ``slice`` a dim."""
    sizes = mesh_sizes(mesh)
    out = []
    for k, dim in enumerate(shape):
        part = spec[k] if k < len(spec) else None
        axes = () if part is None else (part,) if isinstance(part, str) else part
        n, idx = 1, 0
        for a in axes:                   # major to minor
            n, idx = n * sizes[a], idx * sizes[a] + coord[a]
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def is_sharded(spec, mesh, dim: int | None = None) -> bool:
    """Does ``spec`` split any dimension (or ``dim``) over more than one
    rank of ``mesh``?"""
    sizes = mesh_sizes(mesh)
    parts = spec if dim is None else (spec[dim] if dim < len(spec) else None,)
    for part in parts:
        axes = () if part is None else (part,) if isinstance(part, str) else part
        if math.prod(sizes[a] for a in axes) > 1:
            return True
    return False


def local_shard(t: torch.Tensor, spec, mesh, coord) -> torch.Tensor:
    """This coordinate's block of ``t`` as a tensor of its own storage
    (``t`` itself where the spec splits nothing)."""
    if not is_sharded(spec, mesh):
        return t
    block = t[local_slices(spec, t.shape, mesh, coord)]
    return block.clone(memory_format=torch.contiguous_format)


def snn_mesh(ranks=None, *, model_axis: int = 1):
    """A ``("data", "model")`` DeviceMesh over the process group's ranks.

    ``None`` for a world of one process — the identity: the caller places
    nothing and no collective runs.  ``model_axis`` ranks split each
    layer's target population (tensor parallelism); the rest split the
    request batch.  Raises :class:`RuntimeError` when several cards are
    visible and no process group runs (start one process a card), and
    :class:`ValueError` when ``model_axis`` does not divide the ranks.
    """
    require_process_group()
    ranks = list(range(world_size())) if ranks is None else list(ranks)
    if len(ranks) <= 1:
        return None
    if model_axis < 1 or len(ranks) % model_axis != 0:
        raise ValueError(
            f"model_axis {model_axis} must divide device count {len(ranks)}"
        )
    return _device_mesh(ranks, (len(ranks) // model_axis, model_axis),
                        ("data", "model"))


def _device_mesh(ranks, shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    # NCCL carries CUDA tensors; every other backend runs on host tensors
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def mesh_coordinate(mesh) -> dict:
    """``{axis name: index}`` of this rank in ``mesh``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def placement_put(t: torch.Tensor, device_index: int):
    """Give ``t`` to the rank ``device_index`` of the process group.

    The placement engine assigns every tiled projection a device; this is
    the primitive that realizes the assignment.  With one process it is
    the **identity**.  Over several ranks the owner keeps ``t`` and every
    other rank gets ``None``: the tensor is not kept there.
    """
    require_process_group()
    n = world_size()
    if n <= 1:
        return t
    if not 0 <= device_index < n:
        raise ValueError(f"device index {device_index} outside 0..{n - 1}")
    return t if dist.get_rank() == device_index else None
