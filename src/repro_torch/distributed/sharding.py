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

The language models place their trees with DTensor, PyTorch's
counterpart of GSPMD (``torch.distributed.tensor``):

* :class:`NamedSharding` is ``(mesh, spec)`` with the DTensor
  ``placements`` the spec means; :func:`tree_shardings` gives one a leaf;
* :func:`shard_tree` gives each rank its DTensor blocks of full host
  tensors (the counterpart of ``jit``'s ``in_shardings``; no collective
  runs), :func:`gather_tree` the full tensors back (``out_shardings``
  replicated);
* :func:`sharding_ctx` and :func:`constrain` are the reference's
  activation constraints: inside the context ``constrain`` redistributes a
  DTensor to the rules' spec for its shape, and a plain tensor made inside
  the step (a mask, the positions) counts as replicated over the mesh;
  outside it ``constrain`` is the identity.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

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


def placements_for(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a DeviceMesh): one
    per mesh axis, ``Shard(d)`` where the spec splits dim ``d`` over that
    axis of more than one rank, else ``Replicate()``.  A dim split over several axes splits in
    the mesh's axis order, major to minor (DTensor's order for ``Shard(d)``
    on several mesh dims, and JAX's for ``("pod", "data")``); a spec that
    lists them in another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        axes = () if part is None else (part,) if isinstance(part, str) else part
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} lists mesh axes {axes} "
                             f"out of the mesh's order {tuple(names)}")
        for i in idx:
            # a split over one rank is no split (and DTensor would refuse
            # to reshape a dim it holds split)
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """The stand-in for ``jax.sharding.NamedSharding``: a mesh and a
    :class:`PartitionSpec`; :attr:`placements` are the DTensor placements
    they mean (the mesh must then be a DeviceMesh)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def tree_shardings(spec_tree, shape_tree, mesh, rules: dict):
    """Map a tree of logical-axis tuples and the same tree of shaped
    leaves (tensors, or anything with ``.shape``) to a
    :class:`NamedSharding` per leaf; every plain tuple of the spec tree is
    a leaf, as in the reference."""
    if isinstance(spec_tree, tuple) and not hasattr(type(spec_tree), "_fields"):
        return NamedSharding(mesh, spec_for_shape(spec_tree, rules,
                                                  shape_tree.shape, mesh))
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

    # NCCL, and the host-staged backend named for "cuda:", carry CUDA
    # tensors (DTensor moves every block to its mesh's device type); every
    # other backend runs on host tensors (a fake world's meta tensors too:
    # DTensor then runs a shard-to-shard redistribution as an all-gather
    # and a local chunk, not an all-to-all)
    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" or "cuda:" in backend else "cpu"
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


# -- DTensor trees -----------------------------------------------------------------

def _is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def _zip_map(fn, tree, shardings):
    """``fn(leaf, sharding)`` over a tree and its tree of shardings (the
    shardings' tree may stop at a :class:`NamedSharding` above a subtree,
    as ``opt_shardings``' ``step`` does not; ``None`` leaves stay)."""
    if _is_sharding(shardings):
        return fn(tree, shardings)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], shardings[k]) for k in tree}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(_zip_map(fn, getattr(tree, f), getattr(shardings, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, t, s) for t, s in zip(tree, shardings))
    raise TypeError(f"no sharding for a leaf of type {type(tree).__name__}")


def shard_leaf(t: torch.Tensor, sharding: NamedSharding, device=None):
    """This rank's DTensor block of the full tensor ``t`` (every rank holds
    all of ``t``; nothing moves between ranks), on ``device`` (default:
    ``t``'s).  The block is :func:`local_slices`' at this rank's mesh
    coordinate, which ``DTensor.from_local`` takes as the placements'."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    t = torch.as_tensor(t)
    block = local_shard(t, sharding.spec, mesh, mesh_coordinate(mesh))
    block = block.to(t.device if device is None else device)
    if block is t:
        block = t.clone()
    return DTensor.from_local(block, mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape, device="meta").stride())


def shard_tree(tree, shardings, device=None):
    """Every leaf of ``tree`` (full tensors, the same on every rank) as
    this rank's DTensor block under the same tree of
    :class:`NamedSharding` s: the counterpart of ``jax.jit``'s
    ``in_shardings``."""
    return _zip_map(lambda t, s: shard_leaf(t, s, device), tree, shardings)


def gather_tree(tree):
    """Every DTensor leaf of ``tree`` as its full tensor on every rank (the
    counterpart of replicated ``out_shardings``); other leaves stay."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(gather_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v) for v in tree)
    return tree


def map_blocks(fn, t):
    """``fn`` on a DTensor's local block, re-wrapped with its placements
    (none may be a pending sum); on any other tensor ``fn(t)``.  For work
    that ranks holding the same block do alike (a gradient's sum across
    pods)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return fn(t)
    if any(p.is_partial() for p in t.placements):
        raise ValueError(f"a DTensor with pending sums {t.placements}: "
                         "redistribute it first")
    return DTensor.from_local(fn(t.to_local()), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape, stride=t.stride())


def resolve_partial(t):
    """A DTensor with its pending sums done (each ``Partial`` placement
    made ``Replicate``, the others kept); any other tensor itself."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


# -- activation constraint context ------------------------------------------------

_ctx = threading.local()


def current_ctx():
    """``(mesh, rules)`` of the active :func:`sharding_ctx`, or None."""
    return getattr(_ctx, "v", None)


@contextlib.contextmanager
def sharding_ctx(mesh, rules: dict):
    """While active, :func:`constrain` redistributes to the rules' specs on
    ``mesh`` (a DeviceMesh), and plain tensors that meet a DTensor in an op
    count as replicated over the mesh (DTensor's ``implicit_replication``:
    the masks, positions and zero buffers a step makes for itself)."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = current_ctx()
    _ctx.v = (mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        _ctx.v = prev


def constrain(x, axes):
    """Constrain activation ``x`` to the logical ``axes`` if a ctx is
    active: the DTensor ``x`` redistributed to the rules' spec for its
    shape.  Inside a context ``x`` must be a DTensor on the context's mesh
    (a plain tensor there raises: the step was not given its shardings)."""
    ctx = current_ctx()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    mesh, rules = ctx
    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain{tuple(axes)}: a {type(x).__name__} inside "
            "sharding_ctx; shard the step's inputs with shard_tree first")
    spec = spec_for_shape(axes, rules, x.shape, mesh)
    return x.redistribute(mesh, placements_for(spec, mesh))
