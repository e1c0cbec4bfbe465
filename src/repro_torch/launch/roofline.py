"""Roofline analysis of a step traced on the meta device (the port of
``repro.launch.roofline``).

Three terms per (arch x shape) cell, at one H100's constants
(:class:`~.hardware.H100Config`):

    compute    = sum over precisions of FLOPs[precision] / peak[precision]
    memory     = bytes / 3.35e12
    collective = sum over collective ops of ring-model time on the links

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` of a
compiled program; the port counts them over one eager step traced on the
meta device (:func:`count_step`), and its peak memory with
``torch.distributed._tools.mem_tracker.MemTracker``.  Over a mesh the
step runs on DTensors: the counters see the ops each rank runs on its
local blocks (FLOPs, bytes and memory a device, not the whole step's) and
every collective it issues (``torch.ops._c10d_functional``, DTensor's
all-to-all ``_dtensor.shard_dim_alltoall``, and the ``c10d`` point-to-point
ops of the compressed ring), each with its group's size, its ranks and
the bytes of its result, under the reference's ring factors

    all-reduce          2 (n-1)/n x bytes     (reduce-scatter + all-gather)
    all-gather            (n-1)/n x bytes     (bytes = gathered output)
    reduce-scatter        (n-1)   x bytes     (bytes = scattered output)
    all-to-all            (n-1)/n x bytes
    collective-permute          1 x bytes

at the bandwidth of the group's links (:meth:`H100Config.link_bandwidth`).
On one card no collective runs and the term is 0.  The reference's HLO
parser (``collective_bytes_from_hlo``) is kept beside it.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import re
import time
from typing import Dict

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .hardware import H100, H100Config, K5_PRECISION

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# result shapes of an HLO instruction: "bf16[8,512]{1,0}" (possibly a tuple)
_SHAPE_RE = re.compile(r"(\w+?)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_type: Dict[str, int]
    count_by_type: Dict[str, int]
    ring_time_s: float

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_type.values())


def _ring_factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "all-gather":
        return (n - 1) / n
    if op == "reduce-scatter":
        return float(n - 1)
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute


def collective_bytes_from_hlo(
    hlo_text: str, *, link_bw: float = H100.nvlink_bandwidth,
    default_group: int = 16,
) -> CollectiveStats:
    bytes_by: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    count_by: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    time_s = 0.0
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if stripped.startswith("//"):
            continue
        op = None
        for c in _COLLECTIVES:
            # match the op position: "= <shape> all-reduce(" or "-start("
            if f" {c}(" in stripped or f" {c}-start(" in stripped:
                op = c
                break
        if op is None:
            continue
        lhs = stripped.split(f" {op}")[0]
        total = sum(_shape_bytes(d, s) for d, s in _SHAPE_RE.findall(lhs))
        if total == 0:
            continue
        m = _GROUPS_RE.search(stripped)
        if m:
            n = len(m.group(1).split(","))
        else:
            m2 = _GROUPS_IOTA_RE.search(stripped)
            n = int(m2.group(2)) if m2 else default_group
        bytes_by[op] += total
        count_by[op] += 1
        time_s += total * _ring_factor(op, n) / link_bw
    return CollectiveStats(bytes_by, count_by, time_s)


@dataclasses.dataclass
class RooflineTerms:
    """``flops`` is the total; ``flops_by_dtype`` splits it by the
    precision of the products (see :meth:`H100Config.peak`).  Without the
    split every FLOP is a bf16 FLOP, the reference's ``flops / peak_bf16``."""
    flops: float
    hbm_bytes: float
    collectives: CollectiveStats
    chips: int
    hw: H100Config = dataclasses.field(default_factory=H100Config)
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        if not self.flops_by_dtype:
            return self.flops / self.hw.peak_flops_bf16
        return sum(f / self.hw.peak(p) for p, f in self.flops_by_dtype.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bandwidth

    @property
    def collective_s(self) -> float:
        return self.collectives.ring_time_s

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """compute_term / bound — fraction of peak the dominant term allows."""
        if self.bound_s == 0:
            return 0.0
        return self.compute_s / self.bound_s

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes": self.collectives.bytes_by_type,
            "collective_counts": self.collectives.count_by_type,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "roofline_fraction": self.roofline_fraction(),
        }


# ---------------------------------------------------------------------------
# counting a step on the meta device
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
#: ops that move no bytes besides the views: they allocate, or rename storage
_NO_TRAFFIC = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten._unsafe_view, _aten.lift_fresh,
}
#: ops whose products run at another precision than their operands' dtype
_OP_PRECISION = {"repro_torch::ssd_chunk": K5_PRECISION}


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses (a broadcast axis,
    stride 0, reads its elements once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's block on this rank; any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree`` (this
    rank's blocks of DTensors)."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = _local(t).untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


#: collective ops a traced step issues -> the reference's HLO op name
_COLLECTIVE_OPS = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
}


def _group_ranks(args) -> list:
    """Global ranks of the process group a collective op names (by group
    name or as a ProcessGroup argument)."""
    from torch.distributed.distributed_c10d import (
        _resolve_process_group, get_process_group_ranks,
    )

    for a in args:
        if isinstance(a, str):
            try:
                pg = _resolve_process_group(a)
            except (ValueError, RuntimeError, KeyError):
                continue
            return get_process_group_ranks(pg)
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(
                a._type().qualified_name()):
            a = torch.distributed.ProcessGroup.unbox(a)
        if isinstance(a, torch.distributed.ProcessGroup):
            return get_process_group_ranks(a)
    raise ValueError("a collective op without a process group argument: "
                     f"{[type(a).__name__ for a in args]}")


class _OpCounter(TorchDispatchMode):
    """FLOPs by precision, bytes and devices of every op dispatched under
    it, and the collectives.  On a DTensor op it lets DTensor run first
    (returns ``NotImplemented``), so it counts the local ops each rank runs
    and the collectives DTensor inserts, as ``CommDebugMode`` does."""

    def __init__(self, hw: H100Config = H100):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.hw = hw
        self.flops = collections.Counter()
        self.bytes = 0
        self.devices = set()
        self.coll_bytes = collections.Counter()
        self.coll_counts = collections.Counter()
        self.coll_time = 0.0
        self.fake_mode = None

    def __enter__(self):
        # ops under another fake mode than the one at entry are DTensor's
        # shape propagation, not the step's (MemTracker's rule)
        self.fake_mode = active_fake_mode()
        return super().__enter__()

    def _collective(self, op: str, args, out) -> None:
        ranks = _group_ranks(args)
        if op == "collective-permute":
            res = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
        else:
            res = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        n_bytes = sum(t.numel() * t.element_size() for t in res)
        self.coll_bytes[op] += n_bytes
        self.coll_counts[op] += 1
        self.coll_time += (n_bytes * _ring_factor(op, len(ranks))
                           / self.hw.link_bandwidth(ranks))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self.fake_mode:
            return out      # DTensor's sharding propagation on fake tensors
        coll = _COLLECTIVE_OPS.get(func._schema.name)
        if coll is not None:
            self._collective(coll, args, out)
        if func.namespace in ("_c10d_functional", "c10d", "_dtensor"):
            return out          # a collective (or its wait) is not HBM traffic
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        # host integer tensors are DTensor's mesh bookkeeping, not the step's
        self.devices.update(t.device.type for t in ins + outs if t.numel() and (
            t.is_floating_point() or t.device.type != "cpu"))
        packet = func._overloadpacket
        if packet in self.registry:
            precision = _OP_PRECISION.get(func._schema.name) or str(
                functools.reduce(torch.promote_types, [t.dtype for t in ins])
            ).removeprefix("torch.")
            self.flops[precision] += self.registry[packet](*args, **kwargs,
                                                           out_val=out)
        if not func.is_view and packet not in _NO_TRAFFIC:
            self.bytes += sum(_distinct_bytes(t) for t in ins + outs)
        return out


@dataclasses.dataclass
class StepCount:
    """What one step costs, counted over one eager trace of it.

    ``flops_by_dtype``: the formulas of ``torch.utils.flop_counter`` (the
    matrix products, attention and convolutions; K5's products by
    :func:`~repro_torch.kernels.ssd_chunk.ssd_chunk_cost`), each booked by
    the promoted dtype of its operands.  ``hbm_bytes``: for every op that
    is not a view, the bytes of its inputs plus its outputs; the eager
    op-level count, an upper bound on what a fused program moves (its
    intermediates stay on chip) and what the card moves when one op reads
    another's output out of its 50 MB L2 cache.  ``peak_bytes``:
    ``MemTracker``'s peak, with the arguments (parameters, optimizer state,
    batch, caches) tracked from before the trace.  ``devices``: the device
    types of every tensor with elements that the trace touched (an empty
    tensor holds no data: torch 2.11's activation checkpointing makes one
    on the CPU as a placeholder; integer tensors on the CPU are not
    counted either: over a mesh DTensor's sharding propagation builds its
    meshes of ranks from such tensors).  Over a mesh every count is one rank's:
    its local ops and blocks, and ``collectives``, the collectives it
    issued with their ring time."""
    flops_by_dtype: Dict[str, int]
    hbm_bytes: int
    peak_bytes: int
    argument_bytes: int
    output_bytes: int
    devices: frozenset
    seconds: float
    collectives: CollectiveStats = dataclasses.field(
        default_factory=lambda: CollectiveStats(
            {c: 0 for c in _COLLECTIVES}, {c: 0 for c in _COLLECTIVES}, 0.0))

    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())


def count_step(step, *args):
    """Run ``step(*args)`` once under the counters; returns (its output, a
    :class:`StepCount`).  Runs on whatever device ``args`` lie on: the dry
    run gives it meta tensors, the tests also CPU tensors."""
    from torch.distributed._tools.mem_tracker import MemTracker

    t0 = time.perf_counter()
    tracker, counter = MemTracker(), _OpCounter()
    tracker.track_external(*[_local(t) for t in tree_leaves(args)
                             if isinstance(t, torch.Tensor)])
    with tracker, counter:
        out = step(*args)
    peak = sum(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
    count = StepCount(
        flops_by_dtype=dict(counter.flops),
        hbm_bytes=counter.bytes,
        peak_bytes=peak,
        argument_bytes=storage_bytes(args),
        output_bytes=storage_bytes(out),
        devices=frozenset(counter.devices),
        seconds=time.perf_counter() - t0,
        collectives=CollectiveStats(
            {c: counter.coll_bytes[c] for c in _COLLECTIVES},
            {c: counter.coll_counts[c] for c in _COLLECTIVES},
            counter.coll_time),
    )
    return out, count


def analyze(count: StepCount, *, chips: int = 1) -> RooflineTerms:
    """The three terms of a counted step a device (the collective term is
    0 where the step ran on one card)."""
    coll = count.collectives
    return RooflineTerms(flops=float(count.flops), hbm_bytes=float(count.hbm_bytes),
                         collectives=coll, chips=chips,
                         flops_by_dtype={k: float(v)
                                         for k, v in count.flops_by_dtype.items()})
