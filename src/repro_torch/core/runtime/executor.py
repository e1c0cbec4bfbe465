"""Fused whole-network executor — one loop over timesteps for the graph.

On SpiNNaker2 every population advances together each timestep: the chip
runs a lockstep per-timestep pipeline across all PEs (arXiv 1911.02385),
whatever paradigm each projection's PEs execute.  This module mirrors that
structure on the CUDA card:

* :func:`get_layer_executable` lowers a :class:`CompiledLayer`'s program
  once per device and caches the result on the compiled projection, so
  repeated runs never re-lower.  The report classes are the port's own
  (:mod:`repro_torch.core.switching`), so a port executable never lands
  on a reference report, nor the other way round.
* :class:`NetworkExecutable` executes the **application graph** of
  :class:`~repro_torch.core.layer.SNNNetwork` — populations as vertices,
  projections as edges — in **one Python loop over timesteps**
  (:func:`_scan_network`; the reference's ``jax.lax.scan``).  Within a
  timestep, forward projections cascade in the graph's topological
  order; **back-edges** (self-loops and projections onto earlier
  populations) read their source population's spikes of the previous
  timestep (one-step-delayed feedback: the previous row of its output
  train), so a spike crossing a back-edge of synaptic delay ``d`` arrives
  ``d + 1`` steps after emission.

Each projection runs its paradigm's projection half: a parallel edge its
whole current
(:func:`~repro_torch.core.runtime.parallel_runtime.parallel_project`), a
serial edge the update half of its form
(:func:`~repro_torch.core.runtime.serial_runtime.serial_update` and its
sparse/dense twins).  Then ONE population step
(:func:`repro_torch.kernels.lif_update.lif_step`, a single launch on the
card) delivers the serial edges' updates through their delay rings, sums
all in-edge currents, fires, and writes the carry and the step's row of
the output train.  All weights are int8-magnitude integers, so the sums
are exact in float32 and converging projections stay bit-exact.

Layout: everything the loop carries is batch-major, ``(B, n)`` — membrane
potentials, int8 previous spikes and the parallel projections' int8
history rings — so the kernels read and write contiguous buffers with no
transposes.  The serial delay rings are ``(d_slots, B, n_target)`` f32, as
in the reference.  Spike state crossing timesteps is int8 (spikes are
exactly 0/1, so the casts are exact).

The timestep ``t`` is a host integer and nothing in the loop reads a
device value back: a launch enqueues its whole T-step run, and the
all-0/1 output self-check stays on the device (:attr:`last_check`).
So a launch of one shape is the same device work every time: once the
serving pool has warmed a shape, :meth:`NetworkExecutable.capture_graph`
records that work as one CUDA graph, and later launches of the shape copy
their inputs into the graph's own buffers and replay it, instead of
enqueuing every step from Python.  Graphs exist only on the card, and only
for an executable that is not placed over several ranks.

:meth:`NetworkExecutable.run_batched` is the serving engine's path for
full micro-batches: the reference vmaps width-1 scans over the request
axis, and here the batch axis is already written out, so it runs the same
loop as :meth:`~NetworkExecutable.run_device` and records its forms under
``("vmap", B)``.  :meth:`NetworkExecutable.shard` places the operands over
the ranks of a ``torch.distributed`` process group, by a mesh's rules or
by a placement's assignment; with one process it is the identity.

:meth:`NetworkExecutable.run_temporal` is the second launch path, the
temporal-parallel paradigm (:mod:`.temporal_runtime`): feed-forward
populations compute all T steps at once, and only the back-edge interval
of the topological order runs through :func:`_scan_network`.  Its
iterative reset resolution reads one spike-flip count back per
fixed-point pass; nothing else on that path syncs.
"""
from __future__ import annotations

import dataclasses
import gc
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ... import trace
from ...device import resolve_device
from ...distributed import exchange
from ...distributed import sharding as shardlib
from ...kernels import add_launch_counts, launch_counts
from ...kernels.lif_update import CurrentEdge, RingEdge, lif_step
from ..cost_model import DEFAULT_SERIAL_BATCH_COST, SerialBatchCostModel
from ..layer import LIFParams, SNNNetwork
from ..parallel_compiler import ParallelProgram
from ..serial_compiler import SerialProgram
from ..switching import CompiledLayer, CompileReport
from .parallel_runtime import (
    ParallelExecutable,
    init_history,
    lower_parallel,
    parallel_project,
)
from .serial_runtime import (
    SerialExecutable,
    dense_serial_weights,
    lower_serial,
    serial_update,
    serial_update_dense,
    serial_update_sparse,
    source_major_index,
    sparse_serial_operands,
)
from .temporal_runtime import (
    TemporalReport,
    choose_temporal_mode,
    temporal_lif,
    temporal_project_dense,
    temporal_project_sparse,
)


def get_layer_executable(
    compiled: CompiledLayer, lif: LIFParams | None = None, *, device=None
):
    """Lower ``compiled.program`` once per device; reuse the cached one after.

    The cache is invalidated (re-lowered) if it was built for different
    LIF parameters or another device than the ones requested now.
    """
    lif = lif or LIFParams()
    dev = resolve_device(device)
    exe = compiled.executable
    if exe is not None and exe.lif == lif and exe.device == dev:
        return exe
    prog = compiled.program
    if isinstance(prog, SerialProgram):
        exe = lower_serial(prog, lif, device=dev)
    elif isinstance(prog, ParallelProgram):
        exe = lower_parallel(prog, lif, device=dev)
    else:  # pragma: no cover
        raise TypeError(type(prog))
    compiled.executable = exe
    return exe


@dataclasses.dataclass(frozen=True)
class LayerMeta:
    """Static per-projection facts the loop reads.

    ``alpha``/``v_th`` are the *target population's* effective LIF
    parameters (for a chain: the layer's own ``lif``).
    """

    paradigm: str        # "serial" | "parallel"
    n_source: int
    n_target: int
    delay_range: int
    alpha: float
    v_th: float
    #: Event volume: synaptic rows (serial) / WDM columns (parallel); feeds
    #: the serial form decision.
    n_rows: int = 0

    @property
    def ring_depth(self) -> int:
        """Spike-history ring depth; >= 1 even for degenerate programs."""
        return max(1, self.delay_range)


@dataclasses.dataclass(frozen=True)
class GraphPlan:
    """Static application-graph structure the loop follows.

    Population indices are the network's *declared* indices; only the
    iteration order (``update_order``) is topological.  Input populations
    carry dummy LIF constants (they have no neural update — their
    "spikes" are slices of the external train: input population
    ``input_pops[k]`` reads columns ``input_slices[k]`` of the
    concatenated ``(T, B, n_input)`` train, declared order).
    """

    pop_sizes: Tuple[int, ...]
    input_pops: Tuple[int, ...]           # declared indices of input pops
    input_slices: Tuple[Tuple[int, int], ...]  # per input pop: train columns
    update_order: Tuple[int, ...]         # non-input pops, topological order
    pop_alpha: Tuple[float, ...]
    pop_vth: Tuple[float, ...]
    in_edges: Tuple[Tuple[int, ...], ...]  # per pop: in-projection indices
    proj_src: Tuple[int, ...]             # per projection: source pop
    proj_tgt: Tuple[int, ...]             # per projection: target pop
    proj_back: Tuple[bool, ...]           # per projection: back-edge?
    back_sources: Tuple[int, ...]         # pops read one step late


def _graph_plan(net: SNNNetwork) -> GraphPlan:
    """Extract the static execution plan from the application graph."""
    n = len(net.populations)
    input_pops = net.input_indices
    input_set = frozenset(input_pops)
    update_order = tuple(p for p in net.topo_order if p not in input_set)
    alpha, vth = [0.0] * n, [1.0] * n
    for p in update_order:
        lif = net.population_lif(p)
        alpha[p], vth[p] = float(lif.alpha), float(lif.v_th)
    endpoints = net.endpoints
    proj_src = tuple(net.population_index(pre) for pre, _ in endpoints)
    return GraphPlan(
        pop_sizes=tuple(p.size for p in net.populations),
        input_pops=input_pops,
        input_slices=net.input_slices,
        update_order=update_order,
        pop_alpha=tuple(alpha),
        pop_vth=tuple(vth),
        in_edges=tuple(net.in_edges),
        proj_src=proj_src,
        proj_tgt=tuple(
            net.population_index(post) for _, post in endpoints
        ),
        proj_back=tuple(
            i in net.back_edges for i in range(len(endpoints))
        ),
        back_sources=tuple(sorted({proj_src[i] for i in net.back_edges})),
    )


def _chain_plan(metas: Tuple[LayerMeta, ...]) -> GraphPlan:
    """The feed-forward chain plan (for handles built without a network)."""
    n = len(metas) + 1
    return GraphPlan(
        pop_sizes=(metas[0].n_source,) + tuple(m.n_target for m in metas),
        input_pops=(0,),
        input_slices=((0, metas[0].n_source),),
        update_order=tuple(range(1, n)),
        pop_alpha=(0.0,) + tuple(m.alpha for m in metas),
        pop_vth=(1.0,) + tuple(m.v_th for m in metas),
        in_edges=((),) + tuple((i,) for i in range(len(metas))),
        proj_src=tuple(range(len(metas))),
        proj_tgt=tuple(range(1, n)),
        proj_back=(False,) * len(metas),
        back_sources=(),
    )


def _layer_params(exe) -> Tuple[torch.Tensor, ...]:
    """The operand tensors of one lowered layer."""
    if isinstance(exe, SerialExecutable):
        return (exe.row_weight, exe.row_delay, exe.row_src, exe.row_tgt)
    return (exe.wdm_stack, exe.col_source, exe.col_delay)


def _param_axes(meta: LayerMeta, form: str) -> Tuple[Tuple, ...]:
    """Logical-axis names per operand tensor (for ``snn_rules`` placement)."""
    if meta.paradigm == "serial":
        if form == "dense":
            return ((None, None, "neurons"),)      # (d_slots, S, T)
        if form == "sparse":
            # ELL rows are (delay_slot, target) pairs — the target-neuron
            # axis in disguise
            return (("neurons", None), ("neurons", None))  # ell_val, ell_idx
        return (("rows",),) * 4                    # weight/delay/src/tgt
    # parallel: wdm_stack (n_target, C), col_source (C,), col_delay (C,)
    return (("neurons", "cols"), ("cols",), ("cols",))


class _Halo:
    """One launch's view of a placement over several ranks.

    ``owner[p]`` is the rank that updates population ``p`` (its tile's
    device; every projection into a tile runs there) and ``dsts[p]`` the
    other ranks that read its spikes, once a ``(pre, dst_device)`` pair of
    the plan's halo.  A rank computes only with what it owns or received:
    a population it neither updates nor receives reads as ``None``.
    """

    def __init__(self, owner, dsts, rank: int, device):
        self.owner, self.dsts, self.rank, self.device = owner, dsts, rank, device
        self.have = {p for p, o in enumerate(owner) if o == rank}
        #: populations whose whole trains were already exchanged
        self.whole = set()

    def owns(self, p: int) -> bool:
        return self.owner[p] == self.rank

    def exchange(self, p: int, x, shape, out=None):
        """``p``'s spikes ``x`` (a step's row or a whole train) from its
        owner to the ranks that read them; what this rank then holds."""
        dsts = self.dsts.get(p, ())
        if self.owns(p):
            for d in dsts:
                exchange.send(x, d)
            return x
        if self.rank not in dsts:
            return None
        buf = out if out is not None else torch.empty(
            shape, dtype=torch.float32, device=self.device)
        exchange.recv(buf, self.owner[p])
        self.have.add(p)
        return buf

    def input_row(self, p: int, row):
        """An input population's row: exchanged each step, unless its
        whole train was."""
        if p in self.whole:
            return row if p in self.have else None
        return self.exchange(p, row, row.shape)


def _init_graph_carry(
    plan: GraphPlan, metas: Tuple[LayerMeta, ...], batch: int, device
):
    """Fresh zero loop state: per-projection rings and per-population LIF
    state.  The loop updates these buffers in place, so every launch
    builds its own."""
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    proj = [
        zeros((m.delay_range + 1, batch, m.n_target), torch.float32)
        if m.paradigm == "serial"
        else init_history(batch, m.ring_depth, m.n_source, device=device)
        for m in metas
    ]
    pop_v = [
        zeros((batch, plan.pop_sizes[p]), torch.float32)
        for p in plan.update_order
    ]
    # spike state crossing timesteps is int8 (spikes are exactly 0/1, the
    # f32<->int8 casts are exact) — same element type as the parallel
    # spike-history rings
    pop_z = [
        zeros((batch, plan.pop_sizes[p]), torch.int8)
        for p in plan.update_order
    ]
    return proj, pop_v, pop_z


_SERIAL_UPDATES = {
    "event": serial_update,
    "sparse": serial_update_sparse,
    "dense": serial_update_dense,
}


def _host_bytes(src, dst: torch.Tensor) -> int:
    """Bytes of ``dst`` taken from the host: all of them, unless ``src``
    was already a tensor on ``dst``'s device."""
    if isinstance(src, torch.Tensor) and src.device == dst.device:
        return 0
    return dst.element_size() * dst.numel()


def _live_mask(spikes: torch.Tensor, valid_steps: torch.Tensor | None):
    """(T, B, 1) 0/1 mask of the live steps of each batch slot, or None."""
    if valid_steps is None:
        return None
    steps = torch.arange(spikes.shape[0], device=spikes.device)
    return (steps[:, None] < valid_steps[None, :]).to(spikes.dtype)[:, :, None]


def _event_rows(metas, forms) -> int:
    """Synaptic rows the event form sweeps a step (a lane): those of every
    projection the launch runs in the event form."""
    return sum(m.n_rows for m, f in zip(metas, forms) if f == "event")


def _count_event_steps(forms, params, steps: int) -> None:
    """Count the launch's event-form projection-steps by how they run:
    ``event_driven`` where the operands carry the rows' index by source
    (the kernel walks the fired sources' rows), ``event_swept`` where they
    do not (the CPU sweeps every row).  Projections another rank runs
    have no operands here and are not counted."""
    event = [p for f, p in zip(forms, params) if f == "event" and p is not None]
    driven = sum(p[4] is not None for p in event)
    trace.count("event_driven", steps * driven)
    trace.count("event_swept", steps * (len(event) - driven))


def _scan_network(
    plan: GraphPlan,
    metas: Tuple[LayerMeta, ...],
    forms: Tuple[str, ...],       # per proj: "event" | "sparse" | "dense" | "-"
    params: List[Tuple[torch.Tensor, ...]],
    states,                       # _init_graph_carry output (updated in place)
    spikes: torch.Tensor,         # (T, B, n_input) f32
    valid_steps: torch.Tensor | None = None,   # (B,) true length per request
    complete=None,                # per proj: a slab's completion, or None
    halo: _Halo | None = None,    # a placement over several ranks
):
    """Run the graph over all T steps; returns per-population trains.

    Step-count mask: batch slot b is live while t < valid_steps[b].  The
    mask is applied entirely OUTSIDE the loop (one multiply on the input
    train and one per population's stacked output), so masking costs
    nothing per timestep.  Padded timesteps are inert per request: the
    input mask stops them injecting external spikes, the output mask
    forces their emitted spikes to exact zeros, and because the loop is
    causal and batch slots are independent, the first valid_steps[b]
    outputs are bit-identical to running that request alone.

    Over a mesh, ``complete[ei]`` turns the projection's result from this
    rank's operand slab into the whole one (:mod:`...distributed.exchange`);
    under a placement, ``halo`` says which populations this rank updates,
    and each row goes to its readers right after it fires.
    """
    T, batch = spikes.shape[0], spikes.shape[1]
    complete = complete or [None] * len(metas)
    live = _live_mask(spikes, valid_steps)
    if live is not None:
        spikes = spikes * live

    proj_states, pop_v, pop_z = states
    vz_slot = {p: k for k, p in enumerate(plan.update_order)}
    outs = [
        torch.empty(
            (T, batch, plan.pop_sizes[p]), dtype=torch.float32,
            device=spikes.device,
        )
        for p in plan.update_order
    ]
    full_input = tuple(plan.input_slices) == ((0, spikes.shape[2]),)
    # back-edges read their source's spikes of the step before: the
    # previous step's pop_out, whose rows stay as they are (an output row
    # is written once, and the input train is read-only); at t = 0 the
    # spikes before the train, zeros
    prev_out = [None] * len(plan.pop_sizes)
    for s in plan.back_sources:
        prev_out[s] = torch.zeros(
            (batch, plan.pop_sizes[s]), dtype=torch.float32,
            device=spikes.device,
        )
    with trace.span("executor.scan", steps=T) as scan:
        if scan:
            scan.set(graph="capture" if spikes.is_cuda
                     and torch.cuda.is_current_stream_capturing() else "eager",
                     event_rows=_event_rows(metas, forms))
            _count_event_steps(forms, params, T)
        launched = sum(launch_counts().values()) if scan else 0
        for t in range(T):
            x_t = spikes[t]
            pop_out = [None] * len(plan.pop_sizes)
            for p, (a, b) in zip(plan.input_pops, plan.input_slices):
                row = x_t if full_input else x_t[:, a:b]
                pop_out[p] = row if halo is None else halo.input_row(p, row)
            for p in plan.update_order:
                k = vz_slot[p]
                if halo is None or halo.owns(p):
                    edges = []
                    for ei in plan.in_edges[p]:
                        meta = metas[ei]
                        src = plan.proj_src[ei]
                        x = prev_out[src] if plan.proj_back[ei] else pop_out[src]
                        if meta.paradigm == "serial":
                            upd, shift = _SERIAL_UPDATES[forms[ei]](
                                *params[ei], x, t, delay_range=meta.delay_range,
                                n_target=meta.n_target, complete=complete[ei],
                            )
                            edges.append(RingEdge(proj_states[ei], upd, shift))
                        else:
                            _, i_e = parallel_project(
                                *params[ei], proj_states[ei], x, t,
                                complete=complete[ei],
                            )
                            edges.append(CurrentEdge(i_e))
                    # delivery, sum, fire, int8 carry and f32 spike row: one
                    # launch
                    pop_out[p] = lif_step(
                        edges, pop_v[k], pop_z[k], outs[k][t], t,
                        alpha=plan.pop_alpha[p], v_th=plan.pop_vth[p],
                    )
                if halo is not None:
                    pop_out[p] = halo.exchange(p, pop_out[p], None, outs[k][t])
            prev_out = pop_out
        if scan:
            trace.count("kernel_launches",
                        sum(launch_counts().values()) - launched)
    if live is not None:
        outs = [z * live for z in outs]
    return outs


@dataclasses.dataclass(frozen=True)
class TemporalPlan:
    """The graph plan's temporal-parallel decomposition.

    ``update_order`` splits into three contiguous topological intervals:
    ``pre`` and ``post`` populations have no back-edge coupling and run
    whole-train (all T steps at once); the ``block`` interval — from the
    earliest back-edge target to the latest back-edge source — keeps its
    step-serial rings and runs through the ordinary loop on ``sub_plan``,
    reading the already-computed ``ext_sources`` trains as its external
    input.  A pure feed-forward graph has an empty block and runs
    entirely whole-train.
    """

    pre: Tuple[int, ...]
    block: Tuple[int, ...]
    post: Tuple[int, ...]
    ext_sources: Tuple[int, ...]      # pops whose trains feed the block
    sub_plan: GraphPlan | None        # step-serial plan of the block
    modes: dict                       # temporal pop -> reset-resolution mode


def _temporal_split(plan: GraphPlan):
    """Split ``update_order`` into (pre, block, post) around back-edges."""
    order = plan.update_order
    backs = [i for i, b in enumerate(plan.proj_back) if b]
    if not backs:
        return order, (), ()
    pos = {p: k for k, p in enumerate(order)}
    lo = min(pos[plan.proj_tgt[i]] for i in backs)
    # a back-edge source outside update_order (an input population) never
    # extends the block: its train is external, not produced by the loop
    hi = max(pos.get(plan.proj_src[i], -1) for i in backs)
    hi = max(hi, lo)
    return order[:lo], order[lo : hi + 1], order[hi + 1 :]


def _temporal_subplan(plan: GraphPlan, block: Tuple[int, ...]):
    """The block's step-serial plan: same populations/projections, but the
    update order is the block interval and every out-of-block source pop
    (original inputs and whole-train pre populations alike) becomes an
    input population reading a column range of the augmented train."""
    bset = frozenset(block)
    ext = sorted(
        {
            plan.proj_src[ei]
            for p in block
            for ei in plan.in_edges[p]
            if plan.proj_src[ei] not in bset
        }
    )
    slices, off = [], 0
    for s in ext:
        w = plan.pop_sizes[s]
        slices.append((off, off + w))
        off += w
    sub = dataclasses.replace(
        plan,
        input_pops=tuple(ext),
        input_slices=tuple(slices),
        update_order=tuple(block),
    )
    return tuple(ext), sub


def _temporal_network(
    plan: GraphPlan,
    metas: Tuple[LayerMeta, ...],
    forms: Tuple[str, ...],      # per proj: serial forms + "temporal[_sparse]"
    tplan: TemporalPlan,
    max_iters: int,
    params: List[Tuple[torch.Tensor, ...]],
    states,                      # block carry (updated in place); () if none
    spikes: torch.Tensor,        # (T, B, n_input) f32
    valid_steps: torch.Tensor | None = None,
    complete=None,               # per proj: a slab's completion, or None
    halo: _Halo | None = None,   # a placement over several ranks
):
    """Whole-train executor: no loop over time for feed-forward segments.

    Masking follows the fused path's contract exactly — the input train
    is masked once up front, intermediate trains run unmasked (padded
    steps of a causal network can only influence padded outputs), and
    the per-population outputs are masked once at the end — so the live
    prefix is bit-identical to a solo run and padded steps emit exact
    zeros.  Returns the per-population trains (``update_order``) and
    ``{pop: (iterations, residual)}`` for the whole-train populations this
    rank updated.  ``complete`` and ``halo`` are :func:`_scan_network`'s;
    under a placement each whole train goes to its readers once, and the
    step-serial block exchanges its rows step by step.
    """
    live = _live_mask(spikes, valid_steps)
    if live is not None:
        spikes = spikes * live
    complete = complete or [None] * len(metas)
    steps, batch = spikes.shape[0], spikes.shape[1]

    pop_out = [None] * len(plan.pop_sizes)
    for p, (a, b) in zip(plan.input_pops, plan.input_slices):
        x = spikes if (a, b) == (0, spikes.shape[2]) else spikes[:, :, a:b]
        pop_out[p] = x if halo is None else halo.exchange(p, x, x.shape)
    if halo is not None:
        halo.whole.update(plan.input_pops)
    aux = {}

    def whole_train(p):
        if halo is None or halo.owns(p):
            i_full = None                                # (T, B, n) current
            for ei in plan.in_edges[p]:
                meta = metas[ei]
                x = pop_out[plan.proj_src[ei]]
                if forms[ei] == "temporal_sparse":
                    i_e = temporal_project_sparse(
                        *params[ei], x, delay_range=meta.delay_range,
                        n_target=meta.n_target, complete=complete[ei],
                    )
                else:
                    i_e = temporal_project_dense(
                        params[ei][0], x, complete=complete[ei])
                i_full = i_e if i_full is None else i_full + i_e
            z, iters, residual = temporal_lif(
                i_full, alpha=plan.pop_alpha[p], v_th=plan.pop_vth[p],
                mode=tplan.modes[p], max_iters=max_iters,
            )
            pop_out[p] = z
            aux[p] = (iters, residual)
        if halo is not None:
            pop_out[p] = halo.exchange(
                p, pop_out[p], (steps, batch, plan.pop_sizes[p]))
            halo.whole.add(p)

    for p in tplan.pre:
        whole_train(p)
    if tplan.block:
        aug = [
            pop_out[s] if pop_out[s] is not None else torch.zeros(
                (steps, batch, plan.pop_sizes[s]), device=spikes.device)
            for s in tplan.ext_sources
        ]
        aug = aug[0] if len(aug) == 1 else torch.cat(aug, dim=2)
        block_outs = _scan_network(
            tplan.sub_plan, metas, forms, params, states, aug, None,
            complete, halo,
        )
        for p, z in zip(tplan.block, block_outs):
            pop_out[p] = z if halo is None or p in halo.have else None
        if halo is not None:
            halo.whole.update(tplan.block)
    for p in tplan.post:
        whole_train(p)

    outs = [pop_out[p] for p in plan.update_order]
    if live is not None:
        outs = [None if z is None else z * live for z in outs]
    return outs, aux


def _all_binary(outs, device) -> torch.Tensor:
    """Device bool: every spike entry of ``outs`` is exactly 0.0 or 1.0
    (subsumes finiteness: NaN and Inf equal neither); never read back."""
    ok = torch.ones((), dtype=torch.bool, device=device)
    for z in outs:
        ok = ok & ((z == 0.0) | (z == 1.0)).all()
    return ok


@dataclasses.dataclass
class _LaunchGraph:
    """One launch shape captured as a CUDA graph: the buffers it reads, the
    per-population trains and the flag it writes, and the kernel launches
    of one replay (entry point -> launches)."""

    graph: object                       # torch.cuda.CUDAGraph
    spikes: torch.Tensor                # (T, B, n_input) f32
    valid_steps: torch.Tensor | None    # (B,) i32
    outs: Tuple[torch.Tensor, ...]
    ok: torch.Tensor
    launches: Dict[str, int]


@dataclasses.dataclass
class _MeshPlacement:
    """``shard(mesh=)``'s mesh, rules and this rank's coordinate."""

    mesh: object
    rules: dict
    coord: dict

    def spec(self, axes, shape):
        return shardlib.spec_for_shape(axes, self.rules, shape, self.mesh)

    def group(self, part):
        """The process group of a spec entry that splits over more than
        one rank; None for an entry that splits nothing."""
        if part is None:
            return None
        if not isinstance(part, str):
            if len(part) != 1:
                raise ValueError(
                    f"an operand split over several mesh axes {part}")
            part = part[0]
        group = self.mesh.get_group(part)
        return group if exchange.group_size(group) > 1 else None


class NetworkExecutable:
    """A whole compiled application graph, lowered once, run in one loop."""

    def __init__(
        self,
        metas: Tuple[LayerMeta, ...],
        params: List[Tuple[torch.Tensor, ...]],
        name: str = "snn",
        *,
        plan: GraphPlan | None = None,
        report: CompileReport | None = None,
        cost_model: SerialBatchCostModel | None = None,
        device=None,
    ):
        self.metas = tuple(metas)
        self.params = list(params)
        self.name = name
        self.device = resolve_device(device)
        #: The application-graph execution plan; a plain chain when the
        #: handle was constructed from bare metas.
        self.plan = plan or (_chain_plan(self.metas) if self.metas else None)
        #: Serving-layer routing tag: the registered model name this
        #: handle serves (set by ``network_executable(..., model=...)``).
        self.model: str | None = None
        #: The report this executable was built from; launches record
        #: their serial kernel-form decisions into ``report.serial_forms``.
        self.report = report
        #: Crossover model deciding the serial form per batch.
        self.cost_model = cost_model or DEFAULT_SERIAL_BATCH_COST
        self._dense = {}     # layer index -> (d_slots, S, T) dense operand
        self._sparse = {}    # layer index -> (ell_val, ell_idx) ELL operands
        self._event = {}     # layer index -> row_ptr, the rows' source index
        self._temporal = {}  # layer index -> parallel WDM as (d_slots, S, T)
        self._nonneg = {}    # layer index -> all weights >= 0
        self._tplan = None   # cached TemporalPlan
        #: The whole operands, which the form operands are built from: the
        #: same tensors as ``params`` until ``shard(mesh=)`` keeps a host
        #: copy here and this rank's blocks in ``params``.
        self._whole = self.params
        #: Declared population names (tile names once a network is tiled),
        #: which a placement's assignment is keyed by.
        self.pop_names: Tuple[str, ...] | None = None
        #: ``shard(mesh=)``'s placement (None: every operand whole here)
        #: and the spec each placed operand got, ``(layer, kind) ->
        #: specs``; ``shard(assignment=)``'s per-population owners and
        #: readers over several ranks
        self._mesh_pl = None
        self._specs: Dict[Tuple[int, str], Tuple] = {}
        self._assigned = None
        #: The launch entries run so far, keyed like the reference's jit
        #: cache: ``(path, forms, max_iters)`` (see :meth:`jit_entries`).
        self._entries = set()
        #: Device bool tensor from the last launch: True iff every output
        #: entry was exactly 0.0 or 1.0 (NaN/Inf equal neither).  Computed
        #: on the device after the loop and never read back by the launch,
        #: so checking it costs the caller one sync when it wants to know.
        self.last_check = None
        #: Launches captured as CUDA graphs, keyed ``(forms, T, B,
        #: masked)``; the keys run eagerly where a capture may follow,
        #: which are the ones :meth:`capture_graph` captures; launches
        #: that replayed a graph
        self._graphs: Dict[Tuple, _LaunchGraph] = {}
        self._eager_keys = set()
        self.graph_replays = 0

    def jit_entries(self) -> int:
        """Distinct launch entries this handle has run.

        The port compiles nothing per entry; the count equals the
        reference's number of jitted scans on the same traffic (one per
        launch path, form tuple and fixed-point cap), which is what the
        serving pool's counters report.
        """
        return len(self._entries)

    @classmethod
    def build(
        cls, net: SNNNetwork, report: CompileReport, *, device=None
    ) -> "NetworkExecutable":
        if len(report.layers) != len(net.layers):
            raise ValueError("report does not match network")
        dev = resolve_device(device)
        plan = _graph_plan(net)
        metas, params = [], []
        for i, (layer, compiled) in enumerate(
            zip(net.layers, report.layers)
        ):
            exe = get_layer_executable(compiled, layer.lif, device=dev)
            tgt = plan.proj_tgt[i]
            metas.append(
                LayerMeta(
                    paradigm=compiled.paradigm,
                    n_source=exe.n_source,
                    n_target=exe.n_target,
                    delay_range=exe.delay_range,
                    alpha=plan.pop_alpha[tgt],
                    v_th=plan.pop_vth[tgt],
                    n_rows=int(
                        exe.row_weight.shape[0]
                        if isinstance(exe, SerialExecutable)
                        else exe.col_source.shape[0]
                    ),
                )
            )
            params.append(_layer_params(exe))
        exe = cls(
            tuple(metas), params, name=getattr(net, "name", "snn"),
            plan=plan, report=report, device=dev,
        )
        exe.pop_names = tuple(p.name for p in net.populations)
        return exe

    @property
    def n_input(self) -> int:
        """Width of the external spike train (summed input pop sizes)."""
        return sum(b - a for a, b in self.plan.input_slices)

    # -- serial kernel-form selection ----------------------------------------
    def serial_forms(
        self, batch: int, serial_form: str = "auto"
    ) -> Tuple[str, ...]:
        """Per-projection kernel form at this batch: "event" | "sparse" |
        "dense" ("-" = parallel).

        ``serial_form`` forces every serial projection onto one form;
        "auto" asks the cost model's three-way argmin per projection
        (:meth:`~repro_torch.core.cost_model.SerialBatchCostModel.choose_form`).
        Forcing "dense" on a projection over the cost model's element cap
        raises; every form is bit-identical on outputs, so the choice only
        moves throughput.
        """
        if serial_form not in ("auto", "event", "sparse", "dense"):
            raise ValueError(f"unknown serial_form {serial_form!r}")
        forms = []
        for meta in self.metas:
            if meta.paradigm != "serial":
                forms.append("-")
            elif serial_form != "auto":
                if serial_form == "dense" and not self.cost_model.dense_fits(
                    meta.n_source, meta.n_target, meta.delay_range
                ):
                    raise ValueError(
                        f"serial_form='dense' forced on a projection whose "
                        f"({meta.delay_range + 1}, {meta.n_source}, "
                        f"{meta.n_target}) dense operand exceeds the "
                        f"{self.cost_model.dense_element_cap}-element cap — "
                        f"use serial_form='sparse' (or 'auto')"
                    )
                forms.append(serial_form)
            else:
                forms.append(
                    self.cost_model.choose_form(
                        meta.n_rows, meta.n_source, meta.n_target,
                        meta.delay_range, batch,
                    )
                )
        return tuple(forms)

    def _serial_exe(self, i: int) -> SerialExecutable:
        meta, p = self.metas[i], self._whole[i]
        return SerialExecutable(
            n_source=meta.n_source, n_target=meta.n_target,
            delay_range=meta.delay_range,
            row_weight=p[0], row_delay=p[1], row_src=p[2], row_tgt=p[3],
            lif=LIFParams(alpha=meta.alpha, v_th=meta.v_th),
        )

    def _dense_param(self, i: int) -> Tuple[torch.Tensor, ...]:
        """The layer's dense-form operand, built once and cached."""
        w = self._dense.get(i)
        if w is None:
            (w,) = self._place(i, "dense", torch.as_tensor(
                dense_serial_weights(self._serial_exe(i))))
            self._dense[i] = w
        return (w,)

    def _event_param(self, i: int) -> Tuple[torch.Tensor, ...]:
        """The layer's event-form operands and their index by source, built
        once and cached (this rank's rows reordered source-major in place).
        The index exists wherever the rows are on the card, whole or a
        rank's slab (whose partial update the launch completes as the
        sweep's); on the CPU it is None and the rows are swept."""
        p = self.params[i]
        if p[0].device.type != "cuda":
            return (*p, None)
        row_ptr = self._event.get(i)
        if row_ptr is None:
            row_ptr = source_major_index(*p, n_source=self.metas[i].n_source)
            self._event[i] = row_ptr
        return (*p, row_ptr)

    def _sparse_param(self, i: int) -> Tuple[torch.Tensor, ...]:
        """The layer's ELL (sparse-form) operands, built once and cached."""
        ell = self._sparse.get(i)
        if ell is None:
            val, idx = sparse_serial_operands(self._serial_exe(i))
            ell = self._place(
                i, "sparse", torch.as_tensor(val), torch.as_tensor(idx))
            self._sparse[i] = ell
        return ell

    # -- temporal-parallel structure and forms -------------------------------
    def _weights_nonneg(self, i: int) -> bool:
        v = self._nonneg.get(i)
        if v is None:
            w = self._whole[i][0].cpu().numpy()   # row_weight | wdm_stack
            v = bool(w.size == 0 or w.min() >= 0)
            self._nonneg[i] = v
        return v

    def _temporal_structure(self) -> TemporalPlan:
        """The (cached) temporal decomposition of this graph plan."""
        tp = self._tplan
        if tp is None:
            pre, block, post = _temporal_split(self.plan)
            if block:
                ext, sub = _temporal_subplan(self.plan, block)
            else:
                ext, sub = (), None
            modes = {}
            for p in pre + post:
                nonneg = all(
                    self._weights_nonneg(ei)
                    for ei in self.plan.in_edges[p]
                )
                modes[p] = choose_temporal_mode(
                    self.plan.pop_alpha[p], self.plan.pop_vth[p],
                    nonneg_weights=nonneg,
                )
            tp = TemporalPlan(
                pre=pre, block=block, post=post, ext_sources=ext,
                sub_plan=sub, modes=modes,
            )
            self._tplan = tp
        return tp

    def temporal_forms(
        self, batch: int, steps: int, serial_form: str = "auto"
    ) -> Tuple[str, ...]:
        """Per-projection form for the temporal launch path.

        Projections targeting the step-serial block keep their ordinary
        serial form (same three-way choice as :meth:`serial_forms`);
        projections targeting whole-train populations run ``"temporal"``
        (one dense whole-train contraction) or ``"temporal_sparse"``
        (one ELL gather over all T·B spike columns), picked by the cost
        model's operand comparison — or forced to the matching operand by
        ``serial_form``.  Like every form, the choice never changes
        outputs.
        """
        tp = self._temporal_structure()
        bset = frozenset(tp.block)
        base = self.serial_forms(batch, serial_form)
        forms = []
        for i, meta in enumerate(self.metas):
            if self.plan.proj_tgt[i] in bset:
                forms.append(base[i])
                continue
            if meta.paradigm == "parallel":
                if not self.cost_model.dense_fits(
                    meta.n_source, meta.n_target, meta.delay_range
                ):  # pragma: no cover - parallel compile densifies under cap
                    raise ValueError(
                        "parallel projection too large for the whole-train "
                        "dense operand; run a non-temporal path"
                    )
                forms.append("temporal")
                continue
            dense_ok = self.cost_model.dense_fits(
                meta.n_source, meta.n_target, meta.delay_range
            )
            if serial_form == "sparse" or not dense_ok:
                forms.append("temporal_sparse")
            elif serial_form == "dense":
                forms.append("temporal")
            else:
                operand = self.cost_model.temporal_operand(
                    meta.n_rows, meta.n_source, meta.n_target,
                    meta.delay_range, batch,
                )
                forms.append(
                    "temporal" if operand == "dense" else "temporal_sparse"
                )
        return tuple(forms)

    def _temporal_param(self, i: int) -> Tuple[torch.Tensor, ...]:
        """The whole-train dense operand: the serial dense (d_slots, S, T)
        weights verbatim, or the parallel WDM stack scattered back into
        the same delay-stacked layout on the host (integer accumulation —
        exact), moved to the device once and cached."""
        meta = self.metas[i]
        if meta.paradigm == "serial":
            return self._dense_param(i)
        w = self._temporal.get(i)
        if w is None:
            wdm, col_src, col_dly = (a.cpu().numpy() for a in self._whole[i])
            w_np = np.zeros(
                (meta.delay_range + 1, meta.n_source, meta.n_target),
                np.float32,
            )
            np.add.at(w_np, (col_dly, col_src), wdm.T.astype(np.float32))
            (w,) = self._place(i, "temporal", torch.as_tensor(w_np))
            self._temporal[i] = w
        return (w,)

    def _params_for(self, forms: Tuple[str, ...]) -> List[Tuple]:
        per_form = {
            "event": self._event_param,
            "dense": self._dense_param,
            "sparse": self._sparse_param,
            "temporal": self._temporal_param,
            "temporal_sparse": self._sparse_param,
        }
        # a projection another rank runs has no operands here
        return [
            per_form[form](i) if form in per_form and p is not None else p
            for i, (form, p) in enumerate(zip(forms, self.params))
        ]

    def _record_forms(
        self, path: str, batch: int, forms: Tuple[str, ...]
    ) -> None:
        if self.report is not None:
            self.report.serial_forms[(path, batch)] = forms

    # -- sharding ------------------------------------------------------------
    @property
    def mesh(self):
        """The mesh the operands are placed on; ``None``: every operand is
        whole on this rank."""
        return None if self._mesh_pl is None else self._mesh_pl.mesh

    def shard(
        self,
        mesh=None,
        rules: dict | None = None,
        *,
        assignment=None,
    ) -> "NetworkExecutable":
        """Place the lowered operands over the ranks of the process group.

        ``mesh`` (a ``("data", "model")``
        :class:`~torch.distributed.device_mesh.DeviceMesh`,
        :func:`~repro_torch.distributed.sharding.snn_mesh` by default)
        places every projection's operands by the logical-axis ``rules``
        (:func:`~repro_torch.distributed.sharding.snn_rules` by default:
        neurons and rows on ``model``), fitted to each shape as the
        reference fits them: this rank keeps exactly the block the
        reference's ``NamedSharding`` puts on its device, and the launch
        paths split the request batch over ``data``.  Each launch then
        completes a projection's result over ``model`` only where its
        operand really is split, and gathers the trains back over
        ``data``: every rank returns the whole trains.  With one process
        ``snn_mesh()`` is ``None`` and this is the **identity**.

        ``assignment`` switches to **placement-driven** placement: a
        :class:`repro_torch.placement.DeviceAssignment` (from
        ``build_device_assignment`` on a placed, tiled network).  Rank
        ``d`` keeps the operands of the projections it assigns to device
        ``d`` and updates the populations whose tiles it puts there; each
        step a fired tile's spike row goes to every other device that the
        plan's halo names, once a ``(pre, dst_device)`` pair.  Recorded in
        ``report.placement``; with one process the put is the identity.
        Returns ``self`` for chaining.
        """
        whole = self._whole
        if assignment is not None:
            if len(assignment.proj_device) != len(self.metas):
                raise ValueError(
                    f"assignment covers {len(assignment.proj_device)} "
                    f"projections; executable has {len(self.metas)}"
                )
            owner, dsts = self._assignment_plan(assignment)
            nonneg = {i: self._weights_nonneg(i) for i in range(len(whole))}
            self._reset_placement()
            placed = [
                tuple(shardlib.placement_put(t, dev) for t in p)
                for dev, p in zip(assignment.proj_device, whole)
            ]
            # a rank keeps only the projections it runs
            self.params = self._whole = [
                None if any(t is None for t in p)
                else tuple(t.to(self.device) for t in p)
                for p in placed
            ]
            self._nonneg.update(nonneg)
            if shardlib.world_size() > 1:
                self._assigned = (owner, dsts)
            if self.report is not None:
                self.report.placement = assignment
            return self
        mesh = shardlib.snn_mesh() if mesh is None else mesh
        if any(p is None for p in whole):
            raise ValueError("an assignment gave this executable's operands "
                             "to other ranks; build it anew to place it again")
        if mesh is not None and not dist.is_initialized():
            raise RuntimeError(
                "shard(mesh=) places operands over the ranks of a "
                "torch.distributed process group, and none is initialized")
        if mesh is None:
            if self._mesh_pl is not None:    # the whole operands come back
                self._reset_placement()
                self.params = self._whole = [
                    tuple(t.to(self.device) for t in p) for p in whole]
            return self
        self._reset_placement()
        rules = rules or shardlib.snn_rules()
        shared = set(rules.get("batch", ())) & {
            a for k in ("neurons", "rows") for a in rules.get(k, ())}
        if shared:
            raise ValueError(
                f"rules put the batch and the operands on the same mesh axes "
                f"{sorted(shared)}")
        self._mesh_pl = _MeshPlacement(
            mesh, rules, shardlib.mesh_coordinate(mesh))
        # the whole operands stay on the host, the rank's blocks go to the
        # card; form operands are built from the whole and placed the same
        self._whole = [tuple(t.cpu() for t in p) for p in whole]
        self.params = [
            self._place(i, "event", *p) for i, p in enumerate(self._whole)
        ]
        return self

    def _reset_placement(self) -> None:
        """Drop every operand, launch entry and graph built against a
        placement."""
        self.drop_graphs()
        self._mesh_pl = None
        self._assigned = None
        self._specs.clear()
        self._dense.clear()
        self._sparse.clear()
        self._event.clear()
        self._temporal.clear()
        self._tplan = None
        self._entries.clear()

    def _assignment_plan(self, da):
        """Per population the rank that updates it, and the ranks its
        spikes go to (the halo's ``(pre, dst_device)`` pairs, in order)."""
        if self.pop_names is None:
            raise ValueError("an assignment needs an executable built from "
                             "its (tiled) network")
        n = shardlib.world_size()
        owner = tuple(da.tile_device[name] for name in self.pop_names)
        if max(owner, default=0) >= n or max(da.proj_device, default=0) >= n:
            raise ValueError(
                f"the assignment uses devices up to "
                f"{max(owner + da.proj_device)} but the world has {n} "
                "rank(s): start one process a device")
        for j, dev in enumerate(da.proj_device):
            if owner[self.plan.proj_tgt[j]] != dev:
                raise ValueError(
                    f"projection {j} runs on device {dev}, not on its "
                    "target tile's")
        index = {name: p for p, name in enumerate(self.pop_names)}
        dsts: Dict[int, Tuple[int, ...]] = {}
        for h in da.halo:
            p = index[h.pre]
            if h.dst_device not in dsts.get(p, ()):
                dsts[p] = dsts.get(p, ()) + (h.dst_device,)
        return owner, dsts

    def halo_elements_per_step(self, batch: int) -> int:
        """Spike elements the placement's halo moves a step at ``batch``
        (0 without a placement over several ranks)."""
        if self._assigned is None:
            return 0
        _, dsts = self._assigned
        return batch * sum(self.plan.pop_sizes[p] * len(d)
                           for p, d in dsts.items())

    def _place(self, i: int, kind: str, *tensors):
        """This rank's blocks of layer ``i``'s ``kind`` operands (whole
        without a mesh), on the card; records their specs."""
        pl = self._mesh_pl
        if pl is None:
            return tuple(t.to(self.device) for t in tensors)
        # the whole-train operand of a parallel layer has the serial dense
        # form's (d_slots, S, T) layout and axes
        axes = (_param_axes(self.metas[i], kind) if kind != "temporal"
                else ((None, None, "neurons"),))
        specs = tuple(pl.spec(ax, t.shape) for ax, t in zip(axes, tensors))
        self._specs[(i, kind)] = specs
        return tuple(
            shardlib.local_shard(t, spec, pl.mesh, pl.coord).to(self.device)
            for t, spec in zip(tensors, specs)
        )

    def _completions(self, forms: Tuple[str, ...]) -> List:
        """Per projection the collective that completes its result from
        this rank's operand block, or None where the block is whole."""
        pl = self._mesh_pl
        if pl is None:
            return [None] * len(forms)
        out = []
        for i, form in enumerate(forms):
            serial = self.metas[i].paradigm == "serial"
            # (operand kind, its split dim, the result's dim to gather;
            # None: sum the partial results)
            kind, dim, res_dim = {
                "-": ("event", 0, 1),             # WDM rows -> (B, N)
                "event": ("event", 0, None),      # rows -> partial update
                "dense": ("dense", 2, 2),         # (d, S, N) -> (d, B, N)
                "sparse": ("sparse", 0, 0),       # ELL rows -> (R, B)
                "temporal_sparse": ("sparse", 0, 0),
                "temporal": ("dense" if serial else "temporal", 2, 2),
            }[form]
            part = self._specs[(i, kind)][0][dim]
            group = pl.group(part)
            if group is None:
                out.append(None)
            elif res_dim is None:
                out.append(partial(exchange.all_reduce, group=group))
            else:
                out.append(partial(exchange.all_gather_cat, group=group,
                                   dim=res_dim))
        return out

    def _batch_group(self, batch: int):
        """The group the request batch is split over, or None."""
        pl = self._mesh_pl
        if pl is None:
            return None
        return pl.group(pl.spec(("steps", "batch", None), (1, batch, 1))[1])

    def _local_batch(self, spikes, valid_steps):
        """This rank's slice of the request batch: ``(spikes, valid_steps,
        group)``, the group None where the batch is not split."""
        group = self._batch_group(spikes.shape[1])
        if group is None:
            return spikes, valid_steps, None
        n, k = exchange.group_size(group), dist.get_group_rank(
            group, dist.get_rank())
        lo, hi = k * spikes.shape[1] // n, (k + 1) * spikes.shape[1] // n
        if valid_steps is not None:
            valid_steps = valid_steps[lo:hi]
        return spikes[:, lo:hi].contiguous(), valid_steps, group

    def _halo(self) -> _Halo | None:
        if self._assigned is None:
            return None
        owner, dsts = self._assigned
        return _Halo(owner, dsts, dist.get_rank(), self.device)

    def _whole_trains(self, outs, group, halo, shape):
        """Every population's whole train on every rank: gathered along the
        batch over ``group``, or broadcast from the rank that updated it."""
        if group is not None:
            return [exchange.all_gather_cat(z, group, 1) for z in outs]
        if halo is None:
            return outs
        steps, batch = shape
        whole = []
        for p, z in zip(self.plan.update_order, outs):
            if z is None:
                z = torch.empty((steps, batch, self.plan.pop_sizes[p]),
                                dtype=torch.float32, device=self.device)
            whole.append(exchange.broadcast(z, halo.owner[p]))
        return whole

    # -- launch paths --------------------------------------------------------
    def _inputs(self, spikes, valid_steps):
        """The launch's inputs as tensors on the device; counts
        ``h2d_bytes``, the bytes of each taken from a host array."""
        with trace.span("executor.inputs") as sp:
            host = spikes
            spikes = torch.as_tensor(spikes, dtype=torch.float32, device=self.device)
            if spikes.ndim != 3 or spikes.shape[2] != self.n_input:
                raise ValueError(
                    f"spikes must be (T, B, {self.n_input}); got {tuple(spikes.shape)}"
                )
            if sp:
                trace.count("h2d_bytes", _host_bytes(host, spikes))
            if valid_steps is not None:
                host = valid_steps
                valid_steps = torch.as_tensor(
                    valid_steps, dtype=torch.int32, device=self.device
                )
                if valid_steps.shape != (spikes.shape[1],):
                    raise ValueError(
                        f"valid_steps must be ({spikes.shape[1]},); "
                        f"got {tuple(valid_steps.shape)}"
                    )
                if sp:
                    trace.count("h2d_bytes", _host_bytes(host, valid_steps))
            return spikes, valid_steps

    def run_device(
        self,
        spikes,                    # (T, B, n_input) 0/1, numpy or tensor
        *,
        valid_steps=None,          # (B,) true steps per request
        serial_form: str = "auto",
    ) -> Tuple[torch.Tensor, ...]:
        """Per-projection spike trains as device tensors — no host sync.

        Entry ``i`` is the spike train of projection ``i``'s *target
        population* (fan-in entries alias one tensor).  Callers that time
        this must ``torch.cuda.synchronize()``.  With ``valid_steps``,
        batch slot ``b`` is masked after its first ``valid_steps[b]``
        timesteps: the live prefix is bit-identical to an unmasked run
        and every padded timestep emits exact zeros.  ``serial_form``
        forces the serial kernel form ("auto" lets the cost model pick
        per projection); the form never changes outputs.
        """
        if not self.metas:
            return ()
        return self._launch("fused", spikes, valid_steps, serial_form)

    def run_batched(
        self,
        spikes,                    # (T, B, n_input) 0/1 — B = request axis
        *,
        valid_steps=None,          # (B,) true steps per request
        serial_form: str = "auto",
    ) -> Tuple[torch.Tensor, ...]:
        """The explicit batched path over the request axis.

        The reference vmaps width-1 scans, one per request; here the
        batch axis is already written out in :func:`_scan_network`, so
        this runs the same loop as :meth:`run_device` — one launch a
        population and step for the whole batch, never one per lane —
        and records its forms under ``report.serial_forms[("vmap", B)]``.
        Same layout, masking contract and bits as :meth:`run_device`:
        lanes with 0 valid steps emit exact zeros.  Serving uses this
        path for full micro-batches.
        """
        if not self.metas:
            return ()
        return self._launch("vmap", spikes, valid_steps, serial_form)

    def _launch(self, path, spikes, valid_steps, serial_form):
        if self._graphs:
            key = self._graph_key(spikes, valid_steps, serial_form)
            graph = self._graphs.get(key)
            if graph is not None:
                return self._replay(path, key[0], graph, spikes, valid_steps)
        spikes, valid_steps = self._inputs(spikes, valid_steps)
        with trace.span("executor.prepare"):
            forms = self.serial_forms(spikes.shape[1], serial_form)
            self._record_forms(path, spikes.shape[1], forms)
            self._entries.add((path, forms, None))
            shape = tuple(spikes.shape[:2])
            if self._graphable():
                self._eager_keys.add((forms, *shape, valid_steps is not None))
            spikes, valid_steps, group = self._local_batch(spikes, valid_steps)
            states = _init_graph_carry(
                self.plan, self.metas, spikes.shape[1], self.device
            )
            params = self._params_for(forms)
            halo = self._halo()
            completions = self._completions(forms)
        outs = _scan_network(
            self.plan, self.metas, forms, params, states, spikes,
            valid_steps, completions, halo,
        )
        with trace.span("executor.check"):
            return self._checked(self._whole_trains(outs, group, halo, shape))

    def _checked(self, outs) -> Tuple[torch.Tensor, ...]:
        """Set :attr:`last_check` from the per-population trains and
        return the per-projection view."""
        self.last_check = _all_binary(outs, self.device)
        return self._per_projection(outs)

    def _per_projection(self, outs) -> Tuple[torch.Tensor, ...]:
        """Entry i = projection i's target population's train; fan-in
        entries alias the same tensor."""
        slot = {p: k for k, p in enumerate(self.plan.update_order)}
        return tuple(outs[slot[tgt]] for tgt in self.plan.proj_tgt)

    # -- CUDA graphs ---------------------------------------------------------
    def _graphable(self) -> bool:
        """Whether a launch can be captured: on the card, with every
        operand whole on this rank and no rank to exchange with."""
        return (self.device.type == "cuda" and self._mesh_pl is None
                and self._assigned is None)

    def _graph_key(self, spikes, valid_steps, serial_form):
        """The graph key of a launch of these inputs; None where their
        shapes fit no graph (the eager launch then raises on them)."""
        shape = tuple(np.shape(spikes))
        if len(shape) != 3 or shape[2] != self.n_input:
            return None
        if valid_steps is not None and tuple(np.shape(valid_steps)) != shape[1:2]:
            return None
        return (self.serial_forms(shape[1], serial_form), shape[0], shape[1],
                valid_steps is not None)

    def capture_graph(self, steps: int, batch: int) -> int:
        """Capture each launch of a ``(steps, batch, n_input)`` train that
        has run eagerly and has no graph yet as one CUDA graph; returns how
        many it captured.

        The serving pool calls this for each shape it has marked warm.  A
        launch is keyed by its forms and by whether it took
        ``valid_steps``; its graph zeroes the carry, masks the input, runs
        the step loop (:func:`_scan_network`), masks the output trains and
        forms the all-0/1 flag, reading the train and the valid steps from
        buffers of its own.  From then on :meth:`run_device` and
        :meth:`run_batched` of that key copy their inputs there and replay
        it (the two paths run the same loop, so they share it).  The eager
        launch first loads the kernels and builds the form operands.
        Nothing is captured off the card or under a placement over several
        ranks.  A graph holds the operands' addresses and the LIF
        constants: a rebuilt executable starts with none, and a placement
        drops them.
        """
        keys = [k for k in self._eager_keys
                if k[1:3] == (steps, batch) and k not in self._graphs]
        for forms, _, _, masked in keys:
            self._graphs[(forms, steps, batch, masked)] = self._capture(
                forms, steps, batch, masked)
        return len(keys)

    def _capture(self, forms, steps, batch, masked) -> _LaunchGraph:
        """One launch of ``forms`` at ``(steps, batch)`` recorded as a CUDA
        graph on a side stream; the launches it holds are not counted."""
        dev = self.device
        spikes = torch.zeros((steps, batch, self.n_input), dtype=torch.float32,
                             device=dev)
        valid = (torch.zeros((batch,), dtype=torch.int32, device=dev)
                 if masked else None)
        params = self._params_for(forms)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        before = launch_counts()
        # a collection inside the capture could free a dead executable's
        # graph, whose destruction a capturing thread may not call
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    states = _init_graph_carry(self.plan, self.metas, batch, dev)
                    outs = _scan_network(self.plan, self.metas, forms, params,
                                         states, spikes, valid)
                    ok = _all_binary(outs, dev)
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
            # the wrappers counted launches that only each replay makes
            launches = {k: n - before[k] for k, n in launch_counts().items()
                        if n != before[k]}
            add_launch_counts({k: -n for k, n in launches.items()})
        torch.cuda.current_stream(dev).wait_stream(side)
        return _LaunchGraph(graph, spikes, valid, tuple(outs), ok, launches)

    def drop_graphs(self) -> None:
        """Forget every captured graph (and which shapes ran eagerly)."""
        self._graphs.clear()
        self._eager_keys.clear()

    def _replay(self, path, forms, g: _LaunchGraph, spikes, valid_steps):
        """A launch that replays ``g``: the inputs copied into its buffers
        (the same copies and bytes as an eager launch's), the launch's
        bookkeeping, and clones of what it wrote, so that a later replay
        overwrites nothing a caller holds.  Waits for the card nowhere."""
        with trace.span("executor.inputs") as sp:
            g.spikes.copy_(torch.as_tensor(spikes))
            if sp:
                trace.count("h2d_bytes", _host_bytes(spikes, g.spikes))
            if g.valid_steps is not None:
                g.valid_steps.copy_(torch.as_tensor(valid_steps))
                if sp:
                    trace.count("h2d_bytes",
                                _host_bytes(valid_steps, g.valid_steps))
        steps, batch = g.spikes.shape[:2]
        with trace.span("executor.prepare"):
            self._record_forms(path, batch, forms)
            self._entries.add((path, forms, None))
        with trace.span("executor.scan", steps=steps) as scan:
            g.graph.replay()
            if scan:
                scan.set(graph="replay", event_rows=_event_rows(self.metas, forms))
                trace.count("kernel_launches", sum(g.launches.values()))
                _count_event_steps(forms, self._params_for(forms), steps)
        add_launch_counts(g.launches)
        self.graph_replays += 1
        with trace.span("executor.check"):
            self.last_check = g.ok.clone()
            return self._per_projection([z.clone() for z in g.outs])

    def run_temporal(
        self,
        spikes,                    # (T, B, n_input) 0/1, numpy or tensor
        *,
        valid_steps=None,          # (B,) true steps per request
        serial_form: str = "auto",
        max_iters: int | None = None,
    ) -> Tuple[torch.Tensor, ...]:
        """The temporal-parallel path: whole-train, no loop over time.

        Feed-forward populations compute all T timesteps at once — the
        input train is projected in one contraction and the membrane
        recurrence resolved by the whole-train scan
        (:mod:`repro_torch.core.runtime.temporal_runtime`); only the
        back-edge interval of the topological order (empty for
        feed-forward graphs) runs the step-serial loop.  Same output
        layout, masking contract, and bits as :meth:`run_device`;
        iterative populations additionally record their fixed-point pass
        count and residual in ``report.temporal[(batch, steps)]``
        (residual is 0 unless the ``max_iters`` cap — default T+1, which
        guarantees convergence — cut the loop short).  On the card each
        iterative population's fixed point is one kernel launch whose pass
        count and residual are read back to the host once; the trains and
        :attr:`last_check` stay on the device.
        """
        if not self.metas:
            return ()
        spikes, valid_steps = self._inputs(spikes, valid_steps)
        steps, batch = int(spikes.shape[0]), int(spikes.shape[1])
        forms = self.temporal_forms(batch, steps, serial_form)
        self._record_forms("temporal", batch, forms)
        cap = int(max_iters) if max_iters else steps + 1
        self._entries.add(("temporal", forms, cap))
        tp = self._temporal_structure()
        spikes, valid_steps, group = self._local_batch(spikes, valid_steps)
        states = (
            _init_graph_carry(tp.sub_plan, self.metas, spikes.shape[1],
                              self.device)
            if tp.block else ()
        )
        params = self._params_for(forms)
        halo = self._halo()
        outs, aux = _temporal_network(
            self.plan, self.metas, forms, tp, cap, params, states, spikes,
            valid_steps, self._completions(forms), halo,
        )
        self._record_temporal(batch, steps, cap, self._whole_aux(
            aux, group, halo))
        return self._checked(
            self._whole_trains(outs, group, halo, (steps, batch)))

    def _whole_aux(self, aux, group, halo):
        """The whole batch's ``(iterations, residual)`` per whole-train
        population, as one launch over the whole batch forms them: the
        most passes of any batch slice (each slice's columns converge on
        their own) and the sum of the slices' last flips; under a
        placement, the owner's."""
        order = [p for p in self.plan.update_order
                 if p in self._temporal_structure().modes]
        if (group is None and halo is None) or not order:
            return aux
        # NCCL reduces only tensors on the card
        dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        stats = torch.tensor([list(aux.get(p, (0, 0))) for p in order],
                             dtype=torch.int64, device=dev)
        if group is not None:
            stats = torch.stack([
                exchange.all_reduce(stats[:, 0], group, dist.ReduceOp.MAX),
                exchange.all_reduce(stats[:, 1], group)], 1)
        else:   # only the owner's entry is not zero
            stats = exchange.all_reduce(stats, None)
        return {p: (int(a), int(b))
                for p, (a, b) in zip(order, stats.cpu().tolist())}

    def _record_temporal(self, batch, steps, cap, aux) -> None:
        if self.report is None:
            return
        tp = self._temporal_structure()
        order = [p for p in self.plan.update_order if p in tp.modes]
        self.report.temporal[(batch, steps)] = TemporalReport(
            split=(len(tp.pre), len(tp.block), len(tp.post)),
            modes=dict(tp.modes),
            iterations={p: aux[p][0] for p in order},
            residual={p: aux[p][1] for p in order},
            max_iters=cap,
        )

    def run(
        self,
        spikes,
        *,
        valid_steps=None,
        serial_form: str = "auto",
        batched: bool = False,
        temporal: bool = False,
    ) -> List[np.ndarray]:
        """Returns the per-projection spike trains [(T, B, n_l) ...]."""
        if temporal:
            launch = self.run_temporal
        else:
            launch = self.run_batched if batched else self.run_device
        outs = launch(
            spikes, valid_steps=valid_steps, serial_form=serial_form
        )
        # single host sync, after the whole network finished on the device
        return [z.cpu().numpy() for z in outs]


class OutputValidationError(ValueError):
    """A launch returned spike trains that cannot be served.

    Raised by :func:`validate_spike_outputs` when a result violates the
    output contract (shape, dtype, finiteness, binariness).
    """


def validate_spike_outputs(
    outs,
    *,
    steps: int,
    batch: int,
    sizes: Optional[Tuple[int, ...]] = None,
) -> None:
    """Post-launch guard: every output train must be a servable spike train.

    Checks, per projection output: shape ``(steps, batch, n_target)``
    (``sizes`` supplies the expected widths when known), float32 dtype,
    and every entry exactly 0.0 or 1.0.  The binary check subsumes
    finiteness — NaN and Inf compare unequal to both 0 and 1 — and the
    raised message still distinguishes the two.  Accepts numpy arrays and
    tensors.  Raises :class:`OutputValidationError`; returns ``None`` on
    clean outputs.
    """
    if sizes is not None and len(outs) != len(sizes):
        raise OutputValidationError(
            f"expected {len(sizes)} projection outputs; got {len(outs)}"
        )
    for i, z in enumerate(outs):
        arr = z.detach().cpu().numpy() if isinstance(z, torch.Tensor) else np.asarray(z)
        want = (steps, batch) if sizes is None else (steps, batch, sizes[i])
        if arr.ndim != 3 or arr.shape[: len(want)] != want:
            raise OutputValidationError(
                f"projection {i}: expected (T, B, n_target) shape starting "
                f"{want}; got {arr.shape}"
            )
        if arr.dtype != np.float32:
            raise OutputValidationError(
                f"projection {i}: expected float32 spikes; got {arr.dtype}"
            )
        if not bool(np.all((arr == 0.0) | (arr == 1.0))):
            kind = (
                "non-finite" if not bool(np.all(np.isfinite(arr)))
                else "non-binary"
            )
            raise OutputValidationError(
                f"projection {i}: {kind} entries in the output spike train"
            )


def _matches_network(exe: NetworkExecutable, net: SNNNetwork) -> bool:
    """Does the cached executable still reflect the net's graph and LIF?"""
    if len(exe.metas) != len(net.layers):
        return False
    try:
        plan = _graph_plan(net)
    except (ValueError, KeyError):
        return False
    if plan != exe.plan:
        return False
    return all(
        meta.n_source == layer.n_source
        and meta.n_target == layer.n_target
        for meta, layer in zip(exe.metas, net.layers)
    )


def network_executable(
    net: SNNNetwork,
    report: CompileReport,
    model: str | None = None,
    *,
    device=None,
) -> NetworkExecutable:
    """The report's cached fused executable, (re)building when stale.

    A cached executable on another device than ``device`` counts as stale.
    ``model`` tags the handle with the serving-layer model name it is
    keyed under (multi-model pools route by this name); the tag survives
    rebuilds.
    """
    dev = resolve_device(device)
    exe = report.executable
    if exe is None or exe.device != dev or not _matches_network(exe, net):
        exe = NetworkExecutable.build(net, report, device=dev)
        report.executable = exe
    if model is not None:
        exe.model = model
    return exe


def release_network_executable(report: CompileReport) -> int:
    """Drop the report's fused executable (its CUDA graphs with it) and
    every per-layer lowering.

    Returns the number of cache slots cleared.  The next
    ``network_executable`` call on this report re-lowers from the compiled
    programs.
    """
    cleared = 0
    if report.executable is not None:
        report.executable.drop_graphs()
        report.executable = None
        cleared += 1
    for compiled in report.layers:
        if compiled.executable is not None:
            compiled.executable = None
            cleared += 1
    return cleared
