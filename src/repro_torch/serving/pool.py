"""Executable pool — warmed fused executables routed by model name.

The pool owns the mapping from a *registered model* (a ``net`` +
``report`` pair under a name) to its fused
:class:`~repro_torch.core.runtime.NetworkExecutable` and tracks which
``(model, bucket-shape, launch-path)`` triples have already been traced
and run — the fused path (``run_device``) serves partial buckets and the
request-axis path (``run_batched``) serves full buckets, and the two are
tracked separately, as the reference's two traces are.  Steady-state
traffic therefore never re-lowers a layer program: a bucket *hit* reuses
a warm entry, a *miss* warms the shape for every later request.
Hit/miss counters are kept both globally and split
per model.

On the card, each shape the pool marks warm is captured as one CUDA graph
(:meth:`~repro_torch.core.runtime.NetworkExecutable.capture_graph`):
:meth:`ExecutablePool.warmup` captures the shapes it warms, and a served
miss is captured right after its eager launch.  Every later launch of the
shape, on either path, replays the graph; ``graph_captures`` and
``graph_replays`` count both per model.

Multi-tenancy is bounded by an **LRU cap** (``max_models``): when more
models are registered than the cap allows, the least-recently-used
model's executable handles are released
(:func:`~repro_torch.core.runtime.release_network_executable`) — its compiled
programs stay registered, so a later request to that name *revives* it
cold (one re-lowering pass + fresh traces, all visible in the counters)
instead of failing.  This mirrors the paper's host-RAM economy: keep only
the artifacts current traffic needs resident.

Staleness flows through the runtime's own caches —
:func:`~repro_torch.core.runtime.network_executable` rebuilds when the network
mutates (e.g. a layer's ``LIFParams`` changes) — and the pool exposes
:meth:`relowerings` so callers can assert the steady state really is
re-lowering-free.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import trace
from ..core.layer import SNNNetwork
from ..core.runtime import (
    NetworkExecutable,
    PackedTrains,
    lowering_total,
    network_executable,
    release_network_executable,
)
from ..core.switching import CompileReport
from ..device import resolve_device
from .queue import DEFAULT_MODEL
from .scheduler import BucketKey, MicroBatch


class UnknownModel(KeyError):
    """Raised when a request routes to a model name never registered."""


def host_arrays(outs) -> List[np.ndarray]:
    """Launch outputs as NumPy arrays on the host.

    A pool launch's :class:`~repro_torch.core.runtime.PackedTrains` are
    cut from one fresh copy of their host buffer, which the next launch
    overwrites (``d2h_bytes``: the packed bytes the launch moved); fan-in
    entries share one array.  NumPy entries (a fault injector's corrupted
    copies) pass through.
    """
    with trace.span("supervisor.host_copy") as sp:
        if isinstance(outs, PackedTrains):
            if sp:
                trace.count("d2h_bytes", outs.nbytes)
            return outs.arrays()
        return [np.asarray(z) for z in outs]


def wait_for_device(exe: NetworkExecutable) -> None:
    """Return only after the card has finished everything the launch
    enqueued (a no-op on the CPU, where a launch runs to its end)."""
    with trace.span("pool.sync"):
        if exe.device.type == "cuda":
            torch.cuda.synchronize(exe.device)


@dataclasses.dataclass
class PoolEntry:
    name: str
    net: SNNNetwork
    report: CompileReport
    #: The device the model's executable runs on (resolved by the pool).
    device: torch.device = None
    #: Warmed entries, keyed ``(bucket-shape, path)`` with path
    #: "fused" (``run_device``, partial buckets) or "batched"
    #: (``run_batched``, full buckets) — the reference traces the two
    #: separately, so warmth is tracked per path.
    warm_shapes: Set[Tuple[Tuple[int, int, int], str]] = dataclasses.field(
        default_factory=set
    )
    bucket_hits: int = 0
    bucket_misses: int = 0
    batched_launches: int = 0
    fused_launches: int = 0
    #: Launch shapes captured as CUDA graphs, and launches that replayed one
    graph_captures: int = 0
    graph_replays: int = 0
    #: The NetworkExecutable instance the warm set was built against; a
    #: rebuild (network mutation or post-eviction revival) starts a fresh
    #: jit cache, so the warm set must reset with it or "hits" would hide
    #: re-trace stalls.
    _warmed_exe: object = dataclasses.field(default=None, repr=False)

    @property
    def executable(self) -> NetworkExecutable:
        exe = network_executable(
            self.net, self.report, model=self.name, device=self.device
        )
        if exe is not self._warmed_exe:
            self.warm_shapes.clear()
            self._warmed_exe = exe
        return exe

    @property
    def n_input(self) -> int:
        return self.net.n_input

    @property
    def output_sizes(self) -> Tuple[int, ...]:
        """Per-projection target-population widths — the output contract
        the supervisor's post-launch validation guard checks against."""
        return tuple(l.n_target for l in self.net.layers)


class ExecutablePool:
    """Named compiled models, each with a warmed jit entry per bucket shape.

    ``device`` is where every model runs: ``None`` means the CUDA card
    (and raises when none is visible), ``"cpu"`` the kernels' plain
    versions.  ``max_models`` caps how many models keep *live* executables at once
    (LRU on use); ``None`` means unbounded.  Registration itself is never
    evicted — only the lowered/jitted handles — so every registered name
    stays routable forever.
    """

    def __init__(
        self,
        *,
        device=None,
        max_models: Optional[int] = None,
        full_bucket_path: str = "batched",
        fault_injector=None,
    ):
        if max_models is not None and max_models < 1:
            raise ValueError("max_models must be >= 1 or None")
        if full_bucket_path not in ("batched", "fused"):
            raise ValueError(
                f"full_bucket_path must be 'batched' or 'fused'; "
                f"got {full_bucket_path!r}"
            )
        self.device = resolve_device(device)
        self.max_models = max_models
        #: Launch path for FULL micro-batches (partial buckets always take
        #: the fused path — their empty slots cost one masked lane there).
        #: "batched" (default) is ``run_batched``; "fused" pins
        #: ``run_device``.  The paths are bit-identical either way.
        self.full_bucket_path = full_bucket_path
        #: Optional :class:`~repro_torch.serving.faults.FaultInjector` consulted
        #: around every launch (``before_launch`` may raise or stall,
        #: ``after_launch`` may corrupt outputs).  ``None`` = no injection;
        #: the hooks cost nothing on the fault-free path.
        self.fault_injector = fault_injector
        #: Output self-check of the most recent blocking launch (host
        #: bool scalar, see :meth:`run_microbatch`); None before any
        #: launch, after a failed one, or after one that did not block.
        self.last_launch_check = None
        #: LRU order: least-recently-used first.
        self._entries: "OrderedDict[str, PoolEntry]" = OrderedDict()
        self.evictions = 0
        self.revivals = 0
        self._evicted_warm: Dict[str, int] = {}   # name -> warmed shapes lost
        self._lower_mark = lowering_total()

    # -- model registry ------------------------------------------------------
    def register(
        self, net: SNNNetwork, report: CompileReport, name: str = DEFAULT_MODEL
    ) -> PoolEntry:
        """Register ``name`` and eagerly lower its layers (warm the handle)."""
        entry = PoolEntry(
            name=name, net=net, report=report, device=self.device
        )
        self._entries[name] = entry
        self._entries.move_to_end(name)
        entry.executable            # lower every layer now, not on first hit
        self._enforce_cap(keep=name)
        self._lower_mark = lowering_total()
        return entry

    def entry(self, name: str = DEFAULT_MODEL) -> PoolEntry:
        """The named entry, touched as most-recently-used; revives if evicted.

        An evicted model still routes: touching it re-lowers its programs
        (counted in :meth:`relowerings` until the next warmup) and starts
        a cold jit cache, then evicts whichever model is now LRU.
        """
        try:
            entry = self._entries[name]
        except KeyError:
            raise UnknownModel(
                f"model {name!r} not registered; have {self.models()}"
            ) from None
        self._entries.move_to_end(name)
        if entry.report.executable is None:       # evicted -> revive cold
            self.revivals += 1
            entry.executable
            self._enforce_cap(keep=name)
        return entry

    def peek(self, name: str = DEFAULT_MODEL) -> PoolEntry:
        """The named entry with NO side effects — no LRU touch, no revival.

        For introspection (the supervisor reads the output contract from
        here); launches must go through :meth:`entry` / :meth:`run_microbatch`
        so use-ordering and revival accounting stay correct.
        """
        try:
            return self._entries[name]
        except KeyError:
            raise UnknownModel(
                f"model {name!r} not registered; have {self.models()}"
            ) from None

    def models(self) -> List[str]:
        return list(self._entries)

    def _enforce_cap(self, keep: str) -> None:
        if self.max_models is None:
            return
        live = [
            n for n, e in self._entries.items()
            if e.report.executable is not None
        ]
        while len(live) > self.max_models:
            victim = next(n for n in live if n != keep)
            live.remove(victim)
            self.evict(victim)

    def evict(self, name: str) -> int:
        """Release ``name``'s executable handles; keeps it registered.

        Returns the number of cache slots cleared.  The warmed-shape set
        is recorded so metrics can report how much warmup an eviction
        destroyed.
        """
        entry = self._entries[name]
        self._evicted_warm[name] = len(entry.warm_shapes)
        entry.warm_shapes.clear()
        entry._warmed_exe = None
        self.evictions += 1
        return release_network_executable(entry.report)

    # -- execution -----------------------------------------------------------
    def warmup(
        self, buckets: Iterable[BucketKey], name: str = DEFAULT_MODEL
    ) -> int:
        """Launch the given bucket shapes once with dummy traffic.

        Warms every launch path the routing policy can produce for each
        shape — the fused path always (partial buckets), the batched
        path only when ``full_bucket_path`` routes full buckets there —
        so steady-state traffic hits whichever path the scheduler's
        occupancy produces.  Warmup launches run ``serial_form="auto"``,
        so each bucket builds the exact event/sparse/dense operands the
        cost model will pick for that batch under steady-state traffic
        (the entries are keyed by the form tuple) — sparse-storage models
        build their ELL operands here, never on the serving hot path, and
        the kernels load on the card here too.  Each launch is the pool's
        own (:meth:`~repro_torch.core.runtime.NetworkExecutable.run_packed`
        on a uint8 train), so the host buffers of its copies reach the
        largest warmed bucket here.  On the card each shape is then
        captured as a CUDA graph, which later launches of it replay.
        Returns the number of shapes newly warmed.  After warmup those
        buckets are all hits and :meth:`relowerings` stays at zero.
        """
        entry = self.entry(name)
        exe = entry.executable          # refreshes the warm set if rebuilt
        paths = ["fused"]
        if self.full_bucket_path == "batched":
            paths.append("batched")
        warmed = 0
        for key in buckets:
            fresh = False
            dummy = np.zeros(key.shape, np.uint8)
            valid = np.zeros(key.batch, np.int32)
            for path in paths:
                if (key.shape, path) in entry.warm_shapes:
                    continue
                exe.run_packed(dummy, valid_steps=valid,
                               batched=path == "batched")
                wait_for_device(exe)
                entry.warm_shapes.add((key.shape, path))
                fresh = True
            warmed += fresh
            entry.graph_captures += exe.capture_graph(key.steps, key.batch)
        self._lower_mark = lowering_total()
        return warmed

    def _acquire(
        self, name: str, shape: Tuple[int, int, int], path: str
    ) -> Tuple[PoolEntry, NetworkExecutable, bool]:
        """Touch the model, revive it if evicted, count ONE hit or miss
        (the third item: True for a hit).

        This is the pool's single counting point: a cold revival inside
        :meth:`entry` re-lowers the model's programs *within this same
        acquire*, and the resulting cleared warm set must surface as
        exactly one miss for the launch that triggered it — counting in
        both the revival path and the launch path would double-book the
        same compile stall (regression-tested in
        ``tests/test_executable_cache.py``).
        """
        entry = self.entry(name)        # may revive cold (clears warm set)
        exe = entry.executable          # refreshes the warm set if rebuilt
        hit = (shape, path) in entry.warm_shapes
        if hit:
            entry.bucket_hits += 1
        else:
            entry.bucket_misses += 1
            entry.warm_shapes.add((shape, path))
        return entry, exe, hit

    def run_microbatch(
        self,
        micro_batch: MicroBatch,
        name: Optional[str] = None,
        *,
        block: bool = True,
        path: Optional[str] = None,
    ):
        """Run one padded micro-batch; returns its per-projection trains.

        Routes to ``micro_batch.model`` unless ``name`` overrides it.
        ``path`` overrides the pool's routing policy — default: **full**
        buckets (every slot live) take ``full_bucket_path`` (the vmapped
        ``run_batched`` request-axis path unless configured otherwise),
        partial buckets the fused ``run_device`` path.  Replies are
        bit-identical either way.  With ``block`` (default) the call
        returns only after the device finishes, so wall-clock around it
        measures real execution time.

        The trains are 0/1 uint8
        :class:`~repro_torch.core.runtime.PackedTrains`: views of one host
        buffer, filled by the launch's one copy from the card, which the
        model's next launch overwrites
        (:func:`host_arrays` copies them out).  After a blocking launch,
        ``last_launch_check`` holds the executable's output self-check (a
        host bool scalar, True iff every output entry was exactly 0/1,
        formed on the device from the float32 trains and carried home in
        the same copy) — what the launch supervisor consumes to validate
        fault-free results without a host-side pass; after a launch that
        did not wait for the card it stays None.  It reflects the *device*
        result: post-launch injector corruption happens on host copies
        and is caught by the host validator instead.  A hit on a captured
        shape replays its CUDA graph; a miss runs eagerly and is captured
        right after.
        """
        self.last_launch_check = None
        if path is None:
            path = (
                self.full_bucket_path
                if len(micro_batch.requests) == micro_batch.key.batch
                else "fused"
            )
        if path not in ("fused", "batched"):
            raise ValueError(f"unknown launch path {path!r}")
        with trace.span("pool.run_microbatch", path=path) as sp:
            if self.fault_injector is not None:
                # pre-launch faults (lowering failure, device loss, stall)
                # fire before the hit/miss counting point, like the real
                # failures they simulate — a launch that never reached
                # the device must not book a bucket hit
                self.fault_injector.before_launch(micro_batch, path)
            entry, exe, hit = self._acquire(
                name if name is not None else micro_batch.model,
                micro_batch.key.shape, path,
            )
            if sp:
                sp.set(hit=hit)
            if path == "batched":
                entry.batched_launches += 1
            else:
                entry.fused_launches += 1
            replays = exe.graph_replays
            outs = exe.run_packed(
                micro_batch.spikes,
                valid_steps=micro_batch.valid_steps,
                batched=path == "batched",
            )
            entry.graph_replays += exe.graph_replays - replays
            if block:
                wait_for_device(exe)
                self.last_launch_check = outs.check
            if not hit:
                key = micro_batch.key
                entry.graph_captures += exe.capture_graph(key.steps, key.batch)
            if self.fault_injector is not None:
                # post-launch corruption (NaN/Inf membrane, non-binary
                # spikes) on host copies — device/cache buffers stay clean
                # for retries
                outs = self.fault_injector.after_launch(outs, micro_batch, path)
        return outs

    # -- counters ------------------------------------------------------------
    @property
    def bucket_hits(self) -> int:
        return sum(e.bucket_hits for e in self._entries.values())

    @property
    def bucket_misses(self) -> int:
        return sum(e.bucket_misses for e in self._entries.values())

    def counters_by_model(self) -> Dict[str, Dict[str, int]]:
        """Per-model bucket hit/miss, warm-state, and eviction counters.

        ``jit_entries`` counts the distinct launch entries the model's live
        executable holds; ``evicted_warm_shapes`` is how much warmup the
        model's last eviction destroyed (what a revival has to re-pay);
        ``graph_captures`` and ``graph_replays`` count the shapes captured
        as CUDA graphs and the launches that replayed one (0 off the card).
        """
        return {
            name: {
                "bucket_hits": e.bucket_hits,
                "bucket_misses": e.bucket_misses,
                "batched_launches": e.batched_launches,
                "fused_launches": e.fused_launches,
                "warm_shapes": len({s for s, _ in e.warm_shapes}),
                "resident": e.report.executable is not None,
                "jit_entries": (
                    e.report.executable.jit_entries()
                    if e.report.executable is not None else 0
                ),
                "evicted_warm_shapes": self._evicted_warm.get(name, 0),
                "graph_captures": e.graph_captures,
                "graph_replays": e.graph_replays,
            }
            for name, e in self._entries.items()
        }

    # -- invariants ----------------------------------------------------------
    def relowerings(self) -> int:
        """Layer lowerings since the last register/warmup — steady state: 0."""
        return lowering_total() - self._lower_mark
