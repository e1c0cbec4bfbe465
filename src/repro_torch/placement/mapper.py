"""Mapper IR + placement search: tiles onto the core grid.

The search space object is a :class:`LinearMapping` — an ordered program
of mapping directives (``assign`` / ``move`` / ``swap``), the shape
timeloop-style mappers use for their search spaces.  A mapping is cheap
to copy and mutate; :meth:`LinearMapping.placement` folds the directive
list into the concrete tile -> core assignment it denotes, so every
candidate the search ever held is replayable from its IR.

Objective: estimated **NoC spike traffic across cut edges**,

    cost = sum over blocks with src/dst on different cores of
           traffic(block) * hop_distance(core_src, core_dst)

where ``traffic`` is the expected multicast packets per timestep of the
block — the source population's firing rate (measured from recorded
trains via :func:`measured_rates`, or rate-estimated) times the number of
source neurons with at least one synapse in the block.  Same-core blocks
ride local SRAM and cost nothing.

Two placers:

* :func:`round_robin_place` — the naive baseline: tiles onto cores in
  declaration order, cycling the grid, budgets respected but locality
  ignored.
* :func:`greedy_place` + :func:`refine` — constructive placement in
  topological order (each tile lands on the feasible core minimizing its
  traffic-weighted distance to already-placed neighbors), then
  deterministic local search (single-tile relocations and connected-pair
  swaps, best-improvement, until a pass finds nothing or ``max_passes``).

Feasibility everywhere is the **aggregate** core check
(:class:`~repro_torch.core.hw.PEUsage` against the grid's
:class:`~repro_torch.core.hw.PEBudget`): a core holds a tile's neurons plus
every in-block's synaptic structures jointly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.hw import PEUsage, check_core
from .grid import CoreGrid
from .tiling import TiledNetwork

DEFAULT_RATE = 0.1


class PlacementError(ValueError):
    """No feasible core assignment under the grid's budgets."""


class LinearMapping:
    """An ordered list of mapping directives (the mapper's IR).

    Directives are plain dicts — ``{"type": "assign", "tile": t, "core":
    c}``, ``{"type": "move", "tile": t, "core": c}``, ``{"type": "swap",
    "tiles": (t1, t2)}`` — applied in order by :meth:`placement`.  The
    greedy placer emits one ``assign`` per tile; the local search appends
    its accepted moves, so the final IR is a full construction log of the
    placement it denotes.
    """

    def __init__(self) -> None:
        self.ops: List[dict] = []

    def __iter__(self):
        return iter(self.ops)

    def __len__(self) -> int:
        return len(self.ops)

    def __getitem__(self, key):
        return self.ops[key]

    def __repr__(self) -> str:
        return f"LinearMapping({self.ops!r})"

    def copy(self) -> "LinearMapping":
        lm = LinearMapping()
        lm.ops = [dict(op) for op in self.ops]
        return lm

    def add_assign(self, tile: str, core: int) -> None:
        self.ops.append({"type": "assign", "tile": tile, "core": core})

    def add_move(self, tile: str, core: int) -> None:
        self.ops.append({"type": "move", "tile": tile, "core": core})

    def add_swap(self, tile_a: str, tile_b: str) -> None:
        self.ops.append({"type": "swap", "tiles": (tile_a, tile_b)})

    def placement(self) -> Dict[str, int]:
        """Fold the directive list into the tile -> core map it denotes."""
        out: Dict[str, int] = {}
        for op in self.ops:
            if op["type"] in ("assign", "move"):
                out[op["tile"]] = op["core"]
            elif op["type"] == "swap":
                a, b = op["tiles"]
                out[a], out[b] = out[b], out[a]
            else:
                raise ValueError(f"unknown mapping op {op['type']!r}")
        return out


@dataclasses.dataclass
class Placement:
    """A concrete placement: the IR, its folded assignment, and its cost."""

    mapping: LinearMapping
    assignment: Dict[str, int]
    cost: float
    core_usage: Dict[int, PEUsage]


# -- traffic model ------------------------------------------------------------

def measured_rates(net, spikes: np.ndarray, outs: Sequence) -> Dict[str, float]:
    """Per-population mean firing rate from a recorded run.

    ``spikes`` is the external train ``(T, B, n_input)``; ``outs`` the
    per-projection trains of the same run (entry i = projection i's
    target population).  Returns population name -> mean spikes per
    neuron per timestep — the measured activity the traffic model weighs
    cut edges by.  Multi-input nets slice the concatenated train per
    input population (``net.input_slices``), so each external source
    gets its own measured rate.
    """
    spikes = np.asarray(spikes)
    rates = {
        p.name: float(spikes[:, :, a:b].mean())
        for p, (a, b) in zip(net.input_populations, net.input_slices)
    }
    for (_, post), z in zip(net.endpoints, outs):
        rates.setdefault(post, float(np.asarray(z).mean()))
    return rates


def estimate_traffic(
    tiled: TiledNetwork,
    rates: Optional[Dict[str, float]] = None,
    *,
    default_rate: float = DEFAULT_RATE,
) -> np.ndarray:
    """Expected NoC packets per timestep for every tiled projection.

    A source neuron that fires sends one multicast packet per block it
    feeds, so a block's traffic is ``rate(source) * active_sources``
    where ``active_sources`` counts source neurons with at least one
    synapse in the block.  ``rates`` may be keyed by original population
    name (e.g. from :func:`measured_rates` on the untiled net) or by tile
    name; missing entries fall back to ``default_rate``.
    """
    rates = rates or {}
    net = tiled.network
    traffic = np.zeros(len(net.projections))
    for j, (e, (pre, _)) in enumerate(zip(net.projections, net.endpoints)):
        rate = rates.get(pre)
        if rate is None:
            rate = rates.get(
                tiled.tile_slices[pre].population, default_rate
            )
        traffic[j] = float(rate) * _active_sources(e)
    return traffic


def _active_sources(e) -> int:
    """Source neurons with >= 1 synapse in the block (CSR: occupied rows
    straight off the row pointer — no densification)."""
    if hasattr(e, "indptr"):
        return int((np.diff(e.indptr) > 0).sum())
    return int(e.connectivity().any(axis=1).sum())


def noc_cost(
    assignment: Dict[str, int],
    tiled: TiledNetwork,
    grid: CoreGrid,
    traffic: np.ndarray,
) -> float:
    """Traffic-weighted hop count across cut edges (same-core = free)."""
    cost = 0.0
    for j, (pre, post) in enumerate(tiled.network.endpoints):
        a, b = assignment[pre], assignment[post]
        if a != b:
            cost += float(traffic[j]) * grid.hop_distance(a, b)
    return cost


def check_activity_budgets(
    tiled: TiledNetwork,
    assignment: Dict[str, int],
    budget,
    rates: Optional[Dict[str, float]] = None,
    *,
    default_rate: float = DEFAULT_RATE,
) -> Dict[int, float]:
    """Check per-core incoming spike traffic against ``max_in_packets``.

    Books every tiled projection's expected packets per timestep
    (:func:`estimate_traffic`, ideally with measured ``rates`` from an
    :class:`~repro_torch.core.runtime.profiler.ActivityProfile`) onto the core
    its **target** tile is assigned to, then runs the aggregate
    :func:`~repro_torch.core.hw.check_core` per core with the tile's static
    usage included.  Raises :class:`~repro_torch.core.hw.BudgetExceeded` on the
    first core whose activity over-commits ``budget.max_in_packets``
    (a ``None`` budget never binds).  Returns core -> booked packets per
    timestep — the activity heat-map of the placement.
    """
    traffic = estimate_traffic(tiled, rates, default_rate=default_rate)
    net = tiled.network
    per_core: Dict[int, float] = {}
    loads: Dict[int, list] = {}
    for name in assignment:
        loads.setdefault(assignment[name], []).append(
            tiled.tile_usage(name)
        )
    for j, (pre, post) in enumerate(net.endpoints):
        core = assignment[post]
        if assignment[pre] == core:
            continue        # same-core delivery never crosses the NoC
        per_core[core] = per_core.get(core, 0.0) + float(traffic[j])
    for core, packets in per_core.items():
        check_core(
            loads.get(core, []) + [PEUsage(in_packets=packets)],
            budget, core=core,
        )
    return per_core


# -- feasibility --------------------------------------------------------------

def _fits(core_usage: Dict[int, PEUsage], core: int, tile: PEUsage, grid: CoreGrid) -> bool:
    u = core_usage.get(core, PEUsage())
    joint = PEUsage(
        neurons=u.neurons + tile.neurons,
        synapse_bytes=u.synapse_bytes + tile.synapse_bytes,
        fan_in=u.fan_in + tile.fan_in,
    )
    return joint.fits(grid.budget)


def _book(core_usage: Dict[int, PEUsage], core: int, tile: PEUsage, sign: int) -> None:
    u = core_usage.setdefault(core, PEUsage())
    u.add(
        neurons=sign * tile.neurons,
        synapse_bytes=sign * tile.synapse_bytes,
        fan_in=sign * tile.fan_in,
    )


def _neighbors(tiled: TiledNetwork, traffic: np.ndarray):
    """tile -> [(other tile, summed traffic over connecting blocks)]."""
    acc: Dict[str, Dict[str, float]] = {}
    for j, (pre, post) in enumerate(tiled.network.endpoints):
        if pre == post:
            continue
        acc.setdefault(pre, {})[post] = (
            acc.get(pre, {}).get(post, 0.0) + float(traffic[j])
        )
        acc.setdefault(post, {})[pre] = (
            acc.get(post, {}).get(pre, 0.0) + float(traffic[j])
        )
    return {
        t: sorted(d.items(), key=lambda kv: (-kv[1], kv[0]))
        for t, d in acc.items()
    }


# -- placers ------------------------------------------------------------------

def round_robin_place(
    tiled: TiledNetwork,
    grid: CoreGrid,
    traffic: Optional[np.ndarray] = None,
) -> Placement:
    """The naive baseline: cycle tiles over cores in declaration order.

    Budgets are respected (a full core is skipped) but locality is not —
    this is what the search placer is benchmarked against.
    """
    traffic = estimate_traffic(tiled) if traffic is None else traffic
    mapping = LinearMapping()
    core_usage: Dict[int, PEUsage] = {}
    nxt = 0
    for p in tiled.network.populations:
        tu = tiled.tile_usage(p.name)
        placed = False
        for off in range(grid.n_cores):
            core = (nxt + off) % grid.n_cores
            if _fits(core_usage, core, tu, grid):
                mapping.add_assign(p.name, core)
                _book(core_usage, core, tu, +1)
                nxt = (core + 1) % grid.n_cores
                placed = True
                break
        if not placed:
            raise PlacementError(
                f"tile {p.name!r} fits no core of the {grid.rows}x"
                f"{grid.cols} grid (round-robin)"
            )
    assignment = mapping.placement()
    return Placement(
        mapping=mapping,
        assignment=assignment,
        cost=noc_cost(assignment, tiled, grid, traffic),
        core_usage=core_usage,
    )


def greedy_place(
    tiled: TiledNetwork,
    grid: CoreGrid,
    traffic: Optional[np.ndarray] = None,
) -> Placement:
    """Constructive placement in topological order.

    Each tile lands on the feasible core minimizing its traffic-weighted
    hop distance to already-placed neighbors (ties to the lowest core
    index); the first tile — and any tile with no placed neighbor —
    anchors near its heaviest future neighbor's eventual region simply by
    taking the lowest free core, which the refinement pass then improves.
    """
    traffic = estimate_traffic(tiled) if traffic is None else traffic
    net = tiled.network
    nbrs = _neighbors(tiled, traffic)
    mapping = LinearMapping()
    core_usage: Dict[int, PEUsage] = {}
    placed: Dict[str, int] = {}
    for p_idx in net.topo_order:
        name = net.populations[p_idx].name
        tu = tiled.tile_usage(name)
        anchored = [
            (other, w) for other, w in nbrs.get(name, []) if other in placed
        ]
        best: Tuple[float, int] | None = None
        candidates = (
            grid.cores_by_distance(placed[anchored[0][0]])
            if anchored else list(grid.cores())
        )
        for core in candidates:
            if not _fits(core_usage, core, tu, grid):
                continue
            score = sum(
                w * grid.hop_distance(core, placed[other])
                for other, w in anchored
            )
            if best is None or (score, core) < best:
                best = (score, core)
            if not anchored:
                break               # all empty-score cores tie; lowest wins
            if score == 0.0:
                break               # co-located with every placed neighbor
        if best is None:
            raise PlacementError(
                f"tile {name!r} fits no core of the {grid.rows}x{grid.cols} "
                f"grid (greedy)"
            )
        core = best[1]
        mapping.add_assign(name, core)
        _book(core_usage, core, tu, +1)
        placed[name] = core
    assignment = mapping.placement()
    return Placement(
        mapping=mapping,
        assignment=assignment,
        cost=noc_cost(assignment, tiled, grid, traffic),
        core_usage=core_usage,
    )


def refine(
    placement: Placement,
    tiled: TiledNetwork,
    grid: CoreGrid,
    traffic: Optional[np.ndarray] = None,
    *,
    max_passes: int = 4,
) -> Placement:
    """Deterministic local search: relocations + connected-pair swaps.

    Per pass, every tile tries its best-improvement relocation to any
    feasible core, then every connected tile pair tries a swap (when both
    ends stay feasible).  Accepted moves append to the mapping IR;
    passes repeat until one finds nothing or ``max_passes``.  The result
    never costs more than the input placement.
    """
    traffic = estimate_traffic(tiled) if traffic is None else traffic
    net = tiled.network
    mapping = placement.mapping.copy()
    assignment = dict(placement.assignment)
    core_usage = {
        c: PEUsage(u.neurons, u.synapse_bytes, u.fan_in)
        for c, u in placement.core_usage.items()
    }
    usages = {p.name: tiled.tile_usage(p.name) for p in net.populations}
    nbrs = _neighbors(tiled, traffic)

    def tile_cost(name: str, at: int) -> float:
        return sum(
            w * grid.hop_distance(at, assignment[other])
            for other, w in nbrs.get(name, [])
            if other != name
        )

    names = [p.name for p in net.populations]
    for _ in range(max_passes):
        improved = False
        for name in names:
            cur = assignment[name]
            base = tile_cost(name, cur)
            best: Tuple[float, int] | None = None
            _book(core_usage, cur, usages[name], -1)
            for core in grid.cores():
                if core == cur or not _fits(core_usage, core, usages[name], grid):
                    continue
                delta = tile_cost(name, core) - base
                if delta < -1e-12 and (best is None or (delta, core) < best):
                    best = (delta, core)
            if best is not None:
                core = best[1]
                _book(core_usage, core, usages[name], +1)
                assignment[name] = core
                mapping.add_move(name, core)
                improved = True
            else:
                _book(core_usage, cur, usages[name], +1)
        # connected-pair swaps (both directions covered by the pair set)
        for name in names:
            for other, _w in nbrs.get(name, []):
                if other <= name:
                    continue
                a, b = assignment[name], assignment[other]
                if a == b:
                    continue
                before = tile_cost(name, a) + tile_cost(other, b)
                _book(core_usage, a, usages[name], -1)
                _book(core_usage, b, usages[other], -1)
                ok = (
                    _fits(core_usage, b, usages[name], grid)
                    and _fits(core_usage, a, usages[other], grid)
                )
                if ok:
                    assignment[name], assignment[other] = b, a
                    after = tile_cost(name, b) + tile_cost(other, a)
                    if after < before - 1e-12:
                        _book(core_usage, b, usages[name], +1)
                        _book(core_usage, a, usages[other], +1)
                        mapping.add_swap(name, other)
                        improved = True
                        continue
                    assignment[name], assignment[other] = a, b
                _book(core_usage, a, usages[name], +1)
                _book(core_usage, b, usages[other], +1)
        if not improved:
            break
    return Placement(
        mapping=mapping,
        assignment=assignment,
        cost=noc_cost(assignment, tiled, grid, traffic),
        core_usage=core_usage,
    )


def place_network(
    tiled: TiledNetwork,
    grid: CoreGrid,
    rates: Optional[Dict[str, float]] = None,
    *,
    refine_passes: int = 4,
) -> Placement:
    """Greedy construction + local-search refinement in one call."""
    traffic = estimate_traffic(tiled, rates)
    return refine(
        greedy_place(tiled, grid, traffic), tiled, grid, traffic,
        max_passes=refine_passes,
    )
