"""Tiling pass: split oversized populations into per-core sub-populations.

The paper (and its sPyNNaker lineage) maps at most 255 neurons onto one
PE, so any larger :class:`~repro_torch.core.layer.Population` must be split
before placement.  This pass rewrites the application graph:

* every population larger than the per-core neuron budget becomes a run
  of **tiles** (sub-populations of equal size, ``equal_parts``), declared
  in offset order;
* every projection becomes a grid of **block sub-projections** — one per
  (source-tile x target-tile) pair, carrying the corresponding weight /
  delay sub-matrix.  CSR projections
  (:class:`~repro_torch.core.layer.SparseProjection`) slice their blocks
  directly in CSR form (``slice_block``), so tiling a sparse giant never
  materializes a dense sub-matrix.  All-zero blocks are pruned unless a
  tile would be left with no in-edge at all (which would misread it as an
  external input).

The rewrite is **output-preserving by construction** and verified
bit-exactly by the differential harness (``tests/test_tiling.py``):

* a *forward* projection's blocks stay forward — the tiled forward graph
  is the original DAG with each vertex expanded to a run of tiles, so the
  topological cascade lifts unchanged;
* a *back-edge* projection's blocks are **forced** back-edges
  (``SNNNetwork(forced_back_edges=...)``): every block reads the source
  tile's previous-step spikes from the feedback ring, exactly as every
  neuron of the untiled source saw previous-step spikes.  Blocks of a
  tiled self-loop connect tile pairs in both directions, so no total
  order could classify them uniformly without the override;
* a target tile **sums the currents** of all its in-blocks before its one
  LIF update — integer-exact in float32, so fan-in introduced by tiling
  never changes a spike;
* each tile pins its resolved LIF parameters explicitly
  (``Population.lif``), so multi-block fan-in never trips the ambiguity
  check.

The **input population is never tiled**: the graph contract is a single
external spike source (multi-input generalization is a ROADMAP item),
and splitting it would turn every input tile into a separate source.

:meth:`TiledNetwork.assemble` maps the tiled executor's per-projection
trains back to the original network's view (concatenating tile trains
along the neuron axis), which is what the equivalence tests compare
against the untiled oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.cost_model import equal_parts
from ..core.hw import DEFAULT_S2, PEUsage, SpiNNaker2Config
from ..core.layer import Population, Projection, SNNNetwork, is_sparse


@dataclasses.dataclass(frozen=True)
class TileSlice:
    """One tile's position within its original population."""

    population: str     # original population name
    start: int          # neuron offset within the original population
    size: int


@dataclasses.dataclass
class TiledNetwork:
    """A tiled application graph plus the book-keeping to invert it."""

    #: The rewritten graph (tiles as populations, blocks as projections,
    #: back-edge blocks forced onto the feedback path).
    network: SNNNetwork
    #: The untiled original.
    original: SNNNetwork
    #: Original population name -> tile names in offset order.
    tiles_of: Dict[str, Tuple[str, ...]]
    #: Tile name -> (original population, start, size).
    tile_slices: Dict[str, TileSlice]
    #: Original projection index -> tiled projection indices (its blocks).
    blocks_of: Tuple[Tuple[int, ...], ...]
    #: The neuron budget the pass tiled against.
    max_neurons: int

    @property
    def was_tiled(self) -> bool:
        """Did any population actually split?"""
        return any(len(t) > 1 for t in self.tiles_of.values())

    def tile_usage(self, tile: str) -> PEUsage:
        """Aggregate PE load of one tile: its neurons plus the synaptic
        structures of every in-block (4 B packed row per synapse + a 4 B
        address-list row per source neuron + one 12 B master-population-
        table entry per in-block), the serial-paradigm footprint the
        shared-core check packs against."""
        usage = PEUsage(neurons=self.tile_slices[tile].size)
        net = self.network
        p = net.population_index(tile)
        for ei in net.in_edges[p]:
            e = net.projections[ei]
            usage.add(
                synapse_bytes=4.0 * e.n_synapses + 4.0 * e.n_source + 12.0,
                fan_in=1,
            )
        return usage

    def assemble(self, outs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Tiled per-projection trains -> the original network's view.

        ``outs`` is the tiled executor's output (entry ``j`` = the spike
        train of tiled projection ``j``'s target tile).  Returns one
        train per *original* projection — its target population's train,
        concatenated from that population's tile trains along the neuron
        axis — matching ``NetworkExecutable.run`` on the untiled net.
        """
        if len(outs) != len(self.network.projections):
            raise ValueError(
                f"expected {len(self.network.projections)} tiled trains; "
                f"got {len(outs)}"
            )
        tile_train: Dict[str, np.ndarray] = {}
        endpoints = self.network.endpoints
        for j, z in enumerate(outs):
            tile_train.setdefault(endpoints[j][1], np.asarray(z))
        assembled = []
        for _, post in self.original.endpoints:
            parts = [tile_train[t] for t in self.tiles_of[post]]
            assembled.append(
                parts[0] if len(parts) == 1 else np.concatenate(parts, axis=2)
            )
        return assembled


def _tile_populations(
    net: SNNNetwork, max_neurons: int
) -> Tuple[List[Population], Dict[str, Tuple[str, ...]], Dict[str, TileSlice]]:
    pops: List[Population] = []
    tiles_of: Dict[str, Tuple[str, ...]] = {}
    slices: Dict[str, TileSlice] = {}
    # NO input population is ever tiled — each stays one tile so the
    # tiled graph's input set (and its concatenated train layout) matches
    # the original exactly, multi-input graphs included
    input_set = set(net.input_indices)
    for idx, p in enumerate(net.populations):
        if idx in input_set or p.size <= max_neurons:
            parts = [p.size]
        else:
            parts = equal_parts(p.size, max_neurons)
        lif = p.lif if idx in input_set else net.population_lif(idx)
        names, start = [], 0
        for sz in parts:
            name = p.name if len(parts) == 1 else f"{p.name}@{start}"
            pops.append(Population(name, sz, lif=lif))
            slices[name] = TileSlice(population=p.name, start=start, size=sz)
            names.append(name)
            start += sz
        tiles_of[p.name] = tuple(names)
    return pops, tiles_of, slices


def tile_network(
    net: SNNNetwork,
    *,
    max_neurons: int | None = None,
    hw: SpiNNaker2Config = DEFAULT_S2,
) -> TiledNetwork:
    """Rewrite ``net`` so no population exceeds ``max_neurons`` neurons.

    ``max_neurons`` defaults to the hardware's per-PE neuron capacity
    (255 for SpiNNaker2); tests pass small values to force tiling on
    small fixtures.  Networks already within budget come back as
    single-tile identities (``was_tiled`` False) through the exact same
    code path.
    """
    max_neurons = int(max_neurons or hw.max_neurons_per_pe)
    if max_neurons < 1:
        raise ValueError("max_neurons must be >= 1")
    pops, tiles_of, slices = _tile_populations(net, max_neurons)

    # candidate blocks: (orig index, post tile, projection, nnz), in
    # (original projection, source-tile, target-tile) declaration order
    candidates = []
    for ei, (e, (pre, post)) in enumerate(
        zip(net.projections, net.endpoints)
    ):
        for a, src in enumerate(tiles_of[pre]):
            s = slices[src]
            for b, tgt in enumerate(tiles_of[post]):
                t = slices[tgt]
                if is_sparse(e):
                    # CSR blocks slice directly — a tiled sparse giant
                    # never materializes any dense sub-matrix
                    block = e.slice_block(
                        s.start, s.start + s.size,
                        t.start, t.start + t.size,
                        pre=src, post=tgt, name=f"{e.name}[{a}.{b}]",
                    )
                    nnz = block.n_synapses
                else:
                    w = e.weights[s.start : s.start + s.size,
                                  t.start : t.start + t.size]
                    block = Projection(
                        weights=w.copy(),
                        delays=e.delays[s.start : s.start + s.size,
                                        t.start : t.start + t.size].copy(),
                        delay_range=e.delay_range,
                        lif=e.lif,
                        name=f"{e.name}[{a}.{b}]",
                        pre=src,
                        post=tgt,
                    )
                    nnz = int((w != 0.0).sum())
                candidates.append((ei, tgt, block, nnz))

    keep = [c for c in candidates if c[3] > 0]
    # rescue rule: a tile every in-block of which pruned away must keep
    # one (empty) block, or the graph would misread it as an input source
    driven = {c[1] for c in keep}
    input_tiles = {net.populations[i].name for i in net.input_indices}
    for c in candidates:
        if c[1] not in input_tiles and c[1] not in driven:
            keep.append(c)
            driven.add(c[1])
    # restore declaration order after the rescue appends
    order = {id(c): i for i, c in enumerate(candidates)}
    keep.sort(key=lambda c: order[id(c)])

    projections = [c[2] for c in keep]
    forced_back = [
        j for j, c in enumerate(keep) if c[0] in net.back_edges
    ]
    blocks_of: List[List[int]] = [[] for _ in net.projections]
    for j, c in enumerate(keep):
        blocks_of[c[0]].append(j)

    tiled = SNNNetwork(
        populations=pops,
        projections=projections,
        name=f"{net.name}.tiled",
        forced_back_edges=forced_back,
    )
    return TiledNetwork(
        network=tiled,
        original=net,
        tiles_of=tiles_of,
        tile_slices=slices,
        blocks_of=tuple(tuple(b) for b in blocks_of),
        max_neurons=max_neurons,
    )
