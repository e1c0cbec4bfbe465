"""Parallel (MAC-array) paradigm compiler — paper §III-B and refs [7][8].

The weight-delay-map (WDM) ground truth is the dense tensor
``(delay_range, n_target, n_source)`` of int8 weights: slice ``s`` holds the
weights of all synapses with delay ``s+1``.  At runtime the dominant PE stacks
the last ``delay_range`` spike vectors into the *stacked input buffer* (laid
out by the *input merging table*, read through the *reversed order* ring) and
the subordinate PEs multiply each slice with its corresponding delayed spike
vector on the MAC array.

Four lossless optimization strategies (config flags, DESIGN.md §4.2):

1. ``prune_delay_slices``   — delay slices with no synapses are dropped.
2. ``compress_zero_cols``   — per slice, all-zero source columns are dropped;
   the input merging table records (delay, compressed column) -> source id.
3. ``mac_align``            — compressed slices are padded to the 4 x 16 MAC
   grid (targets x sources); padding bytes are accounted exactly.
4. ``fold_zero_row_blocks`` — all-zero 4-target-row blocks inside a slice are
   skipped via a block index (block-sparse rows).

Subordinate PE count comes from the *two-stage splitting algorithm*: stage 1
splits the target axis (spatial) on 4-row block boundaries; stage 2 splits the
(delay x source-column) axis (temporal) so every chunk fits the DTCM budget.
The split chosen minimizes total PEs ("spatial-temporal balancing way").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from .cost_model import (
    parallel_dominant_cost,
    parallel_subordinate_overhead,
    total,
)
from .hw import SpiNNaker2Config, DEFAULT_S2
from .layer import SNNLayer, is_sparse

_SLICE_HEADER_BYTES = 8
_BLOCK_INDEX_BYTES = 4


@dataclasses.dataclass(frozen=True)
class OptFlags:
    prune_delay_slices: bool = True
    compress_zero_cols: bool = True
    mac_align: bool = True
    fold_zero_row_blocks: bool = True


def _pad(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m if n > 0 else 0


@dataclasses.dataclass
class WDMSlice:
    """One optimized delay slice of the weight-delay-map."""

    delay: int                    # 1-based synaptic delay of this slice
    col_sources: np.ndarray       # (n_cols,) source ids of compressed columns
    matrix: np.ndarray            # (rows_padded, cols_padded) int8
    block_nz: np.ndarray          # (n_row_blocks,) bool — stored blocks
    bytes: int                    # stored bytes incl. padding + block index


@dataclasses.dataclass
class SubordinateAssignment:
    """Stage-2 chunk: (slice index, col range) list for one subordinate PE."""

    part_index: int
    row_block_start: int
    row_block_stop: int
    chunks: List[Tuple[int, int, int]]   # (slice_idx, col_start, col_stop)
    wdm_bytes: int
    cost: Dict[str, float]


@dataclasses.dataclass
class ParallelProgram:
    layer_name: str
    n_source: int
    n_target: int
    delay_range: int
    opts: OptFlags
    slices: List[WDMSlice]
    reversed_order: np.ndarray        # (n_slices,) ring-buffer offsets (= delay)
    dominant_count: int
    dominant_cost: Dict[str, float]
    subordinates: List[SubordinateAssignment]

    @property
    def pe_count(self) -> int:
        return self.dominant_count + len(self.subordinates)

    @property
    def wdm_bytes(self) -> int:
        return int(sum(s.bytes for s in self.slices))

    @property
    def dtcm_bytes(self) -> float:
        dom = total(self.dominant_cost) * self.dominant_count
        sub = sum(total(s.cost) for s in self.subordinates)
        return float(dom + sub)

    def input_merging_table(self) -> List[np.ndarray]:
        """(delay, compressed column) -> source id, one array per slice."""
        return [s.col_sources for s in self.slices]


# ---------------------------------------------------------------------------
# slice statistics (shared by the fast counter and the full compiler)
# ---------------------------------------------------------------------------

def _slice_stats(layer: SNNLayer, opts: OptFlags, hw: SpiNNaker2Config):
    """Per-delay-slice column counts and nonzero row-block masks."""
    conn = layer.connectivity()
    n_blocks = math.ceil(layer.n_target / hw.mac_rows)
    stats = []   # (delay, col_mask, block_nz)
    for s in range(1, layer.delay_range + 1):
        mask = conn & (layer.delays == s)
        nnz = mask.any()
        if opts.prune_delay_slices and not nnz:
            continue
        if opts.compress_zero_cols:
            col_mask = mask.any(axis=1)
        else:
            col_mask = np.ones(layer.n_source, dtype=bool)
        if opts.fold_zero_row_blocks:
            block_nz = np.zeros(n_blocks, dtype=bool)
            nz_tgt = np.flatnonzero(mask.any(axis=0))
            block_nz[np.unique(nz_tgt // hw.mac_rows)] = True
        else:
            block_nz = np.ones(n_blocks, dtype=bool)
        stats.append((s, col_mask, block_nz))
    return stats, n_blocks


def _slice_col_bytes(n_cols: int, opts: OptFlags, hw: SpiNNaker2Config) -> int:
    """Stored bytes of ONE 4-row block of a slice with ``n_cols`` columns."""
    cols = _pad(n_cols, hw.mac_cols) if opts.mac_align else n_cols
    rows = hw.mac_rows
    return rows * cols  # int8 weights


def _block_bytes_matrix(stats, n_blocks, opts, hw) -> np.ndarray:
    """(n_slices, n_blocks) stored bytes per (slice, row-block)."""
    out = np.zeros((len(stats), n_blocks), dtype=np.int64)
    for k, (_s, col_mask, block_nz) in enumerate(stats):
        per_block = _slice_col_bytes(int(col_mask.sum()), opts, hw)
        out[k, block_nz] = per_block + _BLOCK_INDEX_BYTES
    return out


# ---------------------------------------------------------------------------
# two-stage splitting
# ---------------------------------------------------------------------------

def _two_stage_split(
    layer: SNNLayer, stats, n_blocks: int, opts: OptFlags, hw: SpiNNaker2Config
):
    """Return (best_T, parts, per-part chunk counts, per-part bytes).

    parts are contiguous row-block ranges; per part, stage 2 yields
    ``ceil(part_bytes / budget(part_rows))`` subordinate PEs.
    """
    n_src_vertex = max(1, math.ceil(layer.n_source / hw.max_neurons_per_pe))
    bb = _block_bytes_matrix(stats, n_blocks, opts, hw)
    block_totals = bb.sum(axis=0)
    header = _SLICE_HEADER_BYTES * len(stats)
    prefix = np.concatenate([[0], np.cumsum(block_totals)])

    if n_blocks == 0 or block_totals.sum() == 0:
        return 1, [(0, n_blocks)], [0], [0]

    best = None
    for T in range(1, n_blocks + 1):
        # equal contiguous block partition into T parts
        edges = np.linspace(0, n_blocks, T + 1).round().astype(int)
        edges = np.unique(edges)
        if len(edges) - 1 != T:
            continue
        counts, byte_list, parts = [], [], []
        feasible = True
        for p in range(T):
            b0, b1 = int(edges[p]), int(edges[p + 1])
            rows = min(b1 * hw.mac_rows, layer.n_target) - b0 * hw.mac_rows
            if rows <= 0:
                continue
            part_bytes = int(prefix[b1] - prefix[b0]) + header
            overhead = total(
                parallel_subordinate_overhead(
                    rows, layer.delay_range, n_src_vertex, hw=hw
                )
            )
            budget = hw.dtcm_bytes - overhead
            if budget <= 0:
                feasible = False
                break
            counts.append(max(1, math.ceil(part_bytes / budget)))
            byte_list.append(part_bytes)
            parts.append((b0, b1))
        if not feasible:
            continue
        tot = sum(counts)
        if best is None or tot < best[0] or (tot == best[0] and T < best[1]):
            best = (tot, T, parts, counts, byte_list)
    if best is None:
        raise ValueError("no feasible two-stage split (DTCM too small)")
    _tot, T, parts, counts, byte_list = best
    return T, parts, counts, byte_list


def parallel_pe_count_exact(
    layer: SNNLayer,
    *,
    hw: SpiNNaker2Config = DEFAULT_S2,
    opts: OptFlags = OptFlags(),
) -> int:
    """Total PEs (dominant + subordinates), measured from the drawn matrix.

    This is the quantity the paper obtains by *running the compiler* on each
    of the 16,000 dataset layers ("the optimized weight-delay-map ... can't be
    accurately estimated").
    """
    if is_sparse(layer):
        # the parallel paradigm materializes dense MAC slices by design, so
        # CSR inputs densify here — and the dense element cap still applies:
        # a projection that only fits sparse cannot be compiled parallel
        layer = layer.densify()
    stats, n_blocks = _slice_stats(layer, opts, hw)
    n_src_vertex = max(1, math.ceil(layer.n_source / hw.max_neurons_per_pe))
    dom_cost = total(
        parallel_dominant_cost(
            layer.n_source, layer.n_target, layer.delay_range, n_src_vertex, hw=hw
        )
    )
    dom_count = max(1, math.ceil(dom_cost / hw.dtcm_bytes))
    _T, _parts, counts, _bytes = _two_stage_split(layer, stats, n_blocks, opts, hw)
    return int(dom_count + sum(counts))


# ---------------------------------------------------------------------------
# full compilation (runtime artifacts)
# ---------------------------------------------------------------------------

def compile_parallel(
    layer: SNNLayer,
    *,
    hw: SpiNNaker2Config = DEFAULT_S2,
    opts: OptFlags = OptFlags(),
) -> ParallelProgram:
    if is_sparse(layer):
        # dense MAC slices are the parallel paradigm's whole storage format;
        # densify (subject to the element cap) rather than pretend otherwise
        layer = layer.densify()
    stats, n_blocks = _slice_stats(layer, opts, hw)
    n_src_vertex = max(1, math.ceil(layer.n_source / hw.max_neurons_per_pe))

    slices: List[WDMSlice] = []
    for s, col_mask, block_nz in stats:
        cols = np.flatnonzero(col_mask)
        mask = layer.connectivity() & (layer.delays == s)
        w = np.where(mask, layer.weights, 0.0)[cols, :].T  # (n_target, n_cols)
        rows_p = _pad(layer.n_target, hw.mac_rows) if opts.mac_align else layer.n_target
        cols_p = _pad(len(cols), hw.mac_cols) if opts.mac_align else len(cols)
        mat = np.zeros((max(rows_p, layer.n_target), max(cols_p, len(cols))), dtype=np.int8)
        mat[: layer.n_target, : len(cols)] = w.astype(np.int8)
        stored = int(block_nz.sum()) * (
            _slice_col_bytes(len(cols), opts, hw) + _BLOCK_INDEX_BYTES
        ) + _SLICE_HEADER_BYTES
        slices.append(
            WDMSlice(
                delay=s, col_sources=cols, matrix=mat,
                block_nz=block_nz, bytes=stored,
            )
        )

    dom_cost = parallel_dominant_cost(
        layer.n_source, layer.n_target, layer.delay_range, n_src_vertex, hw=hw
    )
    dom_count = max(1, math.ceil(total(dom_cost) / hw.dtcm_bytes))

    _T, parts, counts, byte_list = _two_stage_split(layer, stats, n_blocks, opts, hw)

    subordinates: List[SubordinateAssignment] = []
    for p, ((b0, b1), n_chunks, part_bytes) in enumerate(zip(parts, counts, byte_list)):
        rows = min(b1 * hw.mac_rows, layer.n_target) - b0 * hw.mac_rows
        cost = parallel_subordinate_overhead(
            rows, layer.delay_range, n_src_vertex, hw=hw
        )
        # stage 2: walk (slice, 16-col group) units round-robin into chunks of
        # ~equal bytes so every chunk fits the budget.
        units: List[Tuple[int, int, int, int]] = []  # (slice, c0, c1, bytes)
        for k, sl in enumerate(slices):
            n_cols = len(sl.col_sources)
            if n_cols == 0:
                continue
            step = hw.mac_cols
            nz_blocks = int(sl.block_nz[b0:b1].sum())
            if nz_blocks == 0:
                continue
            for c0 in range(0, n_cols, step):
                c1 = min(c0 + step, n_cols)
                u_bytes = nz_blocks * hw.mac_rows * (
                    _pad(c1 - c0, step) if opts.mac_align else (c1 - c0)
                )
                units.append((k, c0, c1, u_bytes))
        per_chunk = max(1, math.ceil(max(1, part_bytes) / max(1, n_chunks)))
        chunk_lists: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_chunks)]
        chunk_bytes = [0] * n_chunks
        ci = 0
        for (k, c0, c1, u_bytes) in units:
            if chunk_bytes[ci] + u_bytes > per_chunk and ci < n_chunks - 1:
                ci += 1
            chunk_lists[ci].append((k, c0, c1))
            chunk_bytes[ci] += u_bytes
        for ci in range(n_chunks):
            cost_ci = dict(cost)
            cost_ci["wdm"] = float(chunk_bytes[ci])
            subordinates.append(
                SubordinateAssignment(
                    part_index=p,
                    row_block_start=b0,
                    row_block_stop=b1,
                    chunks=chunk_lists[ci],
                    wdm_bytes=chunk_bytes[ci],
                    cost=cost_ci,
                )
            )

    reversed_order = np.array([s.delay for s in slices], dtype=np.int64)
    return ParallelProgram(
        layer_name=layer.name,
        n_source=layer.n_source,
        n_target=layer.n_target,
        delay_range=layer.delay_range,
        opts=opts,
        slices=slices,
        reversed_order=reversed_order,
        dominant_count=dom_count,
        dominant_cost=dom_cost,
        subordinates=subordinates,
    )
