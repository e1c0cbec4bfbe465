"""Serial (ARM, event-driven) paradigm compiler — paper §III-A.

Mapping pipeline (Fig. 2): application-graph vertex -> equal sub-population
split at the 255-neuron PE capacity -> per-(source-part x target-part) cell,
emit the event-driven data structures:

* master population table — one 96-bit entry per source vertex; a spike's
  source-vertex key unlocks the entry, which points into the address list.
* address list — one 32-bit row per source neuron: (first address, row
  length) of that neuron's block in the synaptic matrix.
* synaptic matrix — one block per source neuron; each 32-bit row packs
  (weight, delay, synapse type, target neuron index) for one synapse.

If a cell's synaptic matrix overflows the 96 kB DTCM (density >~ 25%) the
matrix is split evenly across 2-4 adjacent PEs (paper §IV-A); the other
structures are replicated on each.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from .cost_model import (
    equal_parts,
    serial_pe_cost,
    serial_pe_overhead,
    total,
)
from .hw import SpiNNaker2Config, DEFAULT_S2
from .layer import LayerCharacter, SNNLayer, is_sparse

# --- 32-bit synaptic row packing -------------------------------------------
# | 31..24 weight magnitude (8b) | 23..20 delay-1 (4b) | 19 type | 18..0 index |
_W_SHIFT, _D_SHIFT, _T_SHIFT = 24, 20, 19
_IDX_MASK = (1 << 19) - 1


def pack_rows(weights: np.ndarray, delays: np.ndarray, tgt_idx: np.ndarray) -> np.ndarray:
    mag = np.abs(weights).astype(np.uint32) & 0xFF
    dly = (delays.astype(np.uint32) - 1) & 0xF
    typ = (weights < 0).astype(np.uint32)  # 1 = inhibitory
    idx = tgt_idx.astype(np.uint32) & _IDX_MASK
    return (mag << _W_SHIFT) | (dly << _D_SHIFT) | (typ << _T_SHIFT) | idx


def unpack_rows(rows: np.ndarray):
    mag = (rows >> _W_SHIFT) & 0xFF
    dly = ((rows >> _D_SHIFT) & 0xF) + 1
    typ = (rows >> _T_SHIFT) & 0x1
    idx = rows & _IDX_MASK
    sign = np.where(typ == 1, -1.0, 1.0)
    return mag.astype(np.float64) * sign, dly.astype(np.int64), idx.astype(np.int64)


@dataclasses.dataclass
class SerialCell:
    """One (source-part x target-part) machine-graph cell."""

    src_start: int
    src_size: int
    tgt_start: int
    tgt_size: int
    master_population_table: np.ndarray  # (n_source_vertex, 3): key, offset, len
    address_list: np.ndarray             # (src_size, 2): row_start, row_len
    synaptic_rows: np.ndarray            # (n_synapses,) uint32 packed
    matrix_split: int                    # PEs this cell occupies (1..4)
    cost: dict

    @property
    def pe_count(self) -> int:
        return self.matrix_split


@dataclasses.dataclass
class SerialProgram:
    layer_name: str
    n_source: int
    n_target: int
    delay_range: int
    cells: List[SerialCell]

    @property
    def pe_count(self) -> int:
        return sum(c.pe_count for c in self.cells)

    @property
    def dtcm_bytes(self) -> float:
        return float(sum(total(c.cost) for c in self.cells))


def _matrix_split_factor(
    matrix_bytes: float, overhead: float, hw: SpiNNaker2Config
) -> int:
    budget = hw.dtcm_bytes - overhead
    if budget <= 0:
        raise ValueError("serial PE overhead alone exceeds DTCM")
    k = max(1, math.ceil(matrix_bytes / budget))
    return k


def serial_pe_count(
    character: LayerCharacter, *, hw: SpiNNaker2Config = DEFAULT_S2
) -> int:
    """Analytic PE count from the layer character alone (Table I driven)."""
    character.validate()
    src_parts = equal_parts(character.n_source, hw.max_neurons_per_pe)
    tgt_parts = equal_parts(character.n_target, hw.max_neurons_per_pe)
    n_src_vertex = len(src_parts)
    pes = 0
    for sp in src_parts:
        for tp in tgt_parts:
            overhead = serial_pe_overhead(
                tp, sp, character.delay_range, n_src_vertex, hw=hw
            )
            matrix = (32 / 8) * sp * tp * character.weight_density
            k = _matrix_split_factor(matrix, overhead, hw)
            if k > hw.max_matrix_split:
                # Paper caps the matrix split at 4 adjacent PEs; beyond that
                # the target part itself must shrink.  Never triggered on the
                # paper's dataset grid (verified in tests).
                k = hw.max_matrix_split
                sub = serial_pe_count(
                    LayerCharacter(
                        sp, tp, character.weight_density, character.delay_range
                    ),
                    hw=dataclasses.replace(
                        hw, max_neurons_per_pe=max(1, tp // 2)
                    ),
                )
                pes += sub
                continue
            pes += k
    return pes


def serial_pe_count_exact(
    layer: SNNLayer, *, hw: SpiNNaker2Config = DEFAULT_S2
) -> int:
    """PE count measured from the drawn weight matrix (per-cell synapse counts)."""
    src_parts = equal_parts(layer.n_source, hw.max_neurons_per_pe)
    tgt_parts = equal_parts(layer.n_target, hw.max_neurons_per_pe)
    n_src_vertex = len(src_parts)
    src_edges = np.cumsum([0] + src_parts)
    tgt_edges = np.cumsum([0] + tgt_parts)
    if is_sparse(layer):
        si, ti, _, _ = layer.coo()     # synapse coordinates, no dense array
    else:
        si, ti = np.nonzero(layer.connectivity())
    # synapse count per (src_part, tgt_part) cell via 2-D histogram
    cell_counts, _, _ = np.histogram2d(si, ti, bins=[src_edges, tgt_edges])
    pes = 0
    for a, sp in enumerate(src_parts):
        for b, tp in enumerate(tgt_parts):
            overhead = serial_pe_overhead(tp, sp, layer.delay_range, n_src_vertex, hw=hw)
            matrix = 4.0 * cell_counts[a, b]
            pes += min(hw.max_matrix_split, _matrix_split_factor(matrix, overhead, hw))
    return int(pes)


def compile_serial(
    layer: SNNLayer, *, hw: SpiNNaker2Config = DEFAULT_S2
) -> SerialProgram:
    """Emit the full event-driven machine graph for one projection.

    Accepts dense :class:`SNNLayer` and CSR
    :class:`~repro_torch.core.layer.SparseProjection` storage alike; the sparse
    path assigns synapses to cells straight from the COO coordinates and
    never materializes an ``(S, T)`` array.  Its cost is linear in the
    synapses: one stable sort groups them by cell, and each cell is then a
    contiguous slice (row-major inside it, as the COO order was).
    """
    src_parts = equal_parts(layer.n_source, hw.max_neurons_per_pe)
    tgt_parts = equal_parts(layer.n_target, hw.max_neurons_per_pe)
    n_src_vertex = len(src_parts)
    src_edges = np.cumsum([0] + src_parts)
    tgt_edges = np.cumsum([0] + tgt_parts)
    cell_synapses = _sparse_cells if is_sparse(layer) else _dense_cells

    cells: List[SerialCell] = []
    synapses = cell_synapses(layer, src_parts, tgt_parts, src_edges, tgt_edges)
    for a, sp in enumerate(src_parts):
        # single projection => one master-population-table entry per
        # source vertex; entry = (routing key, address-list offset, len).
        # The other source vertices route to sibling cells; their entries
        # exist in every PE's table (Table I counts n_source_vertex).  Every
        # cell of a source part holds the same table.
        mpt = np.zeros((n_src_vertex, 3), dtype=np.int64)
        mpt[0] = (a, 0, sp)
        mpt[1:, 0] = np.delete(np.arange(n_src_vertex), a)
        for b, tp in enumerate(tgt_parts):
            si, ti, w_sel, d_sel, cell_elems = next(synapses)
            rows_per_src = np.bincount(si, minlength=sp)

            # one block per source neuron, rows sorted by (source, target)
            row_start = np.concatenate([[0], np.cumsum(rows_per_src)[:-1]])
            address_list = np.stack(
                [row_start, rows_per_src], axis=1
            ).astype(np.int64)

            packed = pack_rows(w_sel, d_sel, ti)

            overhead = serial_pe_overhead(tp, sp, layer.delay_range, n_src_vertex, hw=hw)
            matrix_bytes = 4.0 * packed.size
            k = min(
                hw.max_matrix_split,
                _matrix_split_factor(matrix_bytes, overhead, hw),
            )
            cost = serial_pe_cost(
                tp, sp, (packed.size / max(1, cell_elems)), layer.delay_range,
                n_src_vertex, hw=hw, matrix_split=k,
            )
            cells.append(
                SerialCell(
                    src_start=int(src_edges[a]), src_size=sp,
                    tgt_start=int(tgt_edges[b]), tgt_size=tp,
                    master_population_table=mpt,
                    address_list=address_list,
                    synaptic_rows=packed,
                    matrix_split=k,
                    cost=cost,
                )
            )
    return SerialProgram(
        layer_name=layer.name,
        n_source=layer.n_source,
        n_target=layer.n_target,
        delay_range=layer.delay_range,
        cells=cells,
    )


def _sparse_cells(layer, src_parts, tgt_parts, src_edges, tgt_edges):
    """Each cell's ``(local source, local target, weight, delay, elements)``
    in (source part, target part) order, from the COO synapses."""
    src, tgt, w, d = layer.coo()
    part_a = np.repeat(np.arange(len(src_parts)), src_parts)[src]
    part_b = np.repeat(np.arange(len(tgt_parts)), tgt_parts)[tgt]
    n_cells = len(src_parts) * len(tgt_parts)
    cell = part_a * len(tgt_parts) + part_b
    # a stable sort keeps coo()'s row-major order inside each cell, the
    # order the dense path's nonzero() scan produces; 16-bit keys sort in
    # linear time
    order = np.argsort(cell.astype(np.uint16) if n_cells <= 1 << 16 else cell,
                       kind="stable")
    bounds = np.zeros(n_cells + 1, np.int64)
    np.cumsum(np.bincount(cell, minlength=n_cells), out=bounds[1:])
    src_local = (src - src_edges[part_a])[order]
    tgt_local = (tgt - tgt_edges[part_b])[order]
    w, d = w[order], d[order]
    for a, sp in enumerate(src_parts):
        for b, tp in enumerate(tgt_parts):
            k = a * len(tgt_parts) + b
            s = slice(bounds[k], bounds[k + 1])
            yield src_local[s], tgt_local[s], w[s], d[s], sp * tp


def _dense_cells(layer, src_parts, tgt_parts, src_edges, tgt_edges):
    """Each cell's ``(local source, local target, weight, delay, elements)``
    in (source part, target part) order, from the dense arrays."""
    for a, sp in enumerate(src_parts):
        s0 = int(src_edges[a])
        for b, tp in enumerate(tgt_parts):
            t0 = int(tgt_edges[b])
            w = layer.weights[s0 : s0 + sp, t0 : t0 + tp]
            d = layer.delays[s0 : s0 + sp, t0 : t0 + tp]
            si, ti = np.nonzero(w != 0.0)
            yield si, ti, w[si, ti], d[si, ti], w.size
