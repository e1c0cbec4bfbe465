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
    never materializes an ``(S, T)`` array.
    """
    src_parts = equal_parts(layer.n_source, hw.max_neurons_per_pe)
    tgt_parts = equal_parts(layer.n_target, hw.max_neurons_per_pe)
    n_src_vertex = len(src_parts)
    src_edges = np.cumsum([0] + src_parts)
    tgt_edges = np.cumsum([0] + tgt_parts)

    sparse = is_sparse(layer)
    if sparse:
        all_src, all_tgt, all_w, all_d = layer.coo()
        # coo() is row-major => already sorted by (source, target), the
        # order the dense path's nonzero() scan produces within each cell
        cell_a = np.searchsorted(src_edges, all_src, side="right") - 1
        cell_b = np.searchsorted(tgt_edges, all_tgt, side="right") - 1

    cells: List[SerialCell] = []
    for a, sp in enumerate(src_parts):
        s0 = int(src_edges[a])
        for b, tp in enumerate(tgt_parts):
            t0 = int(tgt_edges[b])
            if sparse:
                sel = (cell_a == a) & (cell_b == b)
                si = all_src[sel] - s0
                ti = all_tgt[sel] - t0
                w_sel, d_sel = all_w[sel], all_d[sel]
                rows_per_src = np.bincount(si, minlength=sp)
                cell_elems = sp * tp
            else:
                w = layer.weights[s0 : s0 + sp, t0 : t0 + tp]
                d = layer.delays[s0 : s0 + sp, t0 : t0 + tp]
                conn = w != 0.0
                rows_per_src = conn.sum(axis=1)
                si, ti = np.nonzero(conn)
                w_sel, d_sel = w[si, ti], d[si, ti]
                cell_elems = w.size

            # one block per source neuron, rows sorted by (source, target)
            row_start = np.concatenate([[0], np.cumsum(rows_per_src)[:-1]])
            address_list = np.stack(
                [row_start, rows_per_src], axis=1
            ).astype(np.int64)

            packed = pack_rows(w_sel, d_sel, ti)

            # single projection => one master-population-table entry per
            # source vertex; entry = (routing key, address-list offset, len)
            mpt = np.array([[a, 0, sp]], dtype=np.int64)
            for extra in range(n_src_vertex - 1):
                # other source vertices route to sibling cells; their entries
                # exist in every PE's table (Table I counts n_source_vertex).
                mpt = np.vstack([mpt, [extra if extra < a else extra + 1, 0, 0]])

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
                    src_start=s0, src_size=sp, tgt_start=t0, tgt_size=tp,
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
