"""Hardware models.

Two hardware descriptions live here:

* :class:`SpiNNaker2Config` — the paper's target. All byte budgets in the
  Table I cost model and both paradigm compilers are driven by this object,
  so the switching system stays bit-faithful to the paper while remaining
  parameterizable (the paper itself changes DTCM 64 kB -> 96 kB vs sPyNNaker).

* :class:`TPUv5eConfig` — the roofline target for the JAX/Pallas runtimes and
  the LM substrate.  Constants from the task spec: 197 TFLOP/s bf16 per chip,
  819 GB/s HBM, ~50 GB/s per ICI link.

Plus the **aggregate per-core accounting** the placement engine packs
against (:class:`PEBudget` / :class:`PEUsage`).  The paradigm compilers
check each projection against the DTCM *independently* — correct for the
paper's one-projection-per-PE-group mapping, but silently wrong the moment
two projections (or a tile's neurons and several in-projections) share a
core: each can fit alone while their sum over-commits the SRAM.
:func:`check_core` is the shared-core check; everything placed on one PE
must fit **jointly**, with the OS overhead booked exactly once per core.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple


@dataclasses.dataclass(frozen=True)
class SpiNNaker2Config:
    """Per-PE resource model of SpiNNaker2 (paper §II)."""

    # 128 kB SRAM per PE; the paper budgets 96 kB of it as DTCM for the
    # compiled data structures (paper §IV-A, raised from sPyNNaker's 64 kB).
    sram_bytes: int = 128 * 1024
    dtcm_bytes: int = 96 * 1024

    # sPyNNaker-lineage fixed neuron capacity per PE (paper §III / [14]).
    max_neurons_per_pe: int = 255

    # MAC array layout: 64 units as 4 (rows) x 16 (columns)  (paper §II).
    mac_rows: int = 4
    mac_cols: int = 16

    # Operand precisions used throughout the paper: 8-bit weights,
    # 32-bit synaptic words in the serial paradigm.
    weight_bits: int = 8
    serial_synapse_word_bits: int = 32

    # The serial paradigm splits an over-budget synaptic matrix across
    # 2..4 adjacent PEs (paper §IV-A).
    max_matrix_split: int = 4

    # Fixed baseline cost on every PE (Table I "hw mgmt & OS").
    os_overhead_bytes: int = 6000

    # LIF neuron+synapse model parameter count (Table I: "LIF:8+6").
    lif_n_params: int = 8 + 6

    @property
    def mac_units(self) -> int:
        return self.mac_rows * self.mac_cols


@dataclasses.dataclass(frozen=True)
class TPUv5eConfig:
    """Roofline constants for one TPU v5e chip (task spec)."""

    peak_flops_bf16: float = 197e12      # FLOP/s
    hbm_bandwidth: float = 819e9         # B/s
    ici_link_bandwidth: float = 50e9     # B/s per link
    hbm_bytes: int = 16 * 1024**3        # 16 GiB HBM per chip
    vmem_bytes: int = 128 * 1024**2      # ~128 MiB VMEM
    mxu_dim: int = 128                   # systolic array tile edge

    # int8 matmuls run at 2x bf16 on the MXU (v5e supports int8 @ ~394 TOPS).
    peak_ops_int8: float = 394e12


DEFAULT_S2 = SpiNNaker2Config()
DEFAULT_TPU = TPUv5eConfig()


class BudgetExceeded(ValueError):
    """A core's aggregate load over-commits one of its budgets."""


@dataclasses.dataclass(frozen=True)
class PEBudget:
    """What one PE can hold — the limits aggregate loads are packed against.

    ``dtcm_bytes`` is the *usable* synapse/structure budget: the fixed OS
    overhead is subtracted once per core here, so loads never book it
    themselves (the pre-aggregate accounting double-counted it whenever two
    projections were sized for the same PE independently).
    """

    max_neurons: int
    dtcm_bytes: float
    #: Distinct in-projections (routing-table entries / DMA streams) one
    #: core can serve; SpiNNaker2's router has 1k entries chip-wide over
    #: 152 PEs, so a handful of multicast trees per core is the realistic
    #: regime — kept generous by default and tightened by tests.
    max_fan_in: int = 128
    #: Incoming multicast packets per timestep one core can absorb
    #: (spike-processing headroom).  ``None`` disables the dimension —
    #: it only binds when measured activity is available to book against
    #: it (:func:`repro.placement.mapper.check_activity_budgets`).
    max_in_packets: float | None = None

    @classmethod
    def from_config(
        cls,
        hw: SpiNNaker2Config = DEFAULT_S2,
        *,
        max_fan_in: int = 128,
        max_in_packets: float | None = None,
    ) -> "PEBudget":
        return cls(
            max_neurons=hw.max_neurons_per_pe,
            dtcm_bytes=float(hw.dtcm_bytes - hw.os_overhead_bytes),
            max_fan_in=max_fan_in,
            max_in_packets=max_in_packets,
        )


@dataclasses.dataclass
class PEUsage:
    """Aggregate load on one PE: neurons + synapse memory + fan-in.

    One ``PEUsage`` accumulates *everything* sharing the core — a tile's
    neuron state plus the synaptic structures of every projection
    targeting it — so the fit check sees the joint footprint, not each
    contribution in isolation.
    """

    neurons: int = 0
    synapse_bytes: float = 0.0
    fan_in: int = 0
    in_packets: float = 0.0

    def add(
        self,
        *,
        neurons: int = 0,
        synapse_bytes: float = 0.0,
        fan_in: int = 0,
        in_packets: float = 0.0,
    ) -> "PEUsage":
        self.neurons += neurons
        self.synapse_bytes += synapse_bytes
        self.fan_in += fan_in
        self.in_packets += in_packets
        return self

    def merge(self, other: "PEUsage") -> "PEUsage":
        return self.add(
            neurons=other.neurons,
            synapse_bytes=other.synapse_bytes,
            fan_in=other.fan_in,
            in_packets=other.in_packets,
        )

    def overcommits(self, budget: PEBudget) -> Tuple[str, ...]:
        """The budget dimensions this load exceeds (empty = it fits)."""
        over = []
        if self.neurons > budget.max_neurons:
            over.append("neurons")
        if self.synapse_bytes > budget.dtcm_bytes:
            over.append("dtcm")
        if self.fan_in > budget.max_fan_in:
            over.append("fan_in")
        if (
            budget.max_in_packets is not None
            and self.in_packets > budget.max_in_packets
        ):
            over.append("in_packets")
        return tuple(over)

    def fits(self, budget: PEBudget) -> bool:
        return not self.overcommits(budget)


def aggregate_pe_usage(loads: Iterable[PEUsage]) -> PEUsage:
    """The joint footprint of every load sharing one core."""
    total = PEUsage()
    for load in loads:
        total.merge(load)
    return total


def check_core(
    loads: Iterable[PEUsage],
    budget: PEBudget,
    *,
    core: object = None,
) -> PEUsage:
    """Raise :class:`BudgetExceeded` unless the loads fit *jointly*.

    This is the shared-core fix: projections that each pass their own
    per-projection DTCM check can still over-commit a core together, and
    only the aggregate reveals it.  Returns the aggregate on success.
    """
    total = aggregate_pe_usage(loads)
    over = total.overcommits(budget)
    if over:
        where = "" if core is None else f"core {core}: "
        raise BudgetExceeded(
            f"{where}aggregate load (neurons={total.neurons}, "
            f"synapse_bytes={total.synapse_bytes:.0f}, "
            f"fan_in={total.fan_in}, in_packets={total.in_packets:.2f}) "
            f"exceeds {', '.join(over)} budget "
            f"(max_neurons={budget.max_neurons}, "
            f"dtcm_bytes={budget.dtcm_bytes:.0f}, "
            f"max_fan_in={budget.max_fan_in}, "
            f"max_in_packets={budget.max_in_packets})"
        )
    return total
