"""Core-grid hardware model: a 2D mesh of PEs with per-core budgets.

SpiNNaker2 arranges PEs in quad-core processing elements on a 2D
network-on-chip mesh (arXiv 1911.02385); spikes travel the NoC as
multicast packets whose cost grows with the XY-routed hop count between
source and destination core.  This module models exactly the facts the
placement search needs:

* a rectangular ``rows x cols`` grid of cores, each with the **aggregate**
  :class:`~repro_torch.core.hw.PEBudget` (neuron capacity, usable DTCM bytes,
  fan-in limit) derived from :class:`~repro_torch.core.hw.SpiNNaker2Config` —
  the per-core generalization of the per-projection checks the paradigm
  compilers run;
* **hop distance** between cores (Manhattan / XY routing), the per-packet
  NoC cost the mapper minimizes across cut edges.

The grid is deliberately free of placement state: :mod:`.mapper` carries
the mutable core -> load bookkeeping so several candidate placements can
share one grid.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

from ..core.hw import DEFAULT_S2, PEBudget, SpiNNaker2Config


@dataclasses.dataclass(frozen=True)
class CoreGrid:
    """A ``rows x cols`` mesh of identical PEs.

    Cores are addressed by flat index ``0 .. n_cores-1`` in row-major
    order; :meth:`coord` / :meth:`index` convert to/from ``(row, col)``.
    The default 7x8 grid close to one SpiNNaker2 chip (152 PEs across 38
    quad-PEs; a single-chip placement region of 56 cores keeps search
    spaces small while exercising every constraint).
    """

    rows: int = 7
    cols: int = 8
    hw: SpiNNaker2Config = DEFAULT_S2
    max_fan_in: int = 128

    def __post_init__(self) -> None:
        if self.rows <= 0 or self.cols <= 0:
            raise ValueError("grid needs positive rows and cols")

    @property
    def n_cores(self) -> int:
        return self.rows * self.cols

    @property
    def budget(self) -> PEBudget:
        """The aggregate per-core budget every placed load packs against."""
        return PEBudget.from_config(self.hw, max_fan_in=self.max_fan_in)

    def coord(self, core: int) -> Tuple[int, int]:
        if not 0 <= core < self.n_cores:
            raise ValueError(f"core {core} outside 0..{self.n_cores - 1}")
        return divmod(core, self.cols)

    def index(self, row: int, col: int) -> int:
        if not (0 <= row < self.rows and 0 <= col < self.cols):
            raise ValueError(f"({row}, {col}) outside {self.rows}x{self.cols}")
        return row * self.cols + col

    def hop_distance(self, a: int, b: int) -> int:
        """Manhattan hops between two cores (XY-routed NoC mesh)."""
        ra, ca = self.coord(a)
        rb, cb = self.coord(b)
        return abs(ra - rb) + abs(ca - cb)

    def cores(self) -> Iterator[int]:
        return iter(range(self.n_cores))

    def cores_by_distance(self, origin: int) -> list:
        """All cores ordered by hop distance from ``origin`` (ties by
        index) — the greedy placer's candidate order."""
        return sorted(
            range(self.n_cores),
            key=lambda c: (self.hop_distance(origin, c), c),
        )
