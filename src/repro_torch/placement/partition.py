"""Placement -> sharding bridge: device groups from core assignments.

A placement maps tiles onto the core grid; this module folds that map
down to the **device** granularity the port executes at (CUDA cards).  The grid
is carved into ``n_devices`` contiguous column slabs (columns are the
XY-routing major axis, so a slab cut crosses the fewest multicast
trees), every core inherits its slab's device, every tile inherits its
core's device, and every tiled projection runs where its *target* tile
lives (the serial paradigm's convention: synaptic rows are stored and
accumulated at the destination PE).

Cross-device blocks form the **halo-exchange plan**: the source tile's
previous-step spike vector must be visible on the target's device before
the block's gather runs.  On one device — CPU CI — the plan is the
identity: a single group holding the whole grid, an empty halo list, and
:func:`~repro_torch.distributed.sharding.placement_put` a no-op, so the exact
same code path runs end-to-end unsharded (the same fallback contract as
``snn_mesh() is None``).

The resulting :class:`DeviceAssignment` is what
``NetworkExecutable.shard(assignment=...)`` consumes and what
``CompileReport.placement`` records.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..distributed.sharding import visible_cards
from .grid import CoreGrid
from .mapper import Placement
from .tiling import TiledNetwork


@dataclasses.dataclass(frozen=True)
class HaloEdge:
    """One cross-device block: spikes of ``pre`` must reach ``dst_device``."""

    projection: int     # tiled projection index
    pre: str            # source tile
    post: str           # target tile
    src_device: int
    dst_device: int
    n_bits: int         # spike-vector payload per step (1 bit/source neuron)


@dataclasses.dataclass(frozen=True)
class DeviceAssignment:
    """Device-granular view of a placement.

    ``groups[d]`` is the tuple of core indices device ``d`` owns;
    ``tile_device`` maps every tile onto its device; ``proj_device[j]``
    is where tiled projection ``j`` executes (its target tile's device);
    ``halo`` lists every block whose source and target tiles sit on
    different devices.
    """

    n_devices: int
    groups: Tuple[Tuple[int, ...], ...]
    tile_device: Dict[str, int]
    proj_device: Tuple[int, ...]
    halo: Tuple[HaloEdge, ...]

    @property
    def is_identity(self) -> bool:
        """Single device, nothing to exchange — the CPU CI fallback."""
        return self.n_devices == 1

    def halo_bits_per_step(self) -> int:
        """Total cross-device spike payload per timestep."""
        return sum(h.n_bits for h in self.halo)

    def summary(self) -> dict:
        """The JSON-friendly record ``CompileReport.placement`` keeps."""
        return {
            "n_devices": self.n_devices,
            "tiles_per_device": [
                sum(1 for d in self.tile_device.values() if d == dev)
                for dev in range(self.n_devices)
            ],
            "halo_edges": len(self.halo),
            "halo_bits_per_step": self.halo_bits_per_step(),
        }


def build_device_assignment(
    placement: Placement,
    tiled: TiledNetwork,
    grid: CoreGrid,
    *,
    n_devices: Optional[int] = None,
) -> DeviceAssignment:
    """Fold a core-level placement into device groups + halo plan.

    ``n_devices`` defaults to the number of visible CUDA cards and raises
    when none is visible (pass ``n_devices`` to plan without a card); it
    must not exceed the grid's column count (slabs are at least one
    column wide).
    """
    if n_devices is None:
        n_devices = visible_cards()
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    if n_devices > grid.cols:
        raise ValueError(
            f"{n_devices} devices need {n_devices} column slabs but the "
            f"grid has only {grid.cols} columns"
        )

    # contiguous column slabs: device d owns columns [bounds[d], bounds[d+1])
    bounds = [round(d * grid.cols / n_devices) for d in range(n_devices + 1)]
    col_device = [0] * grid.cols
    for d in range(n_devices):
        for c in range(bounds[d], bounds[d + 1]):
            col_device[c] = d
    groups: Tuple[Tuple[int, ...], ...] = tuple(
        tuple(
            core for core in grid.cores()
            if col_device[grid.coord(core)[1]] == d
        )
        for d in range(n_devices)
    )
    tile_device = {
        tile: col_device[grid.coord(core)[1]]
        for tile, core in placement.assignment.items()
    }

    net = tiled.network
    proj_device = tuple(
        tile_device[post] for _, post in net.endpoints
    )
    halo = tuple(
        HaloEdge(
            projection=j,
            pre=pre,
            post=post,
            src_device=tile_device[pre],
            dst_device=tile_device[post],
            n_bits=tiled.tile_slices[pre].size,
        )
        for j, (pre, post) in enumerate(net.endpoints)
        if tile_device[pre] != tile_device[post]
    )
    return DeviceAssignment(
        n_devices=n_devices,
        groups=groups,
        tile_device=tile_device,
        proj_device=proj_device,
        halo=halo,
    )
