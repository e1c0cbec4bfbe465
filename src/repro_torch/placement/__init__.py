"""Placement engine: tiling + core-grid mapping + device partitioning.

The paper's toolchain step between the application graph and the
paradigm runtimes: split oversized populations into per-core tiles
(:mod:`.tiling`), search a core-grid assignment minimizing NoC cut
traffic (:mod:`.mapper` over :mod:`.grid`), and fold the result into the
device groups the sharded executor consumes (:mod:`.partition`).
"""
from .grid import CoreGrid
from .mapper import (
    LinearMapping,
    Placement,
    PlacementError,
    check_activity_budgets,
    estimate_traffic,
    greedy_place,
    measured_rates,
    noc_cost,
    place_network,
    refine,
    round_robin_place,
)
from .partition import DeviceAssignment, HaloEdge, build_device_assignment
from .tiling import TiledNetwork, TileSlice, tile_network

__all__ = [
    "CoreGrid",
    "DeviceAssignment",
    "HaloEdge",
    "LinearMapping",
    "Placement",
    "PlacementError",
    "TileSlice",
    "TiledNetwork",
    "build_device_assignment",
    "check_activity_budgets",
    "estimate_traffic",
    "greedy_place",
    "measured_rates",
    "noc_cost",
    "place_network",
    "refine",
    "round_robin_place",
    "tile_network",
]
