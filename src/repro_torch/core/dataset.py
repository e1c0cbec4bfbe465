"""Dataset acquisition — paper §IV-A, exactly.

16,000 randomly generated SNN layers:

* source / target neurons: 50..500, step 50   (10 values each)
* weight density:          10%..100%, step 10% (10 values)
* delay range:             1..16, step 1       (16 values)

10 x 10 x 10 x 16 = 16,000.  For each layer we *run both compilers* (the
serial count is cost-model analytic, the parallel count requires compiling
the optimized weight-delay-map — "can't be accurately estimated") and label
it with the paradigm needing fewer PEs.  Ties go to serial (lower energy on
the ARM path; the paper does not specify — DESIGN.md §2).

Features exposed to the classifiers are ONLY the four layer characters —
prejudging must work before any compilation.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np

from .hw import SpiNNaker2Config, DEFAULT_S2
from .layer import random_layer
from .parallel_compiler import OptFlags, parallel_pe_count_exact
from .serial_compiler import serial_pe_count_exact

SOURCE_GRID = tuple(range(50, 501, 50))
TARGET_GRID = tuple(range(50, 501, 50))
DENSITY_GRID = tuple(d / 10.0 for d in range(1, 11))
DELAY_GRID = tuple(range(1, 17))

# Beyond-paper extension (EXPERIMENTS.md §Beyond): the paper's own gesture
# showcase (2048 sources @ 3.16% density) lies OUTSIDE its dataset grid, and
# the grid-trained classifier misjudges exactly that regime.  The extended
# grid adds large-source / very-sparse / tiny-target cells.
EXT_SOURCE_GRID = SOURCE_GRID + (1024, 2048)
EXT_TARGET_GRID = (10, 20) + TARGET_GRID
EXT_DENSITY_GRID = (0.01, 0.03, 0.05) + DENSITY_GRID
EXT_DELAY_GRID = (1, 2, 4, 8, 12, 16)

LABEL_SERIAL = 0
LABEL_PARALLEL = 1


@dataclasses.dataclass
class ParadigmDataset:
    """features: (N, 4) [n_source, n_target, density, delay_range];
    serial_pes / parallel_pes: (N,); labels: (N,) 0=serial 1=parallel."""

    features: np.ndarray
    serial_pes: np.ndarray
    parallel_pes: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.labels)

    def split(self, test_fraction: float = 0.2, *, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self))
        n_test = int(len(self) * test_fraction)
        te, tr = idx[:n_test], idx[n_test:]
        return (
            (self.features[tr], self.labels[tr]),
            (self.features[te], self.labels[te]),
        )

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path,
            features=self.features,
            serial_pes=self.serial_pes,
            parallel_pes=self.parallel_pes,
            labels=self.labels,
        )

    @staticmethod
    def load(path: str) -> "ParadigmDataset":
        z = np.load(path)
        return ParadigmDataset(
            z["features"], z["serial_pes"], z["parallel_pes"], z["labels"]
        )


def generate_dataset(
    *,
    hw: SpiNNaker2Config = DEFAULT_S2,
    opts: OptFlags = OptFlags(),
    seed: int = 2024,
    source_grid=SOURCE_GRID,
    target_grid=TARGET_GRID,
    density_grid=DENSITY_GRID,
    delay_grid=DELAY_GRID,
    progress: bool = False,
) -> ParadigmDataset:
    feats, s_pes, p_pes = [], [], []
    t0 = time.time()
    i = 0
    n_total = len(source_grid) * len(target_grid) * len(density_grid) * len(delay_grid)
    for ns in source_grid:
        for nt in target_grid:
            for dens in density_grid:
                for dr in delay_grid:
                    layer = random_layer(ns, nt, dens, dr, seed=seed + i)
                    s = serial_pe_count_exact(layer, hw=hw)
                    p = parallel_pe_count_exact(layer, hw=hw, opts=opts)
                    feats.append([ns, nt, dens, dr])
                    s_pes.append(s)
                    p_pes.append(p)
                    i += 1
                    if progress and i % 1000 == 0:
                        rate = i / (time.time() - t0)
                        print(
                            f"  dataset {i}/{n_total} "
                            f"({rate:.0f} layers/s, eta {(n_total-i)/rate:.0f}s)",
                            flush=True,
                        )
    features = np.asarray(feats, dtype=np.float64)
    serial_pes = np.asarray(s_pes, dtype=np.int64)
    parallel_pes = np.asarray(p_pes, dtype=np.int64)
    labels = np.where(parallel_pes < serial_pes, LABEL_PARALLEL, LABEL_SERIAL)
    return ParadigmDataset(features, serial_pes, parallel_pes, labels)


_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(__file__)))),
    "benchmarks", "data", "paradigm_dataset.npz",
)


def load_or_generate(
    path: Optional[str] = None, *, progress: bool = True, extended: bool = False,
    **kwargs
) -> ParadigmDataset:
    """Cached 16k dataset (generation takes ~1-2 min; cached under benchmarks/data).

    ``extended=True`` loads/generates the beyond-paper grid (large-source /
    very-sparse / tiny-target cells included)."""
    if extended:
        path = path or _DEFAULT_CACHE.replace(".npz", "_extended.npz")
        kwargs.setdefault("source_grid", EXT_SOURCE_GRID)
        kwargs.setdefault("target_grid", EXT_TARGET_GRID)
        kwargs.setdefault("density_grid", EXT_DENSITY_GRID)
        kwargs.setdefault("delay_grid", EXT_DELAY_GRID)
    path = path or _DEFAULT_CACHE
    if os.path.exists(path):
        return ParadigmDataset.load(path)
    ds = generate_dataset(progress=progress, **kwargs)
    ds.save(path)
    return ds
