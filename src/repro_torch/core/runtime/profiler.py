"""Activity profiler: per-population spike counts from real runs.

SpiNNCer's headline analysis — and the signal the placement engine needs
— is *where the spikes actually are*: per-population, per-timestep spike
counts and the multicast traffic each projection puts on the NoC.  The
profiler derives all of it from trains a run already produced (the
external input plus the executor's per-projection outputs), so profiling
adds **zero** cost to the launch itself — it is a numpy pass over
arrays the caller already holds.

Two entry points:

* :func:`profile_outputs` — pure function from recorded trains to an
  :class:`ActivityProfile`;
* :func:`profile_run` — launch-and-profile wrapper around
  :meth:`NetworkExecutable.run` that also attaches the profile to the
  report (``CompileReport.activity``), so downstream consumers (the
  placement benchmark, activity-budget checks) find it where the other
  launch records live.

The profile's :meth:`ActivityProfile.rates` dict plugs straight into
:func:`repro_torch.placement.mapper.estimate_traffic` and
:func:`repro_torch.placement.mapper.check_activity_budgets`, closing the loop
from measured activity to tile budgets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["ActivityProfile", "profile_outputs", "profile_run"]


@dataclasses.dataclass
class ActivityProfile:
    """Measured spike activity of one recorded run.

    Counts are exact integer sums over the recorded trains (spikes are
    0/1 floats, so float64 summation is exact): ``pop_counts[name][t]``
    is the number of spikes population ``name`` emitted at timestep
    ``t``, summed over the batch.  Input populations are counted from
    their slice of the external train; every other population from the
    train of one of its in-projections (all in-projections of a
    population share the target's train, so any one of them is the
    population's output).
    """

    steps: int
    batch: int
    pop_sizes: Dict[str, int]
    #: population -> (T,) spike counts per timestep (batch-summed)
    pop_counts: Dict[str, np.ndarray]
    #: projection name -> mean source spikes per timestep per batch lane
    #: (each firing source neuron puts one multicast packet on the NoC)
    proj_traffic: Dict[str, float]
    #: population -> full ``(T, B, n)`` 0/1 spike raster, kept only when
    #: the profile was built with ``record_rasters=True``; ``None``
    #: otherwise, so the default profile costs no train-sized memory
    #: beyond what the caller already held.
    rasters: Dict[str, np.ndarray] = None

    def rates(self) -> Dict[str, float]:
        """Population -> mean spikes per neuron per timestep.

        The measured-activity dict
        :func:`repro_torch.placement.mapper.estimate_traffic` weighs cut edges
        by.
        """
        denom = float(self.steps * self.batch)
        return {
            name: float(c.sum()) / (denom * self.pop_sizes[name])
            if denom and self.pop_sizes[name] else 0.0
            for name, c in self.pop_counts.items()
        }

    def peak(self, name: str) -> Tuple[int, int]:
        """``(timestep, count)`` of population ``name``'s busiest step."""
        c = self.pop_counts[name]
        t = int(np.argmax(c))
        return t, int(c[t])

    def total(self, name: str) -> int:
        """Total spikes population ``name`` emitted across the run."""
        return int(self.pop_counts[name].sum())

    def isi_histogram(self, name: str) -> np.ndarray:
        """Inter-spike-interval histogram of population ``name``.

        Returns ``hist`` with ``hist[d]`` = number of consecutive spike
        pairs ``d`` timesteps apart, pooled over every (batch lane,
        neuron) pair; ``hist[0]`` is always 0 (a neuron spikes at most
        once per step).  SpiNNCer's regularity analysis reads straight
        off this: a ``count``-mode population driven at a constant rate
        shows one dominant interval, an irregular one a spread.

        Requires a raster (``record_rasters=True`` at profiling time).
        """
        if self.rasters is None or name not in self.rasters:
            raise ValueError(
                f"no raster recorded for population {name!r} — profile "
                "with record_rasters=True"
            )
        z = self.rasters[name]
        t, b, n = np.nonzero(np.asarray(z) != 0)
        hist = np.zeros(self.steps, dtype=np.int64)
        if t.size < 2:
            return hist
        # order spike events by (lane, neuron, time); diffs within a
        # (lane, neuron) group are the ISIs
        order = np.lexsort((t, n, b))
        tb, bb, nb = t[order], b[order], n[order]
        same = (bb[1:] == bb[:-1]) & (nb[1:] == nb[:-1])
        isi = (tb[1:] - tb[:-1])[same]
        np.add.at(hist, isi, 1)
        return hist

    def as_dict(self) -> dict:
        """JSON-ready summary (rates, peaks, traffic) for benchmarks."""
        return {
            "steps": self.steps,
            "batch": self.batch,
            "rates": self.rates(),
            "peaks": {
                name: {"t": self.peak(name)[0], "count": self.peak(name)[1]}
                for name in self.pop_counts
            },
            "proj_traffic": dict(self.proj_traffic),
        }


def profile_outputs(
    net, spikes: np.ndarray, outs: Sequence, *, record_rasters: bool = False
) -> ActivityProfile:
    """Build an :class:`ActivityProfile` from recorded trains.

    ``spikes`` is the external train ``(T, B, n_input)`` (multi-input
    nets: the concatenated train, sliced per ``net.input_slices``);
    ``outs`` the per-projection output trains of the same run (entry i =
    projection i's target-population train, the
    :meth:`NetworkExecutable.run` return shape).  Use full-batch
    unmasked trains — padded slots would count as silence.

    ``record_rasters=True`` additionally keeps each population's full
    ``(T, B, n)`` train on the profile (:attr:`ActivityProfile.rasters`),
    enabling :meth:`ActivityProfile.isi_histogram`; off by default so
    the profile's memory footprint is unchanged.
    """
    spikes = np.asarray(spikes)
    T, B, n_in = spikes.shape
    if n_in != net.n_input:
        raise ValueError(
            f"spikes must be (T, B, {net.n_input}); got {spikes.shape}"
        )
    pop_sizes = {p.name: p.size for p in net.populations}
    pop_counts: Dict[str, np.ndarray] = {}
    for p, (a, b) in zip(net.input_populations, net.input_slices):
        pop_counts[p.name] = spikes[:, :, a:b].sum(axis=(1, 2))
    pop_trains: Dict[str, np.ndarray] = {}
    for (_, post), z in zip(net.endpoints, outs):
        pop_trains.setdefault(post, np.asarray(z))
    for name, z in pop_trains.items():
        pop_counts[name] = z.sum(axis=(1, 2))
    missing = [p.name for p in net.populations if p.name not in pop_counts]
    if missing:
        raise ValueError(
            f"populations {missing} have neither an input slice nor an "
            "in-projection train — cannot profile"
        )
    proj_traffic = {
        e.name: float(pop_counts[pre].sum()) / float(T * B) if T * B else 0.0
        for e, (pre, _) in zip(net.projections, net.endpoints)
    }
    rasters = None
    if record_rasters:
        rasters = {}
        for p, (a, b) in zip(net.input_populations, net.input_slices):
            rasters[p.name] = spikes[:, :, a:b]
        rasters.update(pop_trains)
    return ActivityProfile(
        steps=T,
        batch=B,
        pop_sizes=pop_sizes,
        pop_counts=pop_counts,
        proj_traffic=proj_traffic,
        rasters=rasters,
    )


def profile_run(
    net, report, spikes: np.ndarray, *, record_rasters: bool = False,
    device=None, **run_kwargs
) -> Tuple[List[np.ndarray], ActivityProfile]:
    """Run the fused executor and profile the trains it produced.

    Launches through :func:`network_executable`'s cached handle (so
    profiling reuses the report's lowered executable), converts the
    outputs to numpy once, builds the profile, and attaches it as
    ``report.activity``.  Returns ``(outs, profile)``; the outs are the
    same per-projection trains a plain ``run`` would give.
    ``record_rasters=True`` keeps the full per-population spike rasters
    on the profile (ISI analysis); default off — profiling memory is
    then unchanged from previous releases.  ``device`` is the launch's
    device: ``None`` is the CUDA card (raising when none is visible),
    ``"cpu"`` the kernels' plain versions.
    """
    from .executor import network_executable

    exe = network_executable(net, report, device=device)
    outs = [np.asarray(z) for z in exe.run(np.asarray(spikes), **run_kwargs)]
    profile = profile_outputs(
        net, spikes, outs, record_rasters=record_rasters
    )
    report.activity = profile
    return outs, profile
