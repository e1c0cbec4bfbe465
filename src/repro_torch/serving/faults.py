"""Deterministic fault injection for the serving stack.

SpiNNaker-class platforms are engineered around the assumption that
individual cores, links, and launches fail routinely (arXiv 1911.02385
budgets for per-core failures across 10M cores); a serving stack that
claims the same scale needs a way to *manufacture* those failures on
demand, reproducibly, so the recovery machinery is testable instead of
aspirational.  This module is that substrate: a seedable
:class:`FaultInjector` that the :class:`~repro_torch.serving.pool.ExecutablePool`
consults around every launch, armed with a plan of :class:`FaultSpec`
entries that make specific launches fail in specific ways.

Fault taxonomy (``FAULT_KINDS``):

* ``"lowering"`` — the launch raises :class:`LoweringFault` before any
  device work, simulating a lowering/compile failure for the bucket.
* ``"device_lost"`` — the launch raises :class:`DeviceLost`, simulating
  the device (or its runtime handle) disappearing mid-flight.
* ``"stall"`` — the launch sleeps ``stall_s`` before proceeding, then
  completes *correctly*; only a watchdog can tell the result arrived too
  late to trust (the supervisor discards it and retries, exactly as a
  real launch-timeout policy must).
* ``"nan_membrane"`` — the launch completes but its output spike trains
  carry a non-finite value (NaN or Inf), the signature of a divergent
  membrane update escaping the kernel.
* ``"nonbinary_spikes"`` — the launch completes but an output entry is
  neither 0 nor 1, the signature of a corrupted spike train.

A spec matches a launch by any combination of model name, launch path,
and the presence of a specific request id in the micro-batch (the
*poison request* pattern — the batch fails whenever that request rides
in it, which is what the supervisor's bisection exists to isolate).
``times`` bounds how many launches a spec affects (transient faults
clear after ``times`` injections); ``times=None`` is persistent.  At
most one armed spec fires per launch per hook, in arming order, so a
plan's effect is deterministic given the launch sequence.

Corruption positions are drawn from the injector's own seeded generator,
so a fault plan replayed with the same seed corrupts the same entries.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from .pool import host_arrays

#: Every fault kind the injector can arm.
FAULT_KINDS = (
    "lowering", "device_lost", "stall", "nan_membrane", "nonbinary_spikes"
)
#: Kinds that raise before the launch reaches the device.
RAISE_KINDS = ("lowering", "device_lost")
#: Kinds that let the launch complete, then corrupt its outputs.
CORRUPT_KINDS = ("nan_membrane", "nonbinary_spikes")


class InjectedFault(RuntimeError):
    """Base class of all injected launch failures (``.kind`` names it)."""

    kind = "injected"


class LoweringFault(InjectedFault):
    """Injected lowering/compile failure — raised before device work."""

    kind = "lowering"


class DeviceLost(InjectedFault):
    """Injected device loss — the launch's device handle went away."""

    kind = "device_lost"


_RAISES = {"lowering": LoweringFault, "device_lost": DeviceLost}


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: what goes wrong, and which launches it hits.

    ``model`` / ``path`` / ``request_id`` are match filters (``None``
    matches anything): a spec fires on a launch when every non-``None``
    filter matches — ``request_id`` matches when that request rides in
    the launched micro-batch.  ``times`` is how many launches the spec
    affects before it exhausts (``None`` = persistent).  ``stall_s``
    only applies to ``kind="stall"``.
    """

    kind: str
    model: Optional[str] = None
    path: Optional[str] = None           # "batched" | "fused" | None = any
    request_id: Optional[int] = None
    times: Optional[int] = 1
    stall_s: float = 0.3

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; have {FAULT_KINDS}"
            )
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1 or None; got {self.times}")

    def matches(self, micro_batch, path: str) -> bool:
        if self.model is not None and micro_batch.model != self.model:
            return False
        if self.path is not None and path != self.path:
            return False
        if self.request_id is not None and self.request_id not in [
            r.request_id for r in micro_batch.requests
        ]:
            return False
        return True


@dataclasses.dataclass
class _Armed:
    spec: FaultSpec
    left: Optional[int]          # remaining injections; None = persistent

    @property
    def exhausted(self) -> bool:
        return self.left == 0

    def consume(self) -> FaultSpec:
        if self.left is not None:
            self.left -= 1
        return self.spec


class FaultInjector:
    """Seedable fault plan, consulted by the pool around every launch.

    ``before_launch`` fires raise/stall kinds; ``after_launch`` fires
    corruption kinds on the completed outputs.  Each fired injection is
    tallied in :attr:`injected` so tests can assert the plan actually
    executed.  The injector is pure bookkeeping plus a seeded generator —
    given the same plan, seed, and launch sequence, it injects the same
    faults at the same positions.
    """

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self._armed: List[_Armed] = []
        self.injected = {k: 0 for k in FAULT_KINDS}

    # -- plan management -----------------------------------------------------
    def arm(self, spec: FaultSpec | str, **kwargs) -> FaultSpec:
        """Arm one fault; ``spec`` may be a kind name plus field kwargs."""
        if isinstance(spec, str):
            spec = FaultSpec(kind=spec, **kwargs)
        elif kwargs:
            raise TypeError("kwargs only apply when arming by kind name")
        self._armed.append(_Armed(spec, spec.times))
        return spec

    def arm_plan(self, specs: Sequence[FaultSpec]) -> None:
        for spec in specs:
            self.arm(spec)

    def disarm_all(self) -> None:
        """Clear the whole plan (the chaos harness's 'storm over' switch)."""
        self._armed.clear()

    def armed(self) -> int:
        """Armed specs with injections remaining."""
        return sum(1 for a in self._armed if not a.exhausted)

    def total_injected(self) -> int:
        return sum(self.injected.values())

    def _take(self, micro_batch, path: str, kinds) -> Optional[FaultSpec]:
        for armed in self._armed:
            if (
                not armed.exhausted
                and armed.spec.kind in kinds
                and armed.spec.matches(micro_batch, path)
            ):
                return armed.consume()
        return None

    # -- pool hooks ----------------------------------------------------------
    def before_launch(self, micro_batch, path: str) -> None:
        """Raise or stall if an armed pre-launch fault matches this launch."""
        spec = self._take(
            micro_batch, path, RAISE_KINDS + ("stall",)
        )
        if spec is None:
            return
        self.injected[spec.kind] += 1
        if spec.kind == "stall":
            time.sleep(spec.stall_s)
            return
        raise _RAISES[spec.kind](
            f"injected {spec.kind} on model {micro_batch.model!r} "
            f"bucket {micro_batch.key.shape} path {path!r}"
        )

    def after_launch(self, outs, micro_batch, path: str):
        """Corrupt completed outputs if an armed corruption fault matches.

        Returns host *copies* of the launch outputs with the corruption
        applied — the device/cache buffers are never mutated, so a retry
        of the same launch produces clean results.
        """
        spec = self._take(micro_batch, path, CORRUPT_KINDS)
        if spec is None:
            return outs
        self.injected[spec.kind] += 1
        host = [np.array(a) for a in host_arrays(outs)]
        layer = int(self.rng.integers(len(host)))
        arr = host[layer]
        pos = tuple(int(self.rng.integers(d)) for d in arr.shape)
        if spec.kind == "nan_membrane":
            arr[pos] = np.nan if self.rng.random() < 0.5 else np.inf
        else:
            arr[pos] = 2.0
        return host
