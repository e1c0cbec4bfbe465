"""Fault tolerance: heartbeats, straggler detection, restart policy, elastic re-mesh.

On thousands of nodes three failure classes dominate; each has a handler:

1. **Hard node failure** — a host stops heartbeating.  The coordinator
   declares the step epoch dead, all survivors restart from the latest
   checkpoint (``CheckpointManager`` + ``RestartPolicy``).  Elastic restore
   re-shards the manifest onto the surviving mesh (``plan_elastic_mesh``).
2. **Stragglers** — a host heartbeats but its step time drifts.  The
   ``StragglerDetector`` keeps an EMA per host and flags hosts beyond
   ``threshold`` x the fleet median so the scheduler can evict/replace
   them before they serialize the collective.
3. **Transient collective timeouts** — retried ``max_retries`` times with
   exponential backoff before escalating to (1).

This module is deliberately runtime-agnostic (pure bookkeeping + planning)
so it unit-tests on one host; the launchers wire it to real signals.

Two consumers exist today: the training-style ``FaultTolerantDriver``
below, and the serving stack's launch supervisor
(:class:`repro_torch.serving.supervisor.LaunchSupervisor`), which beats the
:class:`HeartbeatRegistry` from the continuous-serving loop and every
completed launch, feeds per-``(model, bucket)`` launch wall-times into
the :class:`StragglerDetector` as its launch-stall signal, and drives
its retry backoff from :class:`RestartPolicy`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    step_time_ema: Optional[float] = None
    steps: int = 0


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.hosts: Dict[int, HostState] = {}

    def beat(self, host_id: int, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        st = self.hosts.get(host_id)
        if st is None:
            self.hosts[host_id] = HostState(host_id, now)
        else:
            st.last_heartbeat = now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [
            h for h, st in self.hosts.items()
            if now - st.last_heartbeat > self.timeout_s
        ]

    def age(
        self, host_id: int, now: Optional[float] = None
    ) -> Optional[float]:
        """Seconds since ``host_id`` last beat; ``None`` if never seen."""
        st = self.hosts.get(host_id)
        if st is None:
            return None
        now = time.monotonic() if now is None else now
        return now - st.last_heartbeat


class StragglerDetector:
    """Flags hosts whose step time exceeds threshold x fleet median."""

    def __init__(self, threshold: float = 1.5, ema: float = 0.9):
        self.threshold = threshold
        self.ema = ema
        self.times: Dict[int, float] = {}

    def record(self, host_id: int, step_seconds: float) -> None:
        prev = self.times.get(host_id)
        self.times[host_id] = (
            step_seconds if prev is None
            else self.ema * prev + (1 - self.ema) * step_seconds
        )

    def stragglers(self) -> List[int]:
        if len(self.times) < 2:
            return []
        vals = sorted(self.times.values())
        median = vals[len(vals) // 2]
        return [
            h for h, t in self.times.items() if t > self.threshold * median
        ]


@dataclasses.dataclass
class RestartPolicy:
    max_retries: int = 3
    backoff_s: float = 5.0

    def next_delay(self, attempt: int) -> float:
        return self.backoff_s * (2 ** attempt)

    def should_restart(self, attempt: int) -> bool:
        return attempt < self.max_retries


def plan_elastic_mesh(
    n_healthy_chips: int,
    *,
    model_parallel: int,
    pods_preferred: int = 2,
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest mesh expressible with the surviving chips.

    Keeps the model axis intact (parameters must still fit), shrinks the
    data axis, and drops the pod axis when fewer than 2 pods survive.
    Raises if even one model-parallel group cannot be formed.
    """
    if n_healthy_chips < model_parallel:
        raise RuntimeError(
            f"only {n_healthy_chips} chips healthy; "
            f"cannot form one model-parallel group of {model_parallel}"
        )
    groups = n_healthy_chips // model_parallel
    if pods_preferred > 1 and groups % pods_preferred == 0 and groups >= 2 * pods_preferred:
        return (
            (pods_preferred, groups // pods_preferred, model_parallel),
            ("pod", "data", "model"),
        )
    return ((groups, model_parallel), ("data", "model"))


class FaultTolerantDriver:
    """Glue: heartbeat + straggler + checkpoint-restart around a step fn.

    ``run`` executes ``steps`` iterations of ``step_fn(state) -> state``,
    checkpointing every ``ckpt_every``; a simulated/injected failure raises
    ``HostFailure`` which triggers restore + retry under the policy.
    """

    def __init__(self, manager, policy: RestartPolicy | None = None,
                 ckpt_every: int = 50):
        self.manager = manager
        self.policy = policy or RestartPolicy()
        self.ckpt_every = ckpt_every

    def run(self, state, step_fn, steps: int, *, start_step: int = 0):
        step = start_step
        attempt = 0
        while step < steps:
            try:
                state = step_fn(state, step)
                step += 1
                attempt = 0
                if step % self.ckpt_every == 0:
                    self.manager.save(step, state)
            except HostFailure:
                if not self.policy.should_restart(attempt):
                    raise
                attempt += 1
                self.manager.wait()
                latest = self.manager.latest_step()
                if latest is not None:
                    state = self.manager.restore(state, latest)
                    step = latest
        self.manager.save(steps, state, blocking=True)
        self.manager.wait()
        return state


class HostFailure(RuntimeError):
    pass
