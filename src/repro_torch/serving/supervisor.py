"""Launch supervisor — the resilience layer between engine and pool.

Before this layer, one exception anywhere in a fused-scan launch unwound
the whole serving loop and stranded every queued request.  The
supervisor turns launch failures into *bounded, accounted-for events*:

1. **Watchdog** — every launch is timed; a launch exceeding
   ``watchdog_s`` is treated as stalled, its (possibly correct) result
   discarded and the launch retried.  Launch wall-times also feed a
   :class:`~repro_torch.distributed.fault_tolerance.StragglerDetector` keyed
   per ``(model, bucket)``, and every completed launch beats the
   :class:`~repro_torch.distributed.fault_tolerance.HeartbeatRegistry` — the
   same liveness machinery the distributed layer ships, wired to the
   serving loop's real signals.
2. **Retry with exponential backoff** — transient faults (a flaky
   lowering, a one-off device hiccup, an injected transient) are
   absorbed by re-launching under a
   :class:`~repro_torch.distributed.fault_tolerance.RestartPolicy`.
3. **Degradation ladder** — a launch that keeps failing on its routed
   path falls to the alternate launch path (batched -> fused or
   vice-versa; the two are bit-identical by the differential harness),
   and, if every path fails, to **bisection**: the batch is split until
   the poison request is isolated, healthy subsets are served from
   sub-launches at the *same* bucket shape (still warm), and the poison
   request alone receives a typed :class:`FailedReply` — every request
   always gets exactly one reply.
4. **Circuit breakers** — per ``(model, bucket, path)``: after
   ``breaker_threshold`` consecutive path failures the breaker opens and
   traffic routes straight to the surviving path (no doomed attempts in
   the hot loop); after ``breaker_cooldown_s`` it half-opens and the
   next launch is the probe that closes it (success) or re-opens it
   (failure).
5. **Output validation** — launches self-check on the device: the
   executor reduces every output train to one "all entries exactly 0/1"
   flag (:attr:`~repro_torch.core.runtime.NetworkExecutable.last_check`)
   that the launch never reads back, so fault-free validation costs one
   flag read instead of a host-side pass over the data.  When a fault injector is installed (its corruption lands on
   host copies the device flag cannot see) the reference
   :func:`repro_torch.core.runtime.validate_spike_outputs` pass runs
   instead.  Either way a corrupted result is a retryable *fault*,
   never a served reply.

Retried and degraded successes are bit-identical to fault-free solo
runs: every rung re-executes the same lowered programs through launch
paths the differential harness pins together, and bisection re-packs
subsets at the same bucket shape with the same step-count masking.

All of it is visible: :meth:`LaunchSupervisor.stats` reports retries,
stalls, validation failures, degraded launches, bisections, quarantines,
breaker states/trips/probes, straggler flags, and heartbeat ages —
surfaced through ``ServingEngine.stats()['supervisor']``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.runtime import OutputValidationError, validate_spike_outputs
from ..distributed.fault_tolerance import (
    HeartbeatRegistry,
    RestartPolicy,
    StragglerDetector,
)
from .pool import host_arrays
from .queue import SNNRequest
from .scheduler import BucketKey, MicroBatch, pad_microbatch


@dataclasses.dataclass
class FailedReply:
    """Delivered in place of a result when a request could not be served.

    The sibling of :class:`~repro_torch.serving.engine.ShedReply` for
    *execution* failure: the supervisor exhausted retries, both launch
    paths, and bisection, and this request was isolated as the one that
    cannot run (the poison request), or the failure was batch-wide and
    persistent.  Arrives through the same channel a result would have —
    the sync results dict or the async future — never a silent drop.
    Check with ``isinstance(reply, FailedReply)``.
    """

    request_id: int
    model: str
    priority: int
    fault_kind: str             # last observed fault class for this request
    attempts: int               # launch attempts spent on its final isolation
    message: str = ""

    def __bool__(self) -> bool:        # a failure reply is a non-result
        return False


class CircuitBreaker:
    """One breaker: closed (normal) -> open (tripped) -> half-open (probe).

    ``record_failure`` counts *consecutive* failures; at ``threshold``
    the breaker opens and :meth:`allow` refuses traffic until
    ``cooldown_s`` has passed, when the next :meth:`allow` becomes the
    half-open probe.  A probe success closes the breaker; a probe
    failure re-opens it (and restarts the cooldown).
    """

    def __init__(
        self,
        threshold: int = 3,
        cooldown_s: float = 0.25,
        clock=time.monotonic,
    ):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1; got {threshold}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.state = "closed"
        self.failures = 0           # consecutive failures while closed
        self.opened_at: Optional[float] = None
        self.trips = 0
        self.probes = 0

    def allow(self) -> bool:
        if self.state == "closed":
            return True
        if self.clock() - self.opened_at >= self.cooldown_s:
            self.state = "half_open"
            self.probes += 1
            return True
        return False

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self.opened_at = None

    def record_failure(self) -> None:
        if self.state == "half_open":
            self.state = "open"                # failed probe: re-open
            self.opened_at = self.clock()
            return
        self.failures += 1
        if self.state == "closed" and self.failures >= self.threshold:
            self.state = "open"
            self.opened_at = self.clock()
            self.failures = 0
            self.trips += 1


#: What the supervisor returns per request: trimmed per-layer trains or
#: a typed failure.
SupervisedReply = Union[List[np.ndarray], FailedReply]


class LaunchSupervisor:
    """Wraps every pool launch in watchdog/retry/degrade/quarantine logic.

    ``policy`` drives retry count and exponential backoff (default: 2
    retries, 2 ms base backoff — transient faults clear in single-digit
    milliseconds; pass a
    :class:`~repro_torch.distributed.fault_tolerance.RestartPolicy` to tune).
    ``watchdog_s=None`` disables stall detection.  ``clock`` is
    injectable for deterministic breaker tests.
    """

    #: Heartbeat host ids: 0 = the launch path (beaten per completed
    #: launch), 1 = the continuous serving loop (beaten per iteration).
    LAUNCH_HOST = 0
    LOOP_HOST = 1

    def __init__(
        self,
        pool,
        *,
        policy: Optional[RestartPolicy] = None,
        watchdog_s: Optional[float] = None,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 0.25,
        validate: bool = True,
        heartbeat_timeout_s: float = 60.0,
        straggler_threshold: float = 3.0,
        clock=time.monotonic,
    ):
        self.pool = pool
        self.policy = policy or RestartPolicy(max_retries=2, backoff_s=0.002)
        self.watchdog_s = watchdog_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.validate = validate
        self.clock = clock
        self.heartbeats = HeartbeatRegistry(timeout_s=heartbeat_timeout_s)
        self.stragglers = StragglerDetector(threshold=straggler_threshold)
        self._breakers: Dict[Tuple[str, Tuple[int, int, int], str],
                             CircuitBreaker] = {}
        self._straggler_ids: Dict[Tuple[str, Tuple[int, int, int]], int] = {}
        self._output_sizes: Dict[str, Tuple[int, ...]] = {}
        self.counters = {
            "launch_attempts": 0,
            "retries": 0,
            "watchdog_stalls": 0,
            "validation_failures": 0,
            "degraded_launches": 0,
            "breaker_skips": 0,
            "bisections": 0,
            "quarantined": 0,
            "straggler_flags": 0,
        }

    # -- liveness ------------------------------------------------------------
    def beat_loop(self) -> None:
        """Heartbeat from the continuous serving loop (one per iteration)."""
        self.heartbeats.beat(self.LOOP_HOST, self.clock())

    def _breaker(
        self, model: str, key: BucketKey, path: str
    ) -> CircuitBreaker:
        bkey = (model, key.shape, path)
        br = self._breakers.get(bkey)
        if br is None:
            br = CircuitBreaker(
                self.breaker_threshold, self.breaker_cooldown_s, self.clock
            )
            self._breakers[bkey] = br
        return br

    def _straggler_id(self, mb: MicroBatch) -> int:
        skey = (mb.model, mb.key.shape)
        sid = self._straggler_ids.get(skey)
        if sid is None:
            sid = len(self._straggler_ids)
            self._straggler_ids[skey] = sid
        return sid

    def _expected_sizes(self, model: str) -> Tuple[int, ...]:
        sizes = self._output_sizes.get(model)
        if sizes is None:
            sizes = self.pool.peek(model).output_sizes
            self._output_sizes[model] = sizes
        return sizes

    # -- the supervised launch ----------------------------------------------
    def run(self, mb: MicroBatch) -> Dict[int, SupervisedReply]:
        """Run one micro-batch to completion; every request gets a reply.

        Tries the pool's routed path first (with retries), then the
        alternate path, honoring the circuit breakers; if both fail (or
        are open), bisects the batch to serve every healthy request and
        quarantine the poison one(s) with :class:`FailedReply`.
        """
        default = (
            self.pool.full_bucket_path
            if len(mb.requests) == mb.key.batch
            else "fused"
        )
        ladder = [default] + [
            p for p in ("fused", "batched") if p != default
        ]
        for rank, path in enumerate(ladder):
            breaker = self._breaker(mb.model, mb.key, path)
            if not breaker.allow():
                self.counters["breaker_skips"] += 1
                continue
            host_outs, fault, _ = self._attempt_with_retries(mb, path)
            if fault is None:
                breaker.record_success()
                if rank > 0:
                    self.counters["degraded_launches"] += 1
                return self._replies(mb.requests, host_outs)
            breaker.record_failure()
        # every path refused or persistently failing — isolate per request
        # (bisection is below the breakers on purpose: it is the last
        # resort that guarantees each request an individual verdict)
        self.counters["bisections"] += 1
        reqs = list(mb.requests)
        if len(reqs) == 1:
            return self._bisect(mb, reqs)
        mid = len(reqs) // 2
        replies = self._bisect(mb, reqs[:mid])
        replies.update(self._bisect(mb, reqs[mid:]))
        return replies

    def _bisect(
        self, mb: MicroBatch, reqs: List[SNNRequest]
    ) -> Dict[int, SupervisedReply]:
        """Serve a failing batch's subset, splitting until the poison
        request is isolated and quarantined.

        Sub-batches re-pad at the parent's bucket shape (warm jit
        entries, empty-slot masking) on the fused path; a singleton that
        still fails after retries is the poison request and gets a
        :class:`FailedReply`.
        """
        sub = pad_microbatch(mb.key, reqs, mb.model)
        host_outs, fault, attempts = self._attempt_with_retries(sub, "fused")
        if fault is None:
            return self._replies(reqs, host_outs)
        if len(reqs) == 1:
            self.counters["quarantined"] += 1
            req = reqs[0]
            return {
                req.request_id: FailedReply(
                    request_id=req.request_id,
                    model=mb.model,
                    priority=req.priority,
                    fault_kind=fault,
                    attempts=attempts,
                    message=(
                        f"quarantined after {attempts} isolated attempts "
                        f"(last fault: {fault})"
                    ),
                )
            }
        mid = len(reqs) // 2
        replies = self._bisect(mb, reqs[:mid])
        replies.update(self._bisect(mb, reqs[mid:]))
        return replies

    def _outputs_valid(self, mb: MicroBatch, host_outs) -> bool:
        """Post-launch output validation, cheap on the fault-free path.

        Launches self-check on the device: the executor reduces every
        output train to one "all entries exactly 0/1" flag
        (``pool.last_launch_check``).  When that flag is available and
        nothing can have touched the outputs between device and
        supervisor — i.e. no fault injector is installed; the injector
        corrupts *host copies*, which the device-side flag cannot see —
        consuming the flag is the validation: shape and dtype are
        guaranteed by the executor.  Otherwise (an injector is present, or a stub
        pool without a flag) the reference host-side
        :func:`validate_spike_outputs` pass runs on the materialized
        arrays.
        """
        check = getattr(self.pool, "last_launch_check", None)
        if check is not None and getattr(
            self.pool, "fault_injector", None
        ) is None:
            # one read of the device flag (a CUDA tensor has no NumPy view)
            return bool(check.item())
        try:
            validate_spike_outputs(
                host_outs,
                steps=mb.key.steps,
                batch=mb.key.batch,
                sizes=self._expected_sizes(mb.model),
            )
        except OutputValidationError:
            return False
        return True

    def _attempt_with_retries(self, mb: MicroBatch, path: str):
        """One launch with the retry policy; returns
        ``(host_outs | None, fault_kind | None, attempts)``."""
        attempt = 0
        while True:
            self.counters["launch_attempts"] += 1
            fault, host_outs = None, None
            t0 = self.clock()
            try:
                outs = self.pool.run_microbatch(mb, path=path, block=True)
            except Exception as exc:       # any launch failure is a fault
                fault = getattr(exc, "kind", "error")
            else:
                elapsed = self.clock() - t0
                # the device answered: that is the liveness signal the
                # heartbeat registry tracks, and the wall-time sample the
                # straggler detector smooths per (model, bucket)
                self.heartbeats.beat(self.LAUNCH_HOST, self.clock())
                sid = self._straggler_id(mb)
                self.stragglers.record(sid, elapsed)
                if sid in self.stragglers.stragglers():
                    self.counters["straggler_flags"] += 1
                if self.watchdog_s is not None and elapsed > self.watchdog_s:
                    # stalled launch: the result may even be correct, but
                    # a launch this late cannot be trusted (nor waited on
                    # in the real preemptive case) — discard and retry
                    fault = "stall"
                    self.counters["watchdog_stalls"] += 1
                else:
                    host_outs = host_arrays(outs)
                    if self.validate and not self._outputs_valid(
                        mb, host_outs
                    ):
                        fault = "validation"
                        self.counters["validation_failures"] += 1
                        host_outs = None
            if fault is None:
                return host_outs, None, attempt + 1
            if not self.policy.should_restart(attempt):
                return None, fault, attempt + 1
            time.sleep(self.policy.next_delay(attempt))
            attempt += 1
            self.counters["retries"] += 1

    @staticmethod
    def _replies(
        requests: List[SNNRequest], host_outs: List[np.ndarray]
    ) -> Dict[int, SupervisedReply]:
        """Trim the padded launch outputs to every request's true shape."""
        return {
            req.request_id: [z[: req.steps, b] for z in host_outs]
            for b, req in enumerate(requests)
        }

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict:
        """Counters, breaker states, straggler flags, heartbeat ages."""
        now = self.clock()
        label = {v: k for k, v in self._straggler_ids.items()}
        return {
            **self.counters,
            "breakers": {
                f"{model}|{'x'.join(map(str, shape))}|{path}": br.state
                for (model, shape, path), br in self._breakers.items()
            },
            "breaker_trips": sum(b.trips for b in self._breakers.values()),
            "breaker_probes": sum(b.probes for b in self._breakers.values()),
            "open_breakers": sum(
                b.state == "open" for b in self._breakers.values()
            ),
            "stragglers": [
                f"{m}|{'x'.join(map(str, s))}"
                for m, s in (label[i] for i in self.stragglers.stragglers())
            ],
            "launch_heartbeat_age_s": self.heartbeats.age(
                self.LAUNCH_HOST, now
            ),
            "loop_heartbeat_age_s": self.heartbeats.age(self.LOOP_HOST, now),
            "dead_hosts": self.heartbeats.dead_hosts(now),
        }
