"""Serving metrics — per-request latency, throughput, bucketing efficiency.

Every completed request contributes one :class:`RequestRecord`; every
*shed* request (deadline expired before admission) contributes one
:class:`ShedRecord`; every *failed* request (quarantined by the launch
supervisor after retries, path degradation, and bisection all failed)
contributes one :class:`FailedRecord`.  The :class:`ServingMetrics`
aggregate answers the
questions the north star cares about: how long does a user wait (queue +
execution latency percentiles, overall and **per priority class**), how
often do deadlines fail (shed rate + served-late rate = deadline-miss
rate), how much useful work flows (request-steps/s over the busy
window), and how well the bucketing policy amortizes compilation
(bucket-hit rate, padding overhead, per-model counters).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    """Timing of one served request through queue -> scheduler -> pool."""

    request_id: int
    steps: int                  # true timesteps
    n_in: int
    bucket_steps: int           # padded timesteps it ran at
    batch_occupancy: int        # live requests in its micro-batch
    t_enqueue: float
    t_dispatch: float           # micro-batch handed to the pool
    t_complete: float           # device done (block_until_ready passed)
    model: str = "default"
    priority: int = 0
    deadline_ms: Optional[float] = None

    @property
    def queue_wait_s(self) -> float:
        return self.t_dispatch - self.t_enqueue

    @property
    def latency_s(self) -> float:
        return self.t_complete - self.t_enqueue

    @property
    def deadline_missed(self) -> bool:
        """Served, but after its deadline (False when no deadline)."""
        if self.deadline_ms is None:
            return False
        return self.latency_s * 1e3 > self.deadline_ms


@dataclasses.dataclass
class ShedRecord:
    """One request shed (expired before admission) — never silently dropped."""

    request_id: int
    model: str
    priority: int
    deadline_ms: float
    waited_ms: float            # how long it sat in the queue before shedding


@dataclasses.dataclass
class FailedRecord:
    """One request quarantined by the launch supervisor.

    Field-compatible with :class:`repro_torch.serving.supervisor.FailedReply`
    so the engine converts with ``FailedRecord(**asdict(reply))`` —
    the same pattern :class:`ShedRecord` shares with ``ShedReply``.
    """

    request_id: int
    model: str
    priority: int
    fault_kind: str
    attempts: int
    message: str = ""


class ServingMetrics:
    """Aggregates request records plus pool counters into one summary.

    Totals are cumulative counters; per-request records live in a bounded
    window (``max_records``) so a long-running engine cannot grow without
    bound — percentiles, miss rates, and throughput describe the recent
    window.
    """

    def __init__(self, max_records: int = 65536):
        self.records: deque = deque(maxlen=max_records)
        self.shed_records: deque = deque(maxlen=max_records)
        self.failed_records: deque = deque(maxlen=max_records)
        self.batches_dispatched = 0
        self.total_requests = 0
        self.total_request_steps = 0
        self.total_shed = 0
        self.total_failed = 0
        #: Launches of under-full buckets forced by the scheduler's
        #: partial-bucket age-out (``max_wait_ms``) — how often padding
        #: waste was spent to bound queue wait.
        self.total_ageout_launches = 0

    def record_batch(self, records: List[RequestRecord]) -> None:
        self.batches_dispatched += 1
        self.total_requests += len(records)
        self.total_request_steps += sum(r.steps for r in records)
        self.records.extend(records)

    def record_ageout(self) -> None:
        self.total_ageout_launches += 1

    def record_shed(self, record: ShedRecord) -> None:
        self.total_shed += 1
        self.shed_records.append(record)

    def record_failed(self, record: FailedRecord) -> None:
        self.total_failed += 1
        self.failed_records.append(record)

    # -- aggregates ----------------------------------------------------------
    @property
    def n_requests(self) -> int:
        return self.total_requests

    @staticmethod
    def _percentiles(records) -> Dict[str, float]:
        if not records:
            return {"p50_ms": 0.0, "p95_ms": 0.0, "max_ms": 0.0}
        lat = np.array([r.latency_s for r in records]) * 1e3
        return {
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "max_ms": float(lat.max()),
        }

    def latency_percentiles(self) -> Dict[str, float]:
        return self._percentiles(self.records)

    def latency_by_priority(self) -> Dict[int, Dict[str, float]]:
        """p50/p95/max latency split per priority class (served requests)."""
        by_class: Dict[int, list] = {}
        for r in self.records:
            by_class.setdefault(r.priority, []).append(r)
        return {
            p: {**self._percentiles(rs), "requests": len(rs)}
            for p, rs in sorted(by_class.items())
        }

    def deadline_miss_rate(self) -> Optional[float]:
        """(shed + served-late) / requests-with-deadline in the window."""
        with_deadline = [r for r in self.records if r.deadline_ms is not None]
        total = len(with_deadline) + len(self.shed_records)
        if total == 0:
            return None
        missed = sum(r.deadline_missed for r in with_deadline)
        return (missed + len(self.shed_records)) / total

    def throughput_request_steps_per_s(self) -> Optional[float]:
        """True (unpadded) request-steps per second over the busy window."""
        if not self.records:
            return None
        t0 = min(r.t_dispatch for r in self.records)
        t1 = max(r.t_complete for r in self.records)
        if t1 <= t0:
            return None
        return sum(r.steps for r in self.records) / (t1 - t0)

    def padding_overhead(self) -> Optional[float]:
        """Padded-steps / true-steps ratio; 1.0 means zero padding waste."""
        real = sum(r.steps for r in self.records)
        padded = sum(r.bucket_steps for r in self.records)
        return padded / real if real else None

    def snapshot(
        self,
        *,
        bucket_hits: int = 0,
        bucket_misses: int = 0,
        relowerings: int = 0,
        by_model: Optional[Dict] = None,
        supervisor: Optional[Dict] = None,
    ) -> Dict:
        """One flat summary dict of everything above.

        Keys: ``requests``, ``shed``, ``failed``, ``batches``,
        ``ageout_launches``,
        ``mean_batch_occupancy``, ``mean_queue_wait_ms``, ``p50_ms`` /
        ``p95_ms`` / ``max_ms`` (overall), ``latency_by_priority``
        (per-class percentiles), ``deadline_miss_rate`` (None when no
        request carried a deadline), ``throughput_request_steps_per_s``,
        ``padding_overhead``, bucket hit/miss counters (+ optional
        ``by_model`` breakdown), ``relowerings``, and — when the engine
        passes its launch supervisor's stats — a ``supervisor`` sub-dict
        (retries, stalls, validation failures, degraded launches,
        quarantines, breaker states).
        """
        total = bucket_hits + bucket_misses
        out = {
            "requests": self.n_requests,
            "shed": self.total_shed,
            "failed": self.total_failed,
            "batches": self.batches_dispatched,
            "ageout_launches": self.total_ageout_launches,
            "mean_batch_occupancy": (
                float(np.mean([r.batch_occupancy for r in self.records]))
                if self.records else 0.0
            ),
            "mean_queue_wait_ms": (
                float(np.mean([r.queue_wait_s for r in self.records])) * 1e3
                if self.records else 0.0
            ),
            **self.latency_percentiles(),
            "latency_by_priority": self.latency_by_priority(),
            "deadline_miss_rate": self.deadline_miss_rate(),
            "throughput_request_steps_per_s":
                self.throughput_request_steps_per_s(),
            "padding_overhead": self.padding_overhead(),
            "bucket_hits": bucket_hits,
            "bucket_misses": bucket_misses,
            "bucket_hit_rate": bucket_hits / total if total else None,
            "relowerings": relowerings,
        }
        if by_model is not None:
            out["by_model"] = by_model
        if supervisor is not None:
            out["supervisor"] = supervisor
        return out
