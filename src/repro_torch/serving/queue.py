"""Request queue — the front door of the serving subsystem.

A request is one spike train for one user: a ``(steps, n_in)`` 0/1 array
(kept as uint8, the width every copy of it moves at) with its own length and input width (``n_in`` may be narrower than the
target model's input; missing channels are silent neurons).  Each request
carries its routing and urgency metadata — ``model`` (which registered
model serves it), ``priority`` (higher dispatches first), and
``deadline_ms`` (how long past enqueue the reply is still useful).

The queue is a thread-safe **priority queue**: requests pop in
``(priority desc, deadline asc, arrival asc)`` order, so a later
high-priority request overtakes earlier bulk traffic and, within a
priority class, the request closest to its deadline goes first
(earliest-deadline-first).  All *shape* policy (bucketing, padding,
micro-batching) lives in :mod:`repro_torch.serving.scheduler`; all *shedding*
policy (what happens to an expired request) lives in
:mod:`repro_torch.serving.engine` — the queue only orders and hands out.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import List, Optional

import numpy as np

DEFAULT_MODEL = "default"

#: Sort key stand-in for "no deadline" — later than any real deadline.
_NO_DEADLINE = float("inf")


class QueueFull(RuntimeError):
    """Raised by :meth:`RequestQueue.submit` when ``max_pending`` is reached."""


@dataclasses.dataclass
class SNNRequest:
    """One pending spike-train inference request.

    Fields:

    * ``request_id`` — unique per queue, monotonically increasing.
    * ``spikes`` — the ``(steps, n_in)`` 0/1 uint8 input train.
    * ``t_enqueue`` — ``time.perf_counter()`` stamp at submit; latency and
      deadline accounting are measured from here.
    * ``model`` — name of the registered model that must serve this
      request (multi-model routing key; defaults to ``"default"``).
    * ``priority`` — integer class, **higher is more urgent** (default 0).
      Dispatch order is priority-descending; metrics are reported per
      priority class.
    * ``deadline_ms`` — optional budget in milliseconds from enqueue.  A
      request whose deadline passes before it is admitted is *shed* (the
      caller receives a :class:`~repro_torch.serving.engine.ShedReply`, never a
      silent drop); one that expires mid-flight is served and counted as
      a deadline miss.
    """

    request_id: int
    spikes: np.ndarray          # (steps, n_in) 0/1 uint8
    t_enqueue: float            # perf_counter stamp at submit
    model: str = DEFAULT_MODEL
    priority: int = 0
    deadline_ms: Optional[float] = None

    @property
    def steps(self) -> int:
        return self.spikes.shape[0]

    @property
    def n_in(self) -> int:
        return self.spikes.shape[1]

    @property
    def deadline_at(self) -> float:
        """Absolute perf_counter time the reply stops being useful."""
        if self.deadline_ms is None:
            return _NO_DEADLINE
        return self.t_enqueue + self.deadline_ms / 1e3

    def expired(self, now: Optional[float] = None) -> bool:
        """Has the deadline already passed (False when no deadline)?"""
        if self.deadline_ms is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline_at

    def sort_key(self):
        """Heap key: priority desc, deadline asc, arrival asc."""
        return (-self.priority, self.deadline_at, self.request_id)


#: Backwards-compatible alias (pre-multi-tenant name).
InferenceRequest = SNNRequest


class RequestQueue:
    """Thread-safe priority queue of :class:`SNNRequest`.

    Pop order is ``(priority desc, deadline asc, arrival asc)`` — FIFO
    within a priority class when no deadlines are set, so the pre-priority
    behavior is unchanged for plain traffic.
    """

    def __init__(self, max_pending: Optional[int] = None):
        self.max_pending = max_pending
        self._heap: List = []           # (sort_key, SNNRequest)
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._ids = itertools.count()

    def submit(
        self,
        spikes: np.ndarray,
        *,
        model: str = DEFAULT_MODEL,
        priority: int = 0,
        deadline_ms: Optional[float] = None,
    ) -> SNNRequest:
        """Validate, wrap, and enqueue one spike train; returns the request.

        Rejects malformed payloads at the front door with a clear
        ``ValueError`` — wrong rank, non-numeric dtype, non-finite
        values (NaN/Inf), or non-binary entries — so garbage never
        reaches a compiled launch, where it would surface as an opaque
        device-side failure (or a quarantine) batches later.  The train
        is kept as a uint8 copy: a bool or integer one is checked by its
        extremes, a float one as float32 entry by entry (which tells a
        non-finite value from a non-binary one).
        """
        raw = np.asarray(spikes)
        if raw.dtype == object or raw.dtype.kind not in "bifu":
            raise ValueError(
                f"request spikes must be numeric 0/1; got dtype {raw.dtype}"
            )
        if raw.ndim != 2 or raw.shape[0] < 1 or raw.shape[1] < 1:
            raise ValueError(
                f"request spikes must be (steps, n_in); got {raw.shape}"
            )
        if raw.dtype.kind == "f":
            wide = raw.astype(np.float32)
            bad = ~((wide == 0.0) | (wide == 1.0))
            if bad.any():
                n_bad = int(bad.sum())
                if not np.isfinite(wide).all():
                    raise ValueError(
                        f"request spikes contain non-finite values "
                        f"({n_bad} bad entries); trains must be 0/1"
                    )
                raise ValueError(
                    f"request spikes must be binary 0/1; "
                    f"{n_bad} entries are neither"
                )
        elif raw.dtype.kind != "b" and (
            raw.max() > 1 or (raw.dtype.kind == "i" and raw.min() < 0)
        ):
            n_bad = int(((raw != 0) & (raw != 1)).sum())
            raise ValueError(
                f"request spikes must be binary 0/1; "
                f"{n_bad} entries are neither"
            )
        spikes = raw.astype(np.uint8)
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0; got {deadline_ms}")
        req = SNNRequest(
            request_id=next(self._ids),
            spikes=spikes,
            t_enqueue=time.perf_counter(),
            model=model,
            priority=int(priority),
            deadline_ms=deadline_ms,
        )
        with self._lock:
            if (
                self.max_pending is not None
                and len(self._heap) >= self.max_pending
            ):
                raise QueueFull(
                    f"{len(self._heap)} pending >= max_pending "
                    f"{self.max_pending}"
                )
            heapq.heappush(self._heap, (req.sort_key(), req))
            self._nonempty.notify_all()
        return req

    def pop_all(self) -> List[SNNRequest]:
        """Drain every pending request in dispatch (priority) order."""
        with self._lock:
            heap, self._heap = self._heap, []
        return [req for _, req in sorted(heap)]

    def pop_batch(
        self, max_n: int, timeout: Optional[float] = None
    ) -> List[SNNRequest]:
        """Up to ``max_n`` requests in dispatch order; blocks up to
        ``timeout`` for the first."""
        with self._lock:
            if not self._heap and timeout:
                self._nonempty.wait(timeout)
            taken = [
                heapq.heappop(self._heap)[1]
                for _ in range(min(max_n, len(self._heap)))
            ]
            return taken

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def empty(self) -> bool:
        return len(self) == 0
