"""Shape-bucketing scheduler — variable requests into fixed-shape batches.

The pool keeps one warm entry per input *shape* (the reference compiles
one program per shape, and a captured CUDA graph is per shape too);
unconstrained request shapes would make every request a cold launch.
The scheduler maps every request onto a small closed set of padded
shapes:

* **steps** round up to the next power of two (floored at
  ``min_bucket_steps``) — at most ~log2(T_max) step buckets ever exist,
  and padding waste is bounded by 2x.
* **n_in** pads up to the target model's input width — extra channels
  carry zero spikes, i.e. silent source neurons that contribute nothing.
* **batch** always pads up to the fixed micro-batch width — partial
  batches fill the tail with empty slots (``valid_steps == 0``) instead
  of introducing a second batch dimension per occupancy.

Two batching modes share this policy:

* **Wave** (:meth:`ShapeBucketingScheduler.form_microbatches`) — group an
  already-popped request list into padded micro-batches in one shot; the
  engine's ``drain()`` path.
* **Continuous** (:meth:`~ShapeBucketingScheduler.admit` /
  :meth:`~ShapeBucketingScheduler.pop_launchable`) — slot-level
  admission: requests join *open* in-flight buckets keyed by
  ``(model, bucket shape)``; between two scan launches the engine admits
  whatever arrived, then closes and launches the most urgent bucket.  A
  request never waits for a full drain wave — at most one launch
  separates its arrival from its admission.

With ``max_wait_ms`` set, an under-full bucket is **held open** (not
launchable) until either it fills or its oldest member has waited
``max_wait_ms`` — the partial-bucket age-out: padding waste is spent only
when the wait budget is exhausted.  ``max_wait_ms=None`` (default)
preserves the launch-immediately behavior.  Age-out launches are flagged
on the :class:`MicroBatch` and counted by ``ServingMetrics``.

Padded timesteps and empty slots are made *inert* (exact-zero outputs,
bit-identical live prefix) by the executor's step-count mask
(:meth:`repro_torch.core.runtime.NetworkExecutable.run_device`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .queue import DEFAULT_MODEL, SNNRequest


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """The padded device shape one micro-batch runs at."""

    steps: int    # padded timestep count (power of two)
    n_in: int     # model input width
    batch: int    # micro-batch width

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.steps, self.batch, self.n_in)


@dataclasses.dataclass
class MicroBatch:
    """A bucketed, padded group of requests ready for one fused scan."""

    key: BucketKey
    requests: List[SNNRequest]             # <= key.batch, admission order
    spikes: np.ndarray                     # key.shape f32, zero-padded
    valid_steps: np.ndarray                # (key.batch,) i32; 0 = empty slot
    model: str = DEFAULT_MODEL             # routing key into the pool
    #: True when this launch was forced by the partial-bucket age-out
    #: (oldest member waited ``max_wait_ms`` before the bucket filled).
    aged_out: bool = False

    @property
    def real_request_steps(self) -> int:
        return int(sum(r.steps for r in self.requests))

    @property
    def padded_request_steps(self) -> int:
        return self.key.steps * self.key.batch


@dataclasses.dataclass
class OpenBucket:
    """A partially-filled in-flight bucket still accepting admissions."""

    model: str
    key: BucketKey
    requests: List[SNNRequest] = dataclasses.field(default_factory=list)

    @property
    def free_slots(self) -> int:
        return self.key.batch - len(self.requests)

    def oldest_enqueue(self) -> float:
        """Enqueue stamp of the longest-waiting member (age-out clock)."""
        return min(r.t_enqueue for r in self.requests)

    def urgency(self):
        """Launch-order key: most urgent member decides for the bucket.

        Full buckets launch before partial ones, then highest priority /
        earliest deadline / oldest arrival.  Occupancy leads on purpose:
        letting an urgent singleton preempt full buckets pays its empty
        slots out of throughput, and under backlog that costs *every*
        class more latency than it saves (measured in
        ``bench_serving.py``: preemptive launches blow overall p95 up
        ~4x at 75% load).  Urgent requests still win — continuous
        admission means they wait at most the current backlog of full
        buckets, never a whole drain wave, and they head every partial
        launch.  A max-age override for pathological overload is future
        work (see ROADMAP).
        """
        return (
            self.free_slots > 0,                            # full first
            min(r.sort_key() for r in self.requests),       # priority/EDF/age
        )


class ShapeBucketingScheduler:
    """Groups pending requests into padded fixed-shape micro-batches.

    ``n_input`` is the input width of the default model; additional
    models register their widths via :meth:`set_model_input` so each
    model's requests pad to *its* input width (the bucket key separates
    models with different widths automatically; same-width models are
    still kept apart by the micro-batch's ``model`` routing tag).
    """

    def __init__(
        self,
        n_input: int,
        *,
        micro_batch: int = 8,
        min_bucket_steps: int = 8,
        max_wait_ms: Optional[float] = None,
    ):
        if micro_batch < 1 or min_bucket_steps < 1:
            raise ValueError("micro_batch and min_bucket_steps must be >= 1")
        if max_wait_ms is not None and max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0; got {max_wait_ms}")
        self.n_input = n_input
        self.micro_batch = micro_batch
        self.min_bucket_steps = min_bucket_steps
        #: Partial-bucket age-out budget: an under-full open bucket only
        #: becomes launchable once its oldest request has waited this long
        #: (``None`` = launch partial buckets immediately, the pre-age-out
        #: behavior).  Full buckets always launch.
        self.max_wait_ms = max_wait_ms
        self._model_inputs: Dict[str, int] = {DEFAULT_MODEL: n_input}
        #: Open in-flight buckets, keyed (model, BucketKey) — the
        #: continuous-batching admission state.
        self._open: Dict[Tuple[str, BucketKey], OpenBucket] = {}
        #: Buckets that filled up before launch (admission rolled over to
        #: a fresh bucket); launched ahead of partial buckets.
        self._full: List[OpenBucket] = []

    # -- shape policy --------------------------------------------------------
    def set_model_input(self, model: str, n_input: int) -> None:
        """Register (or update) the input width requests to ``model`` pad to."""
        if n_input < 1:
            raise ValueError(f"n_input must be >= 1; got {n_input}")
        self._model_inputs[model] = n_input

    def model_input(self, model: str) -> int:
        """The padded input width for ``model`` (default model's if unknown)."""
        return self._model_inputs.get(model, self.n_input)

    def bucket_steps(self, steps: int) -> int:
        return max(self.min_bucket_steps, next_pow2(steps))

    def bucket_for(self, request: SNNRequest) -> BucketKey:
        width = self.model_input(request.model)
        if request.n_in > width:
            raise ValueError(
                f"request {request.request_id} has n_in {request.n_in} > "
                f"model {request.model!r} input {width}"
            )
        return BucketKey(
            steps=self.bucket_steps(request.steps),
            n_in=width,
            batch=self.micro_batch,
        )

    # -- wave mode -----------------------------------------------------------
    def form_microbatches(
        self, requests: List[SNNRequest]
    ) -> List[MicroBatch]:
        """Bucket, chunk, and pad; preserves the given (dispatch) order
        within each ``(model, bucket)`` group."""
        by_bucket: Dict[Tuple[str, BucketKey], List[SNNRequest]] = {}
        for req in requests:
            by_bucket.setdefault(
                (req.model, self.bucket_for(req)), []
            ).append(req)
        batches = []
        for (model, key), reqs in by_bucket.items():
            for i in range(0, len(reqs), key.batch):
                batches.append(
                    self._pad(key, reqs[i : i + key.batch], model)
                )
        return batches

    # -- continuous mode: slot-level admission --------------------------------
    def admit(self, request: SNNRequest) -> OpenBucket:
        """Join a compatible open in-flight bucket (opening one if needed).

        The request occupies a free slot immediately; the bucket stays
        open for further admissions until :meth:`pop_launchable` closes
        it for launch.  Full buckets roll over: a request arriving at a
        full open bucket opens the next one for the same shape.
        """
        key = self.bucket_for(request)
        bucket = self._open.get((request.model, key))
        if bucket is None:
            bucket = OpenBucket(model=request.model, key=key)
            self._open[(request.model, key)] = bucket
        bucket.requests.append(request)
        if bucket.free_slots == 0:          # roll over: park it for launch
            self._full.append(self._open.pop((request.model, key)))
        return bucket

    def _aged(self, bucket: OpenBucket, now: float) -> bool:
        return (
            self.max_wait_ms is not None
            and (now - bucket.oldest_enqueue()) * 1e3 >= self.max_wait_ms
        )

    def _launchable(self, bucket: OpenBucket, now: float) -> bool:
        """Full, aged out, or holding a member whose deadline cannot
        survive the hold.

        A member whose ``deadline_at`` lands before the bucket's age-out
        instant must not wait out the budget — holding it guarantees the
        miss the deadline machinery exists to avoid, so its bucket is
        launchable immediately (the EDF urgency key then orders it).
        """
        if bucket.free_slots == 0 or self._aged(bucket, now):
            return True
        ageout_at = bucket.oldest_enqueue() + self.max_wait_ms / 1e3
        return any(r.deadline_at <= ageout_at for r in bucket.requests)

    def pop_launchable(
        self, now: Optional[float] = None, *, force: bool = False
    ) -> Optional[MicroBatch]:
        """Close and pad the most urgent *launchable* bucket; None when idle.

        Full buckets launch first (occupancy is throughput — see
        :meth:`OpenBucket.urgency` for why this beats priority
        preemption even for the urgent class), then the partial bucket
        whose most urgent member has the highest priority / earliest
        deadline / oldest arrival.

        With ``max_wait_ms`` set, a partial bucket is only launchable
        once its oldest member has waited that long (the age-out); until
        then it stays open, accumulating admissions.  Two escapes bound
        the hold: a member whose deadline lands before the bucket's
        age-out instant makes it launchable immediately (holding would
        guarantee the miss), and ``force=True`` ignores the wait budget
        entirely — the wave-mode ``drain()`` flush, which must empty the
        backlog.  An age-out launch is flagged ``MicroBatch.aged_out``.
        """
        now = time.perf_counter() if now is None else now
        candidates = [*self._full, *self._open.values()]
        if self.max_wait_ms is not None and not force:
            candidates = [b for b in candidates if self._launchable(b, now)]
        if not candidates:
            return None
        bucket = min(candidates, key=OpenBucket.urgency)
        if any(b is bucket for b in self._full):
            self._full = [b for b in self._full if b is not bucket]
        else:
            self._open.pop((bucket.model, bucket.key))
        mb = self._pad(bucket.key, bucket.requests, bucket.model)
        mb.aged_out = bucket.free_slots > 0 and self._aged(bucket, now)
        return mb

    def open_requests(self) -> int:
        """Requests currently admitted but not yet launched."""
        return sum(
            len(b.requests)
            for b in (*self._open.values(), *self._full)
        )

    def has_open(self) -> bool:
        return bool(self._open or self._full)

    # -- padding -------------------------------------------------------------
    def _pad(
        self,
        key: BucketKey,
        requests: List[SNNRequest],
        model: str = DEFAULT_MODEL,
    ) -> MicroBatch:
        return pad_microbatch(key, requests, model)


def pad_microbatch(
    key: BucketKey,
    requests: List[SNNRequest],
    model: str = DEFAULT_MODEL,
) -> MicroBatch:
    """Pad ``requests`` into one launchable micro-batch at ``key``'s shape.

    Shared by the scheduler's bucket-closing paths and the launch
    supervisor's recovery paths (bisection re-packs a failing batch's
    subsets at the *same* bucket shape, so recovery launches stay warm
    bucket hits instead of fresh compiles).
    """
    spikes = np.zeros(key.shape, np.float32)
    valid = np.zeros(key.batch, np.int32)
    for b, req in enumerate(requests):
        spikes[: req.steps, b, : req.n_in] = req.spikes
        valid[b] = req.steps
    return MicroBatch(
        key=key, requests=requests, spikes=spikes, valid_steps=valid,
        model=model,
    )
