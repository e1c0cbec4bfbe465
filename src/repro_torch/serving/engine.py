"""ServingEngine — the facade tying queue, scheduler, pool, and metrics.

Synchronous wave path (batch drivers, benchmarks)::

    engine = ServingEngine(net, report)
    rid = engine.submit(spikes)            # (steps, n_in) single request
    results = engine.drain()               # {rid: [per-layer (steps, n_l)]}

Continuous-batching path (live traffic)::

    engine.register_model(net_b, report_b, "b", warm_steps=[16, 32])
    rid = engine.submit(spikes, model="b", priority=2, deadline_ms=50.0)
    engine.step_continuous()               # admit arrivals, launch ONE batch

    async with background serve loop (continuous admission):
        out = await engine.submit_async(spikes)   # resolves when served

``drain`` is **wave draining**: it takes everything pending in one gulp,
forms all micro-batches, and runs them back-to-back — a request arriving
mid-wave waits for the entire wave.  ``step_continuous`` is **continuous
batching**: between any two scan launches it admits newly arrived
requests into compatible open in-flight buckets and launches only the
most urgent bucket, so admission latency is bounded by one launch, not
one wave.  ``serve_forever`` runs the continuous loop by default.

Expired requests (deadline passed before admission) are *shed*: the
caller receives a :class:`ShedReply` through the same channel a result
would have used — the sync results dict or the async future — never a
silent drop.  Results come back trimmed to every request's true
``(steps, n_layer)`` shape, bit-identical to running that request alone
(the executor's step-count mask keeps padding inert).

**Every submit gets exactly one reply**, of exactly one type: the
result, a :class:`ShedReply` (expired unserved), a
:class:`~repro_torch.serving.supervisor.FailedReply` (quarantined by the
launch supervisor after retries, path degradation, and bisection all
failed), or a :class:`ShutdownReply` (the engine stopped first).  Every
launch runs under the :class:`~repro_torch.serving.supervisor.LaunchSupervisor`
— watchdog, retry with backoff, batched<->fused degradation behind
per-``(model, bucket, path)`` circuit breakers, poison-request
bisection, and output validation; see :mod:`repro_torch.serving.supervisor`
and ``docs/robustness.md``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Union

import numpy as np

from .. import trace
from ..core.layer import SNNNetwork
from ..core.switching import CompileReport
from ..distributed.fault_tolerance import RestartPolicy
from .metrics import FailedRecord, RequestRecord, ServingMetrics, ShedRecord
from .pool import ExecutablePool, PoolEntry, UnknownModel
from .queue import DEFAULT_MODEL, RequestQueue, SNNRequest
from .scheduler import BucketKey, MicroBatch, ShapeBucketingScheduler
from .supervisor import FailedReply, LaunchSupervisor

#: A served result: per-layer spike trains [(steps, n_l) ...], true length.
RequestResult = List[np.ndarray]


@dataclasses.dataclass
class ShedReply:
    """Delivered in place of a result when a request expired unserved.

    Arrives wherever the result would have: the dict ``drain`` /
    ``step_continuous`` returns (and ``engine.results``) on the sync
    path, or the resolved future on the async path.  Check with
    ``isinstance(reply, ShedReply)``.
    """

    request_id: int
    model: str
    priority: int
    deadline_ms: float
    waited_ms: float            # queue time it had already spent when shed

    def __bool__(self) -> bool:        # a shed reply is a non-result
        return False


@dataclasses.dataclass
class ShutdownReply:
    """Delivered to async waiters still pending when the engine stops.

    :meth:`ServingEngine.stop` resolves every registered future with one
    of these instead of leaving the waiter hanging forever — the
    exactly-one-reply guarantee holds through shutdown.  Check with
    ``isinstance(reply, ShutdownReply)``.
    """

    request_id: int
    message: str = "engine stopped before this request was served"

    def __bool__(self) -> bool:        # a shutdown reply is a non-result
        return False


#: What one request gets back: its spike trains, a shed notice, a
#: supervisor quarantine notice, or a shutdown notice.
Reply = Union[RequestResult, ShedReply, FailedReply, ShutdownReply]


class ServingEngine:
    """Batched SNN inference serving over one or more compiled models.

    The constructor registers ``net``/``report`` as the ``"default"``
    model; :meth:`register_model` adds more.  Models may be arbitrary
    application graphs (recurrent edges included) — the engine only
    needs each model's input-population width.  ``max_models`` caps how
    many models keep live (lowered + jitted) executables — beyond it the
    least-recently-used model is evicted and revives cold on its next
    request (see :class:`~repro_torch.serving.pool.ExecutablePool`).
    ``max_wait_ms`` bounds how long a request may sit in an under-full
    continuous-mode bucket before the scheduler launches it partial (the
    age-out; ``None`` launches partial buckets immediately; members with
    deadlines tighter than the hold escape it immediately).  Age-out
    launches are counted in ``stats()['ageout_launches']``.  ``device``
    is where every model runs: ``None`` means the CUDA card (and raises
    when none is visible), ``"cpu"`` the kernels' plain versions.
    """

    def __init__(
        self,
        net: SNNNetwork,
        report: CompileReport,
        *,
        micro_batch: int = 8,
        min_bucket_steps: int = 8,
        max_pending: Optional[int] = None,
        max_retained_results: int = 4096,
        max_models: Optional[int] = None,
        device=None,
        full_bucket_path: str = "batched",
        max_wait_ms: Optional[float] = None,
        fault_injector=None,
        watchdog_s: Optional[float] = None,
        max_launch_retries: int = 2,
        retry_backoff_s: float = 0.002,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 0.25,
        validate_outputs: bool = True,
    ):
        self.queue = RequestQueue(max_pending=max_pending)
        self.scheduler = ShapeBucketingScheduler(
            net.n_input,
            micro_batch=micro_batch,
            min_bucket_steps=min_bucket_steps,
            max_wait_ms=max_wait_ms,
        )
        self.pool = ExecutablePool(
            device=device, max_models=max_models,
            full_bucket_path=full_bucket_path,
            fault_injector=fault_injector,
        )
        self.pool.register(net, report)
        self.metrics = ServingMetrics()
        #: Resilience layer every launch runs under — watchdog, retries,
        #: path degradation behind circuit breakers, bisection,
        #: output validation (``watchdog_s=None`` disables the watchdog,
        #: ``validate_outputs=False`` the validation guard).
        self.supervisor = LaunchSupervisor(
            self.pool,
            policy=RestartPolicy(
                max_retries=max_launch_retries, backoff_s=retry_backoff_s
            ),
            watchdog_s=watchdog_s,
            breaker_threshold=breaker_threshold,
            breaker_cooldown_s=breaker_cooldown_s,
            validate=validate_outputs,
        )
        #: Sync-path replies, oldest evicted beyond ``max_retained_results``
        #: (async replies are delivered through their futures, not stored).
        self.results: "OrderedDict[int, Reply]" = OrderedDict()
        self.max_retained_results = max_retained_results
        self._futures: Dict[int, asyncio.Future] = {}
        self._running = False

    # -- model registry ------------------------------------------------------
    def register_model(
        self,
        net: SNNNetwork,
        report: CompileReport,
        name: str,
        *,
        warm_steps: Optional[List[int]] = None,
    ) -> PoolEntry:
        """Register a second (third, ...) compiled model under ``name``.

        Requests route to it via ``submit(..., model=name)``.  The model
        pads to *its own* input width, independent of the default
        model's.  ``warm_steps`` optionally pre-compiles the buckets its
        expected traffic lands in (same semantics as :meth:`warmup`).
        """
        self.scheduler.set_model_input(name, net.n_input)
        entry = self.pool.register(net, report, name)
        if warm_steps:
            self.warmup(warm_steps, model=name)
        return entry

    def warmup(
        self, step_counts: List[int], model: str = DEFAULT_MODEL
    ) -> int:
        """Pre-compile the buckets the expected traffic mix lands in.

        ``step_counts`` are *request* step counts; each is rounded to its
        bucket.  Returns the number of bucket shapes newly compiled.
        After warmup, steady-state traffic at those shapes is all bucket
        hits with zero re-lowerings (``engine.stats()['relowerings']``).
        """
        width = self.scheduler.model_input(model)
        buckets = {
            BucketKey(
                steps=self.scheduler.bucket_steps(s),
                n_in=width,
                batch=self.scheduler.micro_batch,
            )
            for s in step_counts
        }
        return self.pool.warmup(
            sorted(buckets, key=lambda k: k.steps), name=model
        )

    # -- submission ----------------------------------------------------------
    def submit(
        self,
        spikes: np.ndarray,
        *,
        model: str = DEFAULT_MODEL,
        priority: int = 0,
        deadline_ms: Optional[float] = None,
    ) -> int:
        """Enqueue one ``(steps, n_in)`` request; returns its request id.

        ``model`` routes to a registered model (raises
        :class:`~repro_torch.serving.pool.UnknownModel`, a ``KeyError``, for
        unknown names), ``priority`` orders dispatch (higher first,
        FIFO within a class), and ``deadline_ms`` bounds how long past
        enqueue the reply is still useful — expired requests are shed
        with a :class:`ShedReply`, requests served late count toward
        ``deadline_miss_rate``.
        """
        with trace.span("engine.submit", model=model) as sp:
            if model not in self.pool.models():
                raise UnknownModel(
                    f"model {model!r} not registered; have {self.pool.models()}"
                )
            width = self.scheduler.model_input(model)
            if np.ndim(spikes) != 2 or np.shape(spikes)[1] > width:
                raise ValueError(
                    f"request must be (steps, n_in <= {width}) for model "
                    f"{model!r}; got {np.shape(spikes)}"
                )
            req = self.queue.submit(
                spikes, model=model, priority=priority, deadline_ms=deadline_ms
            )
            if sp:
                sp.set(request_id=req.request_id, steps=req.steps)
            return req.request_id

    # -- wave path -----------------------------------------------------------
    def drain(self) -> Dict[int, Reply]:
        """Serve everything pending in one wave; returns {request_id: reply}.

        Pops the entire backlog (dispatch order: priority desc, deadline
        asc, arrival asc), sheds already-expired requests, admits the
        rest — topping up any open continuous-mode buckets, so mixing
        the two modes neither strands a request nor launches avoidably
        half-empty scans — and runs every admitted micro-batch
        back-to-back.

        Requests with a waiting ``submit_async`` future are resolved here
        (whoever calls drain), so a sync drain can never strand an async
        waiter.  Only futureless (sync-path) replies are retained in
        ``self.results``, bounded by ``max_retained_results``.
        """
        served: Dict[int, Reply] = {}
        # admit the backlog first so it tops up any open continuous-mode
        # buckets (mixing the modes never launches avoidably half-empty
        # padded scans), then launch everything admitted
        self._admit_pending(served)
        while True:
            # a full drain flushes even buckets still inside their
            # max_wait_ms age-out budget
            mb = self.scheduler.pop_launchable(force=True)
            if mb is None:
                break
            served.update(self._run_microbatch(mb))
        self._deliver(served)
        return served

    # -- continuous path -----------------------------------------------------
    def step_continuous(self) -> Dict[int, Reply]:
        """Admit arrivals into open buckets, launch ONE micro-batch.

        The continuous-batching unit of work: everything pending joins a
        compatible open in-flight bucket (expired requests are shed), the
        most urgent bucket (full first, then priority / earliest
        deadline) is closed and launched, and its replies are delivered.
        Returns the delivered replies — empty dict when nothing was ready
        to launch.
        """
        served: Dict[int, Reply] = {}
        self._admit_pending(served)
        mb = self.scheduler.pop_launchable()
        if mb is not None:
            served.update(self._run_microbatch(mb))
        self._deliver(served)
        return served

    def _admit_pending(self, served: Dict[int, Reply]) -> None:
        pending = self.queue.pop_all()
        if not pending:
            return
        with trace.span("engine.admit"):
            now = time.perf_counter()
            for req in pending:
                if req.expired(now):
                    served[req.request_id] = self._shed(req, now)
                    trace.count("shed")
                else:
                    self.scheduler.admit(req)
                    trace.count("admitted")

    # -- shedding ------------------------------------------------------------
    def _shed(self, req: SNNRequest, now: float) -> ShedReply:
        reply = ShedReply(
            request_id=req.request_id,
            model=req.model,
            priority=req.priority,
            deadline_ms=float(req.deadline_ms),
            waited_ms=(now - req.t_enqueue) * 1e3,
        )
        # same field set by design; asdict keeps the two from drifting
        self.metrics.record_shed(ShedRecord(**dataclasses.asdict(reply)))
        return reply

    # -- delivery ------------------------------------------------------------
    def _deliver(self, served: Dict[int, Reply]) -> None:
        if not served:
            return
        with trace.span("engine.deliver"):
            for rid, reply in served.items():
                fut = self._futures.pop(rid, None)
                if fut is not None:
                    self._resolve_future(fut, reply)
                else:
                    self.results[rid] = reply
            while len(self.results) > self.max_retained_results:
                self.results.popitem(last=False)

    @staticmethod
    def _resolve_future(fut: asyncio.Future, reply: Reply) -> None:
        def _set():
            if not fut.done():
                fut.set_result(reply)

        try:
            # schedules onto the future's own loop; safe from any thread,
            # including the loop thread itself
            fut.get_loop().call_soon_threadsafe(_set)
        except RuntimeError:        # loop already closed; waiter is gone
            pass

    def _run_microbatch(self, mb: MicroBatch) -> Dict[int, Reply]:
        if mb.aged_out:
            self.metrics.record_ageout()
        # every launch runs under the supervisor: watchdog + retries +
        # path degradation behind circuit breakers + bisection +
        # output validation; each request comes back as trimmed trains
        # or a typed FailedReply — never an unwound exception.  The
        # launch's span stamps dispatch and completion whether or not
        # tracing is on; its id is the launch id its inner spans share.
        with trace.timed("engine.launch") as launch:
            if launch:
                launch.set(
                    launch_id=launch.id, model=mb.model, bucket=mb.key.steps,
                    request_ids=[r.request_id for r in mb.requests],
                )
            replies = self.supervisor.run(mb)
        t_dispatch, t_complete = launch.t0 / 1e9, launch.t1 / 1e9
        req_by_id = {req.request_id: req for req in mb.requests}
        records = []
        for rid, reply in replies.items():
            if isinstance(reply, FailedReply):
                # same field set by design; asdict keeps them from drifting
                self.metrics.record_failed(
                    FailedRecord(**dataclasses.asdict(reply))
                )
                continue
            req = req_by_id[rid]
            records.append(
                RequestRecord(
                    request_id=req.request_id,
                    steps=req.steps,
                    n_in=req.n_in,
                    bucket_steps=mb.key.steps,
                    batch_occupancy=len(mb.requests),
                    t_enqueue=req.t_enqueue,
                    t_dispatch=t_dispatch,
                    t_complete=t_complete,
                    model=req.model,
                    priority=req.priority,
                    deadline_ms=req.deadline_ms,
                )
            )
        if records:
            self.metrics.record_batch(records)
        return replies

    # -- asynchronous path ---------------------------------------------------
    async def submit_async(
        self,
        spikes: np.ndarray,
        *,
        model: str = DEFAULT_MODEL,
        priority: int = 0,
        deadline_ms: Optional[float] = None,
    ) -> Reply:
        """Enqueue and await the reply (needs a running ``serve_forever``
        or someone calling ``drain`` / ``step_continuous``).

        Resolves to the request's per-layer spike trains, or to a
        :class:`ShedReply` if its deadline expired before admission.
        """
        fut = asyncio.get_running_loop().create_future()
        # register the future before the request can possibly be drained —
        # submit and this registration run without an intervening await
        rid = self.submit(
            spikes, model=model, priority=priority, deadline_ms=deadline_ms
        )
        self._futures[rid] = fut
        return await fut

    async def serve_forever(
        self, *, poll_interval: float = 0.001, mode: str = "continuous"
    ) -> None:
        """Serve until :meth:`stop`.

        ``mode="continuous"`` (default) admits arrivals between every
        scan launch (:meth:`step_continuous`); ``mode="wave"`` preserves
        the PR-2 behavior of draining the whole backlog per iteration.
        Replies are delivered through each request's future (async
        submitters) or ``engine.results`` (sync submitters).
        """
        if mode not in ("continuous", "wave"):
            raise ValueError(f"unknown serve mode {mode!r}")
        self._running = True
        try:
            while self._running:
                # liveness signal for the supervisor's heartbeat registry:
                # the loop itself is host 1, launches are host 0
                self.supervisor.beat_loop()
                if self.queue.empty() and not self.scheduler.has_open():
                    await asyncio.sleep(poll_interval)
                    continue
                if mode == "continuous":
                    served = self.step_continuous()
                else:
                    served = self.drain()
                if not served and self.queue.empty():
                    # open buckets are all inside their age-out budget;
                    # idle until the clock (or a new arrival) unblocks one
                    await asyncio.sleep(poll_interval)
                else:
                    await asyncio.sleep(0)  # yield to submitters
        finally:
            self._running = False

    def stop(self) -> None:
        """Stop serving and resolve every still-pending async future.

        A waiter whose request was never served receives a typed
        :class:`ShutdownReply` instead of hanging forever — shutdown
        preserves the exactly-one-reply guarantee.
        """
        self._running = False
        futures, self._futures = self._futures, {}
        for rid, fut in futures.items():
            self._resolve_future(fut, ShutdownReply(request_id=rid))

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict:
        """One flat dict of serving health — see
        :meth:`repro_torch.serving.ServingMetrics.snapshot` for the keys."""
        return self.metrics.snapshot(
            bucket_hits=self.pool.bucket_hits,
            bucket_misses=self.pool.bucket_misses,
            relowerings=self.pool.relowerings(),
            by_model=self.pool.counters_by_model(),
            supervisor=self.supervisor.stats(),
        )
