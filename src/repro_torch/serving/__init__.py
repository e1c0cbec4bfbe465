"""Continuous-batching inference serving over the fused network executor.

The port's copy of the reference serving stack: the same queue,
scheduler, pool, supervisor and engine, over
:class:`~repro_torch.core.runtime.NetworkExecutable` on the CUDA card
(``device=None``) or on the CPU (``device="cpu"``).  Turns independent,
variable-shape spike-train requests into efficiently batched launches:

    RequestQueue -> ShapeBucketingScheduler -> ExecutablePool -> device
      (priority /      (pad + micro-batch,      (multi-model, LRU,
       deadline)        slot-level admission)    warm entry per bucket)

with :class:`ServingEngine` as the facade and :class:`ServingMetrics`
tracking latency (overall and per priority class), deadline misses,
throughput, and bucket-hit rate.  Two batching modes: **wave draining**
(``engine.drain()`` — the whole backlog in one gulp) and **continuous
batching** (``engine.step_continuous()`` / ``serve_forever()`` — new
requests join open in-flight buckets between scan launches).  See
``docs/serving.md`` for the request lifecycle and tuning guidance.

Every launch runs under the :class:`LaunchSupervisor` — watchdog,
retry with backoff, batched<->fused degradation behind per-bucket
:class:`CircuitBreaker`\\ s, poison-request bisection to
:class:`FailedReply` quarantine, and output validation.  The
:class:`FaultInjector` arms deterministic, seedable faults for chaos
testing.  See ``docs/robustness.md``.
"""
from .engine import (
    Reply,
    RequestResult,
    ServingEngine,
    ShedReply,
    ShutdownReply,
)
from .faults import (
    FAULT_KINDS,
    DeviceLost,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    LoweringFault,
)
from .metrics import FailedRecord, RequestRecord, ServingMetrics, ShedRecord
from .pool import ExecutablePool, PoolEntry, UnknownModel
from .supervisor import CircuitBreaker, FailedReply, LaunchSupervisor
from .queue import (
    DEFAULT_MODEL,
    InferenceRequest,
    QueueFull,
    RequestQueue,
    SNNRequest,
)
from .scheduler import (
    BucketKey,
    MicroBatch,
    OpenBucket,
    ShapeBucketingScheduler,
    next_pow2,
    pad_microbatch,
)

__all__ = [
    "ServingEngine", "RequestResult", "Reply", "ShedReply",
    "ShutdownReply",
    "ServingMetrics", "RequestRecord", "ShedRecord", "FailedRecord",
    "ExecutablePool", "PoolEntry", "UnknownModel",
    "RequestQueue", "SNNRequest", "InferenceRequest", "QueueFull",
    "DEFAULT_MODEL",
    "ShapeBucketingScheduler", "BucketKey", "MicroBatch", "OpenBucket",
    "next_pow2", "pad_microbatch",
    "LaunchSupervisor", "CircuitBreaker", "FailedReply",
    "FaultInjector", "FaultSpec", "FAULT_KINDS",
    "InjectedFault", "LoweringFault", "DeviceLost",
]
