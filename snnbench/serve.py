"""Drives the port's serving engine through one measured window.

The window's entry is ``repro_torch.serving.ServingEngine``: ``submit``
and ``step_continuous`` (one admitted bucket a call), which reach the
card through the launch supervisor, the executable pool and the fused
executor.  An open loop submits each request when it is due and times it
from then; a closed loop keeps each client's one request in flight.

In a traced run, :class:`Spans` wraps the engine's layers with the
harness's own spans (host clock, and ``record_function`` while the
profiler runs); an untraced run wraps nothing.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

import numpy as np
import torch

from snnbench.schedule import Schedule

#: seconds a run waits past the window's close for replies still due
GRACE_S = 60.0


@dataclasses.dataclass
class Request:
    index: int                  # into the schedule
    rid: int = -1               # the engine's request id
    t_due: float = 0.0          # perf_counter when it was due
    t_submit: float = 0.0
    t_reply: Optional[float] = None
    kind: str = "pending"       # "ok" | "shed" | "failed" | "pending"


@dataclasses.dataclass
class Window:
    t0: float
    t_end: float
    requests: List[Request]
    #: index -> the reply kept for the check: (distinct host arrays as
    #: uint8, projection -> array slot, non-binary entries)
    kept: Dict[int, tuple]
    reused: int = 0             # closed loop: requests sent from a restarted list

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0


def build_engine(net, reports: dict, traffic: dict, device):
    """The engine over the configuration's tenants ("default" first)."""
    from repro_torch.serving import ServingEngine

    eng = traffic["engine"]
    engine = ServingEngine(net, reports["default"], micro_batch=eng["micro_batch"],
                           min_bucket_steps=eng["min_bucket_steps"],
                           max_wait_ms=eng["max_wait_ms"], device=device)
    for name, rep in reports.items():
        if name != "default":
            engine.register_model(net, rep, name)
    return engine


def warm(engine, traffic: dict) -> int:
    """Warm every bucket shape the traffic's lengths land in, on each path,
    for each tenant the traffic sends to."""
    lo, hi = traffic["steps"]
    return sum(engine.warmup(list(range(lo, hi + 1)), model=m)
               for m, share in traffic["tenants"].items() if share > 0)


def keep_reply(reply) -> tuple:
    """A compact copy of a reply: each distinct array once, as 0/1 uint8,
    and how many of its entries were neither 0 nor 1."""
    slots, arrays, bad = {}, [], 0
    index = []
    for z in reply:
        k = slots.get(id(z))
        if k is None:
            k = slots[id(z)] = len(arrays)
            z = np.asarray(z)
            bad += int(np.count_nonzero((z != 0) & (z != 1)))
            arrays.append((z != 0).astype(np.uint8))
        index.append(k)
    return arrays, index, bad


def _keep_set(sched: Schedule, traffic: dict, seed: int):
    """Which requests' replies are kept for the check: each client's every
    n-th from a seeded offset (open loop: one client), at most ``max``, and
    the first of the longest to finish."""
    check = traffic["check"]
    every, most = check["every"], check["max"]
    rng = np.random.default_rng([int(seed) % 2**63, 9])
    owners = sched.client if sched.client[0] >= 0 else np.zeros(len(sched), int)
    keep = np.zeros(len(sched), bool)
    for c in np.unique(owners):
        mine = np.flatnonzero(owners == c)
        keep[mine[int(rng.integers(every))::every]] = True
    return keep, most


def _submit(engine, sched: Schedule, i: int, req: Request) -> None:
    req.t_submit = time.perf_counter()
    req.rid = engine.submit(sched.payload(i), model=sched.tenant[i],
                            priority=int(sched.priority[i]),
                            deadline_ms=sched.deadline_ms[i])


def _settle(served, by_rid, t, sched, keep, most, kept, longest_kept):
    """Record the replies one engine step delivered; returns the indices
    of the requests that finished."""
    from repro_torch.serving import FailedReply, ShedReply

    done = []
    for rid, reply in served.items():
        req = by_rid.pop(rid, None)
        if req is None:
            continue
        req.t_reply = t
        if isinstance(reply, ShedReply):
            req.kind = "shed"
        elif isinstance(reply, FailedReply):
            req.kind = "failed"
        else:
            req.kind = "ok"
            i = req.index
            longest = sched.steps[i] == sched.steps.max() and not longest_kept[0]
            if (keep[i] and len(kept) < most) or longest:
                kept[i] = keep_reply(reply)
                longest_kept[0] |= bool(longest)
        done.append(req.index)
    return done


def run_open(engine, sched: Schedule, traffic: dict, seconds: float, seed: int,
             spans=None) -> Window:
    """Submit each request when due (``due_s`` < ``seconds``), step the
    engine, and after the close keep stepping until every due request has
    its reply or the grace runs out."""
    keep, most = _keep_set(sched, traffic, seed)
    n = int(np.searchsorted(sched.due_s, seconds))
    reqs = [Request(i) for i in range(n)]
    by_rid, kept, longest_kept = {}, {}, [False]
    t0 = time.perf_counter()
    for r in reqs:
        r.t_due = t0 + float(sched.due_s[r.index])
    win = Window(t0, t0 + seconds, reqs, kept)
    if spans is not None:
        spans.begin(t0, win.t_end)
    nxt = 0
    while True:
        now = time.perf_counter()
        if spans is not None:
            stall = spans.tick(now)
            if stall:
                for r in reqs[nxt:]:
                    r.t_due += stall
                win.t_end += stall
                now = time.perf_counter()
        with spans.label("client") if spans is not None else nullcontext():
            while nxt < n and reqs[nxt].t_due <= now:
                _submit(engine, sched, nxt, reqs[nxt])
                by_rid[reqs[nxt].rid] = reqs[nxt]
                nxt += 1
        if not by_rid:
            if nxt >= n:
                break
            time.sleep(max(0.0, reqs[nxt].t_due - time.perf_counter()))
            continue
        if now > win.t_end + GRACE_S:
            break
        served = engine.step_continuous()
        if served:
            with spans.label("client") if spans is not None else nullcontext():
                _settle(served, by_rid, time.perf_counter(), sched, keep, most,
                        kept, longest_kept)
    return win


def run_closed(engine, sched: Schedule, traffic: dict, seconds: float, seed: int,
               spans=None) -> Window:
    """Each client sends its next request on its reply until the close;
    then the requests still in flight are served to their end."""
    keep, most = _keep_set(sched, traffic, seed)
    clients = traffic["clients"]
    per = len(sched) // clients
    sent = np.zeros(clients, np.int64)
    reqs: List[Request] = []
    by_rid, kept, longest_kept = {}, {}, [False]

    def send(c):
        i = int(c * per + sent[c] % per)       # a client past its list starts it again
        sent[c] += 1
        req = Request(i)
        req.t_due = time.perf_counter()
        _submit(engine, sched, i, req)
        by_rid[req.rid] = req
        reqs.append(req)

    t0 = time.perf_counter()
    win = Window(t0, t0 + seconds, reqs, kept)
    if spans is not None:
        spans.begin(t0, win.t_end)
    for c in range(clients):
        send(c)
    while by_rid:
        now = time.perf_counter()
        if spans is not None:
            win.t_end += spans.tick(now)
        if now > win.t_end + GRACE_S:
            break
        served = engine.step_continuous()
        if not served:
            continue
        t = time.perf_counter()
        with spans.label("client") if spans is not None else nullcontext():
            done = _settle(served, by_rid, t, sched, keep, most, kept, longest_kept)
            if t < win.t_end:
                for i in done:
                    send(int(sched.client[i]))
    win.reused = int(np.maximum(sent - per, 0).sum())
    return win


class Spans:
    """The harness's spans around the engine's layers (a traced run).

    The window runs in two phases.  Phase A, all but its last
    ``profiled_s`` seconds, keeps host-clock spans only: ``launches`` gets
    one record a supervised launch (its model, bucket, requests, the span
    around ``supervisor.run`` and the time inside it spent in
    ``pool.run_microbatch``), and ``on_launch`` counts its work outside
    both spans.  Phase B, to the window's close, runs under ``prof``, and
    every span is also a ``record_function`` named ``snnbench.<layer>``,
    inside one named ``snnbench.window``.
    """

    LABELS = {"submit": "engine.submit", "_admit_pending": "engine.admit",
              "_deliver": "engine.deliver"}

    def __init__(self, engine, *, on_launch=None, prof=None, profiled_s=0.0):
        self.engine, self.phase = engine, "-"
        self.launches: List[dict] = []
        self.on_launch, self.prof, self.profiled_s = on_launch, prof, profiled_s
        self.phase_a = self.switch_at = self.t_end = None
        self.profiled = False
        self._window = None
        self._pool_s = 0.0
        self._undo = []
        self._install()

    # -- the phases -----------------------------------------------------------
    def begin(self, t0: float, t_end: float) -> None:
        self.phase, self.t_end = "A", t_end
        self.switch_at = t_end - self.profiled_s
        self.phase_a = (t0, self.switch_at)

    def tick(self, now: float) -> float:
        """Between two engine steps: enter phase B, or leave it at the close.
        Returns the seconds the profiler took to start (0.0 otherwise): the
        window's close moves by as much, and an open loop's arrivals too,
        so that no backlog piles up behind the start."""
        if self.phase == "A" and now >= self.switch_at:
            self.phase_a = (self.phase_a[0], now)
            self.phase = "B"
            self.prof.start()
            self.profiled = True
            stall = time.perf_counter() - now
            self.t_end += stall
            self._window = torch.profiler.record_function("snnbench.window")
            self._window.__enter__()
            return stall
        if self.phase == "B" and now >= self.t_end:
            self._stop()
        return 0.0

    def _stop(self) -> None:
        self._window.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.phase = "C"

    def label(self, name: str):
        if self.phase == "B":
            return torch.profiler.record_function(f"snnbench.{name}")
        return nullcontext()

    # -- the wrappers -----------------------------------------------------------
    def _patch(self, obj, attr, new) -> None:
        self._undo.append((obj, attr, obj.__dict__.get(attr), attr in obj.__dict__))
        setattr(obj, attr, new)

    def _labelled(self, name, fn):
        def wrapped(*a, **kw):
            with self.label(name):
                return fn(*a, **kw)
        return wrapped

    def _install(self) -> None:
        import repro_torch.serving.pool as pool_mod
        import repro_torch.serving.supervisor as sup_mod

        eng, sup, pool = self.engine, self.engine.supervisor, self.engine.pool
        for attr, name in self.LABELS.items():
            self._patch(eng, attr, self._labelled(name, getattr(eng, attr)))
        self._patch(eng.scheduler, "pop_launchable",
                    self._labelled("scheduler.pad", eng.scheduler.pop_launchable))
        self._patch(sup, "_outputs_valid",
                    self._labelled("supervisor.validate", sup._outputs_valid))
        self._patch(sup, "_replies", self._labelled("supervisor.trim", sup._replies))
        self._patch(sup_mod, "host_arrays",
                    self._labelled("supervisor.host_copy", sup_mod.host_arrays))
        self._patch(pool_mod, "wait_for_device",
                    self._labelled("pool.sync", pool_mod.wait_for_device))
        run_mb, run_sup = pool.run_microbatch, sup.run

        def run_microbatch(*a, **kw):
            t = time.perf_counter()
            with self.label("pool.run_microbatch"):
                out = run_mb(*a, **kw)
            self._pool_s += time.perf_counter() - t
            return out

        def supervised(mb):
            self._pool_s = 0.0
            phase = self.phase
            t = time.perf_counter()
            with self.label("supervisor.run"):
                replies = run_sup(mb)
            t_sup = time.perf_counter() - t
            rec = {"model": mb.model, "bucket": mb.key.steps, "batch": mb.key.batch,
                   "requests": len(mb.requests), "sup_s": t_sup,
                   "pool_s": self._pool_s, "phase": phase, "t": t}
            self.launches.append(rec)
            if self.on_launch is not None and phase == "A":
                self.on_launch(rec, mb, replies)
            return replies

        self._patch(pool, "run_microbatch", run_microbatch)
        self._patch(sup, "run", supervised)

    def close(self) -> None:
        """Stop the profiler if the window ended inside phase B, and put
        every wrapped method back."""
        if self.phase == "B":
            self._stop()
        for obj, attr, old, had in reversed(self._undo):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)
        self._undo = []
