"""Spans and counters of the port, kept in memory on the host's clock.

A span is a named stretch of one thread's work::

    with trace.span("pool.run_microbatch", path="fused") as sp:
        ...
        trace.count("h2d_bytes", n)      # adds to the innermost open span
        if sp:                           # attributes known only later
            sp.set(hit=True)

Each record keeps its name, its id, the id of the span it was opened in
(``parent``) and of the outermost span of its tree (``root``: the spans
of one launch share the launch's id), its start and end from
:func:`time.perf_counter_ns` (the clock of ``RequestRecord``, the queue
and a benchmark's phases), its attributes and the counts added inside it.
The stack of open spans is per thread.  Records go to a buffer of
:data:`CAPACITY`; past it the oldest are dropped and counted
(:func:`dropped`).

Tracing is off until :func:`enable`.  Off, :func:`span` returns one shared
no-op context (false in a test) and :func:`count` returns at once.  On,
while a ``torch.profiler`` records, each span also opens
``record_function("repro_torch.<name>")`` (its C++ form), so that it
stands on the profiler's timeline, on the profiler's clock, beside the
device's work.

:func:`timed` is a span that always stamps its start and end, for a
caller that needs the times whether or not tracing is on; it is recorded
only when tracing is on.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

#: records kept; past it the oldest are dropped
CAPACITY = 1 << 18

_on = False
_records: deque = deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_profiling = torch._C._autograd._profiler_enabled
#: ``record_function``'s C++ twin: a tenth of its cost, and no annotation
#: of its own on the device's timeline
_RecordFunction = torch._C._profiler._RecordFunctionFast


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span; once closed and recorded, it is its own record."""

    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "attrs",
                 "counts", "recorded", "_rf")

    def __init__(self, name: str, attrs: Dict, recorded: bool):
        self.name, self.attrs, self.recorded = name, attrs, recorded
        self.id = next(_ids)
        self.parent = self.root = None
        self.t0 = self.t1 = 0
        self.counts: Optional[Dict[str, int]] = None
        self._rf = None

    def __bool__(self) -> bool:
        return self.recorded

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        if self.recorded:
            stack = _stack()
            if stack:
                self.parent, self.root = stack[-1].id, stack[-1].root
            else:
                self.root = self.id
            stack.append(self)
            if _profiling():
                self._rf = _RecordFunction(f"repro_torch.{self.name}")
                self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = time.perf_counter_ns()
        if self.recorded:
            if self._rf is not None:
                self._rf.__exit__(exc_type, exc, tb)
                self._rf = None
            _stack().pop()
            _keep(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"root={self.root}, ns={self.t1 - self.t0}, attrs={self.attrs}, "
                f"counts={self.counts})")


class _Noop:
    """The one context :func:`span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _Noop()


def _keep(span: Span) -> None:
    global _dropped
    if len(_records) == CAPACITY:
        _dropped += 1
    _records.append(span)


def span(name: str, **attrs):
    """A span named ``name`` (a context manager), or :data:`NOOP` when off."""
    if not _on:
        return NOOP
    return Span(name, attrs, True)


def timed(name: str, **attrs) -> Span:
    """A span that stamps ``t0`` and ``t1`` (``perf_counter_ns``) whether
    or not tracing is on; recorded, like :func:`span`, only when on."""
    return Span(name, attrs, _on)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` of the innermost open span (lost
    outside any span)."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        top = stack[-1]
        if top.counts is None:
            top.counts = {name: n}
        else:
            top.counts[name] = top.counts.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def records() -> List[Span]:
    """The closed spans kept, oldest first."""
    return list(_records)


def dropped() -> int:
    """Records dropped from the full buffer since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    global _dropped
    _records.clear()
    _dropped = 0


__all__ = ["CAPACITY", "NOOP", "Span", "clear", "count", "disable", "dropped",
           "enable", "enabled", "records", "span", "timed"]
