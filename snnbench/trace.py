"""Reading the profiler's record of phase B of a traced run: when the
device was busy, time by kernel name, and what the host was doing in
each idle gap (the innermost ``snnbench.*`` span around the gap)."""
from __future__ import annotations

from typing import Dict, List, Tuple

WINDOW = "snnbench.window"


def _is_device(e) -> bool:
    """An operation that ran on the device (a kernel, a copy, a fill); the
    harness's own spans also appear on the device's timeline as user
    annotations, which are not work."""
    kind = getattr(e, "device_type", None)
    return (getattr(kind, "name", str(kind)).upper().endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("snnbench."))


def read(events) -> dict:
    """``window_s``, ``busy_s``, device time and count by op name, and the
    idle seconds by the host span around each gap (phase B only)."""
    wins = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not wins:
        raise RuntimeError("the profile holds no snnbench.window span")
    w0, w1 = wins[0].time_range.start, wins[0].time_range.end
    ops: Dict[str, List[float]] = {}
    spans: List[Tuple[float, float, str]] = []
    intervals = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _is_device(e):
            if b <= w0 or a >= w1:
                continue
            rec = ops.setdefault(e.name, [0.0, 0])
            rec[0] += (b - a) / 1e6
            rec[1] += 1
            intervals.append((max(a, w0), min(b, w1)))
        elif e.name.startswith("snnbench.") and e.name != WINDOW:
            spans.append((a, b, e.name[len("snnbench."):]))
    intervals.sort()
    busy, gaps, cur_a, cur_b = 0.0, [], None, w0
    last = w0
    for a, b in intervals:
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                busy += cur_b - cur_a
            if a > last:
                gaps.append((last, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        last = max(last, cur_b)
    if cur_a is not None:
        busy += cur_b - cur_a
    if w1 > last:
        gaps.append((last, w1))
    spans.sort()
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        label = max(inner, key=lambda s: s[0])[2] if inner else "outside any span"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6, "ops": ops,
            "idle": idle}


def kernel_time(summary: dict, names) -> Tuple[float, int]:
    """Device seconds and calls of the ops whose names hold one of ``names``."""
    t, n = 0.0, 0
    for name, (s, c) in summary["ops"].items():
        if any(k in name for k in names):
            t += s
            n += c
    return t, n


def breakdown(summary: dict) -> dict:
    top = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:10]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[0]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
