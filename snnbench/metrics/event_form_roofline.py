"""The event form's share of its roofline over phase B of a traced run, in
percent: the least time of the synaptic events of the requests served in
phase B (``work/event_form.py``), over the profiled device time of every
op that is not K1's, K2's, K3's or a copy; scaled, as the kernels'
rooflines are, where the profiler recorded fewer ``index_add_`` calls
than the launches imply.

A request's events are counted from its kept reply; a phase-B request
whose reply the run did not keep counts its steps at the mean events a
step of the kept replies.  None where no projection runs the event form.
"""
from snnbench.trace import kernel_time
from snnbench.work.event_form import INDEX_ADD, OTHER, EventWork


def _served_by(run, rec):
    """The window's requests in flight when the launch ``rec`` began."""
    return [r for r in run.window.requests
            if r.kind == "ok" and r.t_submit <= rec["t"] <= r.t_reply]


def read(run):
    if not run.profile:
        return None
    launches = [r for r in run.launches if r["phase"] == "B"]
    works = {}
    for rec in launches:
        key = (rec["model"], rec["batch"])
        if key not in works:
            forms = run.executables[rec["model"]].serial_forms(rec["batch"])
            works[key] = EventWork(run.graph, forms)
    if not launches or not any(w.edges for w in works.values()):
        return None
    kept = run.window.kept
    sched = run.sched

    def reply(i):
        arrays, index, _ = kept[i]
        return [arrays[k] for k in index]

    events, implied = 0.0, 0
    for rec in launches:
        work = works[(rec["model"], rec["batch"])]
        implied += rec["bucket"] * len(work.edges)
        per_step = None
        for r in _served_by(run, rec)[: rec["requests"]]:
            i = r.index
            if i in kept:
                events += work.events(sched.payload(i), reply(i))
                continue
            if per_step is None:
                steps = sum(int(sched.steps[j]) for j in kept)
                per_step = sum(work.events(sched.payload(j), reply(j))
                               for j in kept) / steps if steps else 0.0
            events += per_step * int(sched.steps[i])
    t = sum(s for name, (s, _) in run.profile["ops"].items()
            if not any(k in name for k in OTHER))
    _, calls = kernel_time(run.profile, INDEX_ADD)
    if t <= 0 or not events:
        return None
    scale = min(1.0, calls / implied) if calls and implied else 1.0
    return 100.0 * EventWork.bound_s(events) * scale / t
