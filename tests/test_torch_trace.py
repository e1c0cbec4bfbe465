"""The port's tracer (``repro_torch.trace``) and its spans along the
serving path, on the CPU: the span tree of a launch, the counters against
hand counts, replies unchanged by tracing, the spans on a profiler's
timeline, and the bounded buffer."""
import gc
import threading
import tracemalloc
from collections import deque

import numpy as np
import pytest
import torch

import repro_torch.core as P
import repro_torch.serving as PS
from repro_torch import trace
from repro_torch.kernels import launch_counts, reset_launch_counts
from test_torch_cuda import card  # noqa: F401  (the card fixture)

#: model -> (layer sizes, first paradigm)
MODELS = {"default": ([12, 10, 6], "serial"), "b": ([9, 8], "parallel")}
MICRO = 4


@pytest.fixture
def tracing():
    """Tracing off and the buffer empty, before and after the test."""
    was = trace.enabled()
    trace.disable()
    trace.clear()
    yield trace
    trace.disable()
    trace.clear()
    if was:
        trace.enable()


def _net(sizes, first, seed):
    layers = []
    for i in range(len(sizes) - 1):
        layer = P.random_layer(sizes[i], sizes[i + 1], density=0.5,
                               delay_range=2 + i, seed=seed + i)
        layer.lif = P.LIFParams(alpha=0.5, v_th=64.0)
        layers.append(layer)
    net = P.SNNNetwork(layers=layers)
    order = ("serial", "parallel") if first == "serial" else ("parallel", "serial")
    report = P.CompileReport(layers=[
        P.SwitchingCompiler(order[i % 2]).compile_layer(layer)
        for i, layer in enumerate(net.layers)])
    return net, report


def _engine():
    nets = {m: _net(sizes, first, 7 * k)
            for k, (m, (sizes, first)) in enumerate(MODELS.items())}
    eng = PS.ServingEngine(*nets["default"], micro_batch=MICRO,
                           min_bucket_steps=4, device="cpu")
    eng.register_model(*nets["b"], "b")
    for m in MODELS:
        eng.warmup([4, 8, 16], model=m)
    return eng


def _traffic(n=11, seed=3):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        model = "b" if rng.random() < 0.35 else "default"
        width = MODELS[model][0][0]
        steps = int(rng.integers(2, 15))
        x = (rng.random((steps, int(rng.integers(width // 2, width + 1)))) < 0.3)
        reqs.append((model, x.astype(np.float32)))
    return reqs


def _serve(eng, reqs):
    """Submit in bursts of three with a continuous step after each, then
    drain; returns (request ids, replies)."""
    rids, replies = [], {}
    for i, (model, x) in enumerate(reqs):
        rids.append(eng.submit(x, model=model))
        if i % 3 == 2:
            replies.update(eng.step_continuous())
    replies.update(eng.drain())
    return rids, replies


def _launches_of(eng):
    """Wrap the pool so each launch's micro-batch and outputs are kept."""
    seen = []
    run_mb = eng.pool.run_microbatch

    def run_microbatch(mb, *a, **kw):
        outs = run_mb(mb, *a, **kw)
        seen.append((mb, outs))
        return outs

    eng.pool.run_microbatch = run_microbatch
    return seen


def test_off_records_nothing_and_span_is_the_shared_noop(tracing):
    assert not trace.enabled()
    assert trace.span("engine.submit", model="m") is trace.NOOP
    assert not trace.NOOP
    with trace.span("a") as sp:
        assert sp is trace.NOOP
        trace.count("n", 3)
        sp.set(k=1)
    t = trace.timed("engine.launch")
    with t:
        pass
    assert not t and t.t1 >= t.t0 > 0          # stamped, not recorded

    def loop():
        for _ in range(2000):
            with trace.span("x"):
                trace.count("y", 1)

    loop()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        loop()
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before < 1024             # nothing kept from 2000 calls
    assert trace.records() == [] and trace.dropped() == 0


def test_counts_go_to_the_innermost_span_and_stacks_are_per_thread(tracing):
    trace.enable()
    trace.count("lost", 1)                   # outside any span
    with trace.span("outer", a=1):
        trace.count("n", 2)
        with trace.span("inner") as sp:
            trace.count("n", 3)
            trace.count("n", 4)
            sp.set(b=2)
    inner, outer = trace.records()
    assert (inner.name, inner.counts, inner.attrs) == ("inner", {"n": 7}, {"b": 2})
    assert (outer.name, outer.counts, outer.attrs) == ("outer", {"n": 2}, {"a": 1})
    assert inner.parent == outer.id and inner.root == outer.root == outer.id
    assert outer.parent is None and outer.t0 <= inner.t0 <= inner.t1 <= outer.t1

    trace.clear()
    go = threading.Barrier(2)

    def work(k):
        with trace.span(f"t{k}"):
            go.wait(timeout=10)
            with trace.span(f"t{k}.child"):
                go.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    by_name = {r.name: r for r in trace.records()}
    for k in range(2):
        assert by_name[f"t{k}.child"].parent == by_name[f"t{k}"].id
        assert by_name[f"t{k}"].parent is None


def test_the_buffer_drops_the_oldest_records_and_counts_them(tracing, monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    monkeypatch.setattr(trace, "_records", deque(maxlen=4))
    trace.enable()
    for k in range(7):
        with trace.span(f"s{k}"):
            pass
    assert [r.name for r in trace.records()] == ["s3", "s4", "s5", "s6"]
    assert trace.dropped() == 3
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


#: a launch's spans, each with the name of its parent
LAUNCH_TREE = {
    "supervisor.attempt": "engine.launch",
    "pool.run_microbatch": "supervisor.attempt",
    "executor.inputs": "pool.run_microbatch",
    "executor.prepare": "pool.run_microbatch",
    "executor.scan": "pool.run_microbatch",
    "executor.check": "pool.run_microbatch",
    "pool.sync": "pool.run_microbatch",
    "supervisor.host_copy": "supervisor.attempt",
    "supervisor.validate": "supervisor.attempt",
    "supervisor.trim": "engine.launch",
}


def test_an_engine_gives_the_span_tree_and_hand_counted_counters(tracing):
    eng = _engine()
    seen = _launches_of(eng)
    reqs = _traffic()
    trace.enable()
    rids, replies = _serve(eng, reqs)
    recs = trace.records()
    assert trace.dropped() == 0 and sorted(replies) == sorted(rids)
    by_id = {r.id: r for r in recs}

    submits = [r for r in recs if r.name == "engine.submit"]
    assert [s.attrs["request_id"] for s in submits] == rids
    assert [(s.attrs["model"], s.attrs["steps"]) for s in submits] == [
        (m, x.shape[0]) for m, x in reqs]
    admits = [r for r in recs if r.name == "engine.admit"]
    assert sum(a.counts.get("admitted", 0) for a in admits) == len(reqs)

    launches = [r for r in recs if r.name == "engine.launch"]
    assert len(launches) == len(seen) > 2
    served = [rid for ln in launches for rid in ln.attrs["request_ids"]]
    assert sorted(served) == sorted(rids)
    for ln, (mb, outs) in zip(sorted(launches, key=lambda r: r.t0), seen):
        assert ln.parent is None and ln.root == ln.id == ln.attrs["launch_id"]
        assert ln.attrs["request_ids"] == [r.request_id for r in mb.requests]
        tree = [r for r in recs if r.root == ln.id and r is not ln]
        assert sorted(r.name for r in tree) == sorted(LAUNCH_TREE)
        for r in tree:
            assert by_id[r.parent].name == LAUNCH_TREE[r.name]
            assert ln.t0 <= r.t0 <= r.t1 <= ln.t1
        # counters against the micro-batch and the output tensors
        counts = {}
        for r in tree:
            for k, v in (r.counts or {}).items():
                counts[k] = counts.get(k, 0) + v
        distinct = {id(z): z for z in outs}.values()
        exe = eng.pool.peek(mb.model).report.executable
        forms = exe.serial_forms(mb.key.batch)
        assert counts == {
            "h2d_bytes": mb.spikes.nbytes + mb.valid_steps.nbytes,
            "d2h_bytes": sum(z.numel() * z.element_size() for z in distinct) + 1,
            "kernel_launches": 0,            # CPU tensors run the plain versions
            # and the CPU sweeps every event-form projection's rows
            "event_driven": 0,
            "event_swept": mb.key.steps * forms.count("event"),
        }
        scan = next(r for r in tree if r.name == "executor.scan")
        # the CPU runs the eager loop: no CUDA graph off the card; the
        # event form sweeps the synaptic rows of its projections' programs
        rows = sum(c.synaptic_rows.size for l, f in zip(exe.report.layers, forms)
                   if f == "event" for c in l.program.cells)
        assert scan.attrs == {"steps": mb.key.steps, "graph": "eager",
                              "event_rows": rows}
        pool = next(r for r in tree if r.name == "pool.run_microbatch")
        assert pool.attrs == {"path": "batched" if len(mb.requests) == MICRO
                              else "fused", "hit": True}
        # the engine's dispatch and completion stamps are the span's own
        for rec in eng.metrics.records:
            if rec.request_id in ln.attrs["request_ids"]:
                assert (rec.t_dispatch, rec.t_complete) == (ln.t0 / 1e9, ln.t1 / 1e9)

    pads = [r for r in recs if r.name == "scheduler.pad"]
    pops = [r for r in recs if r.name == "scheduler.pop"]
    assert len(pads) == len(pops) == len(launches)
    for pad, (mb, _) in zip(sorted(pads, key=lambda r: r.t0), seen):
        assert by_id[pad.parent].name == "scheduler.pop"
        assert by_id[pad.parent].attrs == {
            "bucket_steps": mb.key.steps, "batch": mb.key.batch,
            "live": len(mb.requests)}
        assert pad.counts == {"true_request_steps": mb.real_request_steps,
                              "lane_steps": mb.padded_request_steps}
    assert sum(r.name == "engine.deliver" for r in recs) >= 1


def test_replies_are_the_same_with_tracing_on_and_off(tracing):
    reqs = _traffic(n=13, seed=5)
    got = {}
    for on in (False, True):
        (trace.enable if on else trace.disable)()
        rids, replies = _serve(_engine(), reqs)
        got[on] = [replies[rid] for rid in rids]
    assert trace.records()
    for off, on in zip(got[False], got[True]):
        assert len(off) == len(on)
        for a, b in zip(off, on):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_each_span_under_a_profiler_has_its_event(tracing):
    eng = _engine()
    reqs = _traffic(n=8, seed=9)
    trace.enable()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    # a collection of a large heap that starts between a span's stamp and
    # its event's lengthens one and not the other: none runs in the stretch
    gc.collect()
    gc.disable()
    prof.start()
    try:
        _serve(eng, reqs)
    finally:
        prof.stop()
        gc.enable()
    recs = trace.records()
    assert len(recs) > 20
    events = {}
    for e in prof.events():
        if e.name.startswith("repro_torch."):
            events.setdefault(e.name[len("repro_torch."):], []).append(e)
    names = {r.name for r in recs}
    assert set(events) == names
    for name in names:
        mine = sorted((r for r in recs if r.name == name), key=lambda r: r.t0)
        theirs = sorted(events[name], key=lambda e: e.time_range.start)
        assert len(mine) == len(theirs), name
        for r, e in zip(mine, theirs):
            us = (r.t1 - r.t0) / 1e3
            assert abs(us - (e.time_range.end - e.time_range.start)) <= 50.0, name


def test_each_compiled_projection_has_its_span_and_fallbacks_are_counted(tracing):
    """``switching.compile_layer``: one span a projection with its name,
    paradigm, label, ``forced``, synapses and cells; a projection over the
    dense cap that the classifier sent parallel counts one
    ``switching.cap_fallbacks``.  Off, nothing is recorded."""
    from repro_torch.core.dataset import LABEL_PARALLEL
    from repro_torch.core.layer import Population, random_sparse_projection

    class Parallel:
        def predict(self, feats):
            return np.full(len(feats), LABEL_PARALLEL)

    pops = [Population("in", 5000),
            Population("out", 4000, lif=P.LIFParams(alpha=0.5, v_th=2.0))]
    big = random_sparse_projection(pops[0], pops[1], 1e-3, 2, seed=1, name="in->out")
    small = random_sparse_projection(pops[1], pops[1], 1e-4, 2, seed=2, name="out->out")
    net = P.SNNNetwork(populations=pops, projections=[big, small])
    comp = P.SwitchingCompiler("classifier", Parallel())
    comp.compile_network(net)
    assert trace.records() == []
    trace.enable()
    report = comp.compile_network(net)
    spans = [r for r in trace.records() if r.name == "switching.compile_layer"]
    assert [s.attrs for s in spans] == [
        {"name": "in->out", "paradigm": "serial", "predicted": LABEL_PARALLEL,
         "forced": True, "n_synapses": big.n_synapses,
         "n_cells": len(report.layers[0].program.cells)},
        {"name": "out->out", "paradigm": "parallel", "predicted": LABEL_PARALLEL,
         "forced": False, "n_synapses": small.n_synapses,
         "n_cells": len(report.layers[1].program.slices)}]
    assert [s.counts for s in spans] == [{"switching.cap_fallbacks": 1}, None]
    assert report.cap_fallbacks == 1
    assert all(s.parent is None for s in spans)


@pytest.mark.parametrize("form", ["event", "sparse"])
def test_the_scan_span_counts_the_event_forms_rows(tracing, form):
    """``executor.scan``'s ``event_rows``: the synaptic rows of every
    projection the launch runs in the event form, read from the
    executable (none when no projection runs it); off, no span."""
    net, report = _net([12, 10, 6, 5], "serial", 3)
    exe = P.runtime.network_executable(net, report, device="cpu")
    x = (np.random.default_rng(1).random((5, 2, 12)) < 0.4).astype(np.float32)
    exe.run_device(x, serial_form=form)
    assert trace.records() == []
    trace.enable()
    exe.run_device(x, serial_form=form)
    (scan,) = [r for r in trace.records() if r.name == "executor.scan"]
    rows = [sum(c.synaptic_rows.size for c in l.program.cells)
            for l in report.layers if l.paradigm == "serial"]
    assert len(rows) == 2 and min(rows) > 0
    assert scan.attrs == {"steps": 5, "graph": "eager",
                          "event_rows": sum(rows) if form == "event" else 0}
    # the CPU sweeps each event-form projection each step
    assert scan.counts == {"kernel_launches": 0, "event_driven": 0,
                           "event_swept": 5 * 2 if form == "event" else 0}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_the_scan_span_counts_driven_event_steps_on_the_card(tracing, card, batch):
    """On the card every event-form projection-step runs the driven kernel,
    eager, captured and replayed alike: ``event_driven`` is the event-form
    edges times the steps, ``event_swept`` 0, and the replay's trains are
    the eager launch's."""
    net, report = _net([12, 10, 6, 5], "serial", 3)
    exe = P.runtime.network_executable(net, report, device=card)
    x = (np.random.default_rng(1).random((5, batch, 12)) < 0.4).astype(np.float32)
    trace.enable()
    want = [z.clone() for z in exe.run_device(x, serial_form="event")]
    assert exe.capture_graph(5, batch) == 1
    reset_launch_counts()
    got = exe.run_device(x, serial_form="event")
    assert launch_counts()["event_scatter"] == 5 * 2     # counted on replay
    scans = [r for r in trace.records() if r.name == "executor.scan"]
    assert [r.attrs["graph"] for r in scans] == ["eager", "capture", "replay"]
    for r in scans:
        assert (r.counts["event_driven"], r.counts["event_swept"]) == (5 * 2, 0)
        assert r.counts["kernel_launches"] > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
