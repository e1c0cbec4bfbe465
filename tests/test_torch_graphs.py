"""CUDA graphs of the served launch, as far as the CPU can show them.

Off the card nothing is captured: the pool's warm-up captures no shape,
its ``graph_captures`` and ``graph_replays`` stay 0, every
``executor.scan`` span says ``graph="eager"`` and replies are those of the
eager loop.  The replay path itself (inputs copied into the graph's
buffers, the launch's bookkeeping, clones out, the kernels' counts added)
is held here with a stand-in graph whose replay reruns the loop from its
buffers; ``tests/test_torch_cuda.py`` holds real graphs on the card.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as P
import repro_torch.serving as PS
from repro_torch import trace
from repro_torch.core.runtime import NetworkExecutable, network_executable
from repro_torch.core.runtime.executor import (
    _all_binary,
    _init_graph_carry,
    _LaunchGraph,
    _scan_network,
)
from repro_torch.kernels import add_launch_counts, launch_counts, reset_launch_counts

MICRO = 4


@pytest.fixture
def kept_counts():
    """The kernels' launch counts as they were before the test, after it."""
    before = launch_counts()
    yield
    reset_launch_counts()
    add_launch_counts(before)


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


def fan_in_net():
    """Two paths from the input into ``c`` (one serial, one parallel),
    so two projections share ``c``'s train."""
    rng = np.random.default_rng(303)
    lif = P.LIFParams(alpha=0.5, v_th=64.0)
    pops = {n: P.Population(n, s) for n, s in
            [("in", 15), ("a", 12), ("b", 10), ("c", 8)]}
    projs = []
    for pre, post, density, delay in [("in", "a", 0.4, 2), ("in", "b", 0.3, 4),
                                      ("a", "c", 0.5, 1), ("b", "c", 0.5, 3)]:
        p = P.random_projection(pops[pre], pops[post], density, delay,
                                seed=int(rng.integers(0, 2**31)))
        p.lif = lif
        projs.append(p)
    net = P.SNNNetwork(populations=list(pops.values()), projections=projs,
                       name="fan-in")
    report = P.CompileReport(layers=[
        P.SwitchingCompiler(par).compile_layer(layer)
        for par, layer in zip(["serial", "parallel", "parallel", "serial"],
                              net.layers)])
    return net, report


def chain_net(sizes, seed):
    layers = []
    for i in range(len(sizes) - 1):
        layer = P.random_layer(sizes[i], sizes[i + 1], density=0.5,
                               delay_range=2 + i, seed=seed + i)
        layer.lif = P.LIFParams(alpha=0.5, v_th=64.0)
        layers.append(layer)
    net = P.SNNNetwork(layers=layers)
    report = P.CompileReport(layers=[
        P.SwitchingCompiler(("serial", "parallel")[i % 2]).compile_layer(layer)
        for i, layer in enumerate(net.layers)])
    return net, report


def engine():
    eng = PS.ServingEngine(*chain_net([12, 10, 6], 1), micro_batch=MICRO,
                           min_bucket_steps=4, device="cpu")
    eng.register_model(*chain_net([9, 8], 2), "b")
    for m in ("default", "b"):
        eng.warmup([4, 8, 16], model=m)
    return eng


def traffic(n=10, seed=4):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        model = "b" if rng.random() < 0.4 else "default"
        width = 9 if model == "b" else 12
        x = rng.random((int(rng.integers(2, 15)), width)) < 0.3
        reqs.append((model, x.astype(np.float32)))
    return reqs


def serve(eng, reqs):
    rids, replies = [], {}
    for i, (model, x) in enumerate(reqs):
        rids.append(eng.submit(x, model=model))
        if i % 3 == 2:
            replies.update(eng.step_continuous())
    replies.update(eng.drain())
    return rids, replies


def test_the_pool_captures_nothing_on_the_cpu(tracing):
    """Warm-up and serving off the card capture nothing, count no graph,
    and each scan span says it ran the eager loop; replies are the
    eager loop's, request by request."""
    eng = engine()
    reqs = traffic()
    trace.enable()
    rids, replies = serve(eng, reqs)
    counters = eng.pool.counters_by_model()
    assert set(counters) == {"default", "b"}
    for c in counters.values():
        assert c["graph_captures"] == c["graph_replays"] == 0
        assert c["fused_launches"] + c["batched_launches"] > 0
    for m in counters:
        exe = eng.pool.peek(m).report.executable
        assert exe._graphs == {} and exe.graph_replays == 0
        assert exe.capture_graph(8, MICRO) == 0
    scans = [r for r in trace.records() if r.name == "executor.scan"]
    assert scans and all(r.attrs["graph"] == "eager" for r in scans)
    for rid, (model, x) in zip(rids, reqs):
        entry = eng.pool.peek(model)
        pad = np.zeros((x.shape[0], 1, entry.net.n_input), np.float32)
        pad[:, 0, : x.shape[1]] = x
        solo = network_executable(entry.net, entry.report, device="cpu").run(pad)
        for got, want in zip(replies[rid], solo):
            np.testing.assert_array_equal(got, want[:, 0])


class StandInGraph:
    """On the CPU, a captured launch's stand-in: each replay reruns the
    launch's loop from the buffers into the outputs, as the graph would."""

    def __init__(self, exe, forms, steps, batch):
        self.exe, self.forms = exe, forms
        self.spikes = torch.zeros((steps, batch, exe.n_input))
        self.valid = torch.zeros(batch, dtype=torch.int32)
        self.outs = tuple(torch.zeros((steps, batch, exe.plan.pop_sizes[p]))
                          for p in exe.plan.update_order)
        self.ok = torch.zeros((), dtype=torch.bool)
        self.replays = 0

    def replay(self):
        exe = self.exe
        states = _init_graph_carry(exe.plan, exe.metas, self.spikes.shape[1],
                                   exe.device)
        outs = _scan_network(exe.plan, exe.metas, self.forms,
                             exe._params_for(self.forms), states, self.spikes,
                             self.valid)
        for o, z in zip(self.outs, outs):
            o.copy_(z)
        self.ok.copy_(_all_binary(outs, exe.device))
        self.replays += 1


@pytest.mark.parametrize("path", ["run_device", "run_batched"])
def test_a_replay_copies_in_counts_and_clones_out(tracing, kept_counts, path):
    """A launch of a captured shape replays its graph: the inputs go into
    the graph's buffers (the eager launch's bytes), the forms and entries
    are recorded, the graph's kernel launches are added to the counts,
    and the trains come back as clones, fan-in entries sharing one, so a
    later replay leaves them as they were.  Other shapes run eagerly."""
    net, report = fan_in_net()
    exe = network_executable(net, report, device="cpu")
    steps, batch = 6, MICRO
    rng = np.random.default_rng(8)
    xs = [(rng.random((steps, batch, exe.n_input)) < 0.4).astype(np.float32)
          for _ in range(2)]
    valid = np.asarray([6, 0, 3, 5], np.int32)
    want = [[z.clone() for z in exe.run_device(x, valid_steps=valid)] for x in xs]
    forms = exe.serial_forms(batch)
    stand_in = StandInGraph(exe, forms, steps, batch)
    exe._graphs[(forms, steps, batch, True)] = _LaunchGraph(
        stand_in, stand_in.spikes, stand_in.valid, stand_in.outs, stand_in.ok,
        {"lif_step": 7})
    report.serial_forms.clear()
    exe._entries.clear()
    before = launch_counts()["lif_step"]
    trace.enable()
    got = [getattr(exe, path)(x, valid_steps=valid) for x in xs]
    assert stand_in.replays == exe.graph_replays == 2
    assert launch_counts()["lif_step"] == before + 14
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
        assert all(a is not b for a in g for b in stand_in.outs)
    tgt = exe.plan.proj_tgt
    assert tgt[2] == tgt[3] and got[0][2] is got[0][3]
    assert exe.last_check is not stand_in.ok and bool(exe.last_check)
    rec = "vmap" if path == "run_batched" else "fused"
    assert report.serial_forms == {(rec, batch): forms}
    assert exe._entries == {(rec, forms, None)}
    # (the stand-in's own loop records an eager scan inside each replay's);
    # a replay's span counts the event form's rows as an eager scan does,
    # and its event-form projection-steps as the executable's operands run
    # them (here on the CPU: swept)
    scans = [r for r in trace.records() if r.name == "executor.scan"
             and r.attrs["graph"] == "replay"]
    rows = sum(c.synaptic_rows.size for l, f in zip(report.layers, forms)
               if f == "event" for c in l.program.cells)
    assert [(r.attrs, r.counts) for r in scans] == [
        ({"steps": steps, "graph": "replay", "event_rows": rows},
         {"kernel_launches": 7, "event_driven": 0,
          "event_swept": steps * forms.count("event")})] * 2
    h2d = [r.counts["h2d_bytes"] for r in trace.records()
           if r.name == "executor.inputs"]
    assert h2d == [xs[0].nbytes + valid.nbytes] * 2
    # another shape, and a launch without valid steps, run the eager loop
    trace.clear()
    exe.run_device(xs[0][:4], valid_steps=np.minimum(valid, 4))
    exe.run_device(xs[0])
    assert stand_in.replays == 2
    assert [r.attrs["graph"] for r in trace.records()
            if r.name == "executor.scan"] == ["eager", "eager"]


def stand_in_for(exe, steps, batch):
    """Install a stand-in graph for a masked ``(steps, batch)`` launch."""
    forms = exe.serial_forms(batch)
    g = StandInGraph(exe, forms, steps, batch)
    exe._graphs[(forms, steps, batch, True)] = _LaunchGraph(
        g, g.spikes, g.valid, g.outs, g.ok, {"sparse_gather": 2})
    return g


def test_the_pool_counts_the_launches_that_replay(kept_counts):
    """The pool books a launch that replayed a graph under its model's
    ``graph_replays``, on either path, and an eager launch under none;
    an eviction drops the executable's graphs."""
    net, report = fan_in_net()
    pool = PS.ExecutablePool(device="cpu")
    pool.register(net, report, "m")
    key = PS.BucketKey(steps=8, n_in=net.n_input, batch=MICRO)
    other = PS.BucketKey(steps=4, n_in=net.n_input, batch=MICRO)
    assert pool.warmup([key, other], name="m") == 2
    exe = pool.peek("m").report.executable
    g = stand_in_for(exe, 8, MICRO)
    rng = np.random.default_rng(5)
    reqs = [PS.SNNRequest(i, (rng.random((int(s), net.n_input)) < 0.3)
                          .astype(np.float32), 0.0, model="m")
            for i, s in enumerate([8, 3, 4, 1])]
    eager = NetworkExecutable.build(net, report, device="cpu")
    reset_launch_counts()
    for mb in (PS.pad_microbatch(key, reqs, "m"),        # full: batched
               PS.pad_microbatch(key, reqs[:2], "m"),    # partial: fused
               PS.pad_microbatch(other, reqs[1:3], "m")):
        outs = pool.run_microbatch(mb)
        assert bool(pool.last_launch_check)
        for a, b in zip(outs, eager.run_device(mb.spikes,
                                               valid_steps=mb.valid_steps)):
            assert torch.equal(a, b)
    c = pool.counters_by_model()["m"]
    assert (c["graph_replays"], c["graph_captures"]) == (2, 0)
    assert g.replays == 2
    assert (c["batched_launches"], c["fused_launches"]) == (1, 2)
    assert launch_counts()["sparse_gather"] == 4
    pool.evict("m")
    assert exe._graphs == {}
