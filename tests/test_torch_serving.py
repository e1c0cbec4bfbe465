"""The port's serving stack against the reference package's, on the CPU.

The same seeded traffic goes through ``repro.serving.ServingEngine`` (JAX
on the CPU) and ``repro_torch.serving.ServingEngine(device="cpu")``: two
small models, no deadlines, and only ``drain()`` / ``step_continuous()``,
so that no scheduling decision depends on the wall clock.  Replies must
be bitwise equal, and so must the scheduler's, the pool's and the
supervisor's counters, with and without a seeded fault storm.  The port
carries spikes as 0/1 uint8 where the reference carries float32: replies
are held to the reference's value for value, and the queue and the
scheduler to its behaviour on the same seeded request streams.  The other
host copies (metrics, fault tolerance, placement) are held to the
originals statement for statement.
"""
import ast
import asyncio
import inspect
import itertools
import time

import numpy as np
import pytest

import repro.core as R
import repro.distributed.fault_tolerance as r_ft
import repro.placement as RPL
import repro.serving as RS
import repro_torch.core as P
import repro_torch.distributed.fault_tolerance as p_ft
import repro_torch.placement as PPL
import repro_torch.serving as PS
import test_fault_tolerance
from repro_torch.core.runtime import network_executable, run_graph_reference


def mixed_net(mod, sizes, seed, start="serial"):
    """``test_serving.py::mixed_net`` in ``mod``, from its own seed."""
    rng = np.random.default_rng(seed)
    layers = []
    for i in range(len(sizes) - 1):
        layer = mod.random_layer(
            sizes[i], sizes[i + 1],
            density=float(rng.uniform(0.2, 0.7)),
            delay_range=int(rng.integers(1, 6)),
            seed=int(rng.integers(0, 2**31)),
        )
        layer.lif = mod.LIFParams(alpha=0.5, v_th=64.0)
        layers.append(layer)
    net = mod.SNNNetwork(layers=layers)
    order = ("serial", "parallel") if start == "serial" else (
        "parallel", "serial")
    report = mod.CompileReport(layers=[
        mod.SwitchingCompiler(order[i % 2]).compile_layer(layer)
        for i, layer in enumerate(net.layers)
    ])
    return net, report


#: model -> (sizes, seed, first paradigm); "b" is narrower than "default"
MODELS = {"default": ([12, 10, 6], 1, "serial"), "b": ([9, 8], 2, "parallel")}
MICRO = 4


def traffic(n, seed):
    """Seeded requests: (model, priority, spikes) and where to step."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        model = "b" if rng.random() < 0.35 else "default"
        width = MODELS[model][0][0]
        steps = int(rng.integers(2, 15))
        n_in = int(rng.integers(width // 2, width + 1))
        x = (rng.random((steps, n_in)) < 0.3).astype(np.float32)
        reqs.append((model, int(rng.integers(0, 3)), x))
    return reqs


def make_engine(side, **kw):
    mod, S = (R, RS) if side == "ref" else (P, PS)
    if side == "port":
        kw["device"] = "cpu"
    nets = {m: mixed_net(mod, s, seed, start)
            for m, (s, seed, start) in MODELS.items()}
    eng = S.ServingEngine(*nets["default"], micro_batch=MICRO,
                          min_bucket_steps=4, **kw)
    return eng, nets


def serve(side, reqs, *, warm=True, step_every=3, **kw):
    """Drive one engine: register, warm, submit in bursts with continuous
    steps between, then drain.  Returns (engine, nets, replies, rids)."""
    eng, nets = make_engine(side, **kw)
    eng.register_model(*nets["b"], "b",
                       warm_steps=[4, 8, 16] if warm else None)
    if warm:
        eng.warmup([4, 8, 16])
    rids, replies = [], {}
    for i, (model, prio, x) in enumerate(reqs):
        rids.append(eng.submit(x, model=model, priority=prio))
        if step_every and i % step_every == step_every - 1:
            replies.update(eng.step_continuous())
    replies.update(eng.drain())
    return eng, nets, replies, rids


def assert_replies_equal(got, want):
    """The port's replies (0/1 uint8) equal the reference's (float32)
    value for value."""
    assert got.keys() == want.keys()
    for rid in want:
        a, b = got[rid], want[rid]
        assert type(a).__name__ == type(b).__name__ or (
            isinstance(a, list) and isinstance(b, list)), rid
        if isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == np.uint8 and y.dtype == np.float32
                assert x.shape == y.shape
                np.testing.assert_array_equal(x, y)


STAT_KEYS = ("requests", "batches", "shed", "failed", "mean_batch_occupancy",
             "bucket_hits", "bucket_misses", "relowerings", "ageout_launches",
             "padding_overhead", "by_model")
#: Supervisor counters that do not read the wall clock.
SUP_KEYS = ("launch_attempts", "retries", "watchdog_stalls",
            "validation_failures", "degraded_launches", "breaker_skips",
            "bisections", "quarantined", "breakers", "breaker_trips",
            "breaker_probes", "open_breakers")


def without_graph_counters(by_model):
    """The port's per-model counters less its CUDA-graph counters, which
    the reference has no twin of; off the card both must be 0."""
    out = {}
    for name, c in by_model.items():
        c = dict(c)
        assert c.pop("graph_captures") == c.pop("graph_replays") == 0, name
        out[name] = c
    return out


def assert_stats_equal(port, ref):
    sa, sb = port.stats(), ref.stats()
    sa["by_model"] = without_graph_counters(sa["by_model"])
    for k in STAT_KEYS:
        assert sa[k] == sb[k], k
    for k in SUP_KEYS:
        assert sa["supervisor"][k] == sb["supervisor"][k], k
    assert without_graph_counters(port.pool.counters_by_model()) == \
        ref.pool.counters_by_model()
    assert (port.pool.evictions, port.pool.revivals) == (
        ref.pool.evictions, ref.pool.revivals)


@pytest.mark.parametrize("step_every", [0, 3, 1])
def test_engine_replies_and_counters_equal_reference(step_every):
    """Wave (0) and continuous traffic: equal replies and counters; after
    warmup every launch is a hit and nothing re-lowers."""
    reqs = traffic(24, seed=7 + step_every)
    ref, _, r_rep, r_ids = serve("ref", reqs, step_every=step_every)
    port, nets, p_rep, p_ids = serve("port", reqs, step_every=step_every)
    assert r_ids == p_ids
    assert_replies_equal(p_rep, r_rep)
    assert_stats_equal(port, ref)
    st = port.stats()
    assert st["relowerings"] == 0 and st["bucket_misses"] == 0
    assert st["failed"] == 0 and st["shed"] == 0
    by = st["by_model"]
    if step_every != 1:             # one request a step never fills a bucket
        assert sum(m["batched_launches"] for m in by.values()) > 0
    assert sum(m["fused_launches"] for m in by.values()) > 0
    # every reply equals the request alone and the unrolled oracle
    for rid, (model, _, x) in zip(p_ids, reqs):
        net, report = nets[model]
        pad = np.zeros((x.shape[0], 1, net.n_input), np.float32)
        pad[:, 0, : x.shape[1]] = x
        solo = network_executable(net, report, device="cpu").run(pad)
        oracle = run_graph_reference(net, pad)
        for got, a, b in zip(p_rep[rid], solo, oracle):
            np.testing.assert_array_equal(got, a[:, 0])
            np.testing.assert_array_equal(got, b[:, 0])


def test_cold_engine_misses_then_hits_like_reference():
    """Without warmup: the first launch of each shape is a miss."""
    reqs = traffic(16, seed=21)
    ref, _, r_rep, _ = serve("ref", reqs, warm=False)
    port, _, p_rep, _ = serve("port", reqs, warm=False)
    assert_replies_equal(p_rep, r_rep)
    assert_stats_equal(port, ref)
    assert port.stats()["bucket_misses"] > 0


def test_lru_eviction_and_revival_counters_equal_reference():
    """``max_models=1``: every switch of model evicts the other and
    revives it cold; the counters and replies still match."""
    reqs = traffic(14, seed=33)
    ref, _, r_rep, _ = serve("ref", reqs, warm=False, max_models=1)
    port, _, p_rep, _ = serve("port", reqs, warm=False, max_models=1)
    assert_replies_equal(p_rep, r_rep)
    assert_stats_equal(port, ref)
    assert port.pool.evictions >= 2 and port.pool.revivals >= 1
    counters = port.pool.counters_by_model()
    assert sum(c["resident"] for c in counters.values()) == 1
    assert port.pool.peek("default").report.executable is None or (
        port.pool.peek("b").report.executable is None)


def _storm(side, reqs):
    eng, nets = make_engine(side, fault_injector=(
        RS if side == "ref" else PS).FaultInjector(seed=1234),
        max_launch_retries=2, retry_backoff_s=0.0)
    eng.register_model(*nets["b"], "b")
    S = RS if side == "ref" else PS
    inj = eng.pool.fault_injector
    inj.arm_plan([
        S.FaultSpec(kind="lowering", times=2),
        S.FaultSpec(kind="device_lost", path="batched", times=3),
        S.FaultSpec(kind="nan_membrane", times=2),
        S.FaultSpec(kind="nonbinary_spikes", model="b", times=1),
        # a poison request: every launch carrying it fails
        S.FaultSpec(kind="device_lost", request_id=5, times=None),
    ])
    rids = [eng.submit(x, model=m, priority=p) for m, p, x in reqs]
    replies = eng.drain()
    return eng, replies, rids


def test_fault_storm_failed_replies_and_supervisor_counters_equal():
    reqs = traffic(16, seed=99)
    ref, r_rep, _ = _storm("ref", reqs)
    port, p_rep, _ = _storm("port", reqs)
    assert_replies_equal(p_rep, r_rep)
    failed = {rid for rid, r in p_rep.items() if isinstance(r, PS.FailedReply)}
    assert failed == {rid for rid, r in r_rep.items()
                      if isinstance(r, RS.FailedReply)} == {5}
    assert p_rep[5].fault_kind == r_rep[5].fault_kind == "device_lost"
    assert p_rep[5].attempts == r_rep[5].attempts
    assert_stats_equal(port, ref)
    assert port.pool.fault_injector.injected == ref.pool.fault_injector.injected
    sup = port.stats()["supervisor"]
    assert sup["validation_failures"] >= 2 and sup["quarantined"] == 1


def test_fault_free_run_records_no_supervisor_fault():
    port, _, _, _ = serve("port", traffic(12, seed=3))
    sup = port.stats()["supervisor"]
    for k in ("retries", "degraded_launches", "validation_failures",
              "quarantined", "watchdog_stalls", "bisections"):
        assert sup[k] == 0, k
    assert port.pool.last_launch_check is not None


def test_async_serve_forever_resolves_every_future():
    port, nets = make_engine("port")
    reqs = traffic(6, seed=5)

    async def main():
        task = asyncio.ensure_future(port.serve_forever())
        outs = await asyncio.gather(*[
            port.submit_async(x, model="default") for m, _, x in reqs
            if m == "default"
        ])
        port.stop()
        await task
        return outs

    outs = asyncio.run(main())
    assert outs and all(isinstance(o, list) for o in outs)


# -- host copies -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(
    n for n in dir(test_fault_tolerance) if n.startswith("test_")))
def test_fault_tolerance_copy_passes_reference_cases(name, monkeypatch):
    """The reference's own fault-tolerance cases, on the port's copies."""
    for sym in ("HeartbeatRegistry", "RestartPolicy", "StragglerDetector",
                "plan_elastic_mesh"):
        assert getattr(test_fault_tolerance, sym) is getattr(r_ft, sym)
        monkeypatch.setattr(test_fault_tolerance, sym, getattr(p_ft, sym))
    getattr(test_fault_tolerance, name)()


#: class attributes of the reference that the port drops: (class, name)
DROPPED = {("ServingMetrics", "summary")}       # an alias nothing called


class _Untraced(ast.NodeTransformer):
    """The statements without the port's tracing (``repro_torch.trace``):
    its import and ``trace.*`` calls go, each ``with trace.span(...)``
    gives way to its body, and an ``if`` left empty goes too; and without
    the class attributes in :data:`DROPPED`."""

    @staticmethod
    def _traces(call) -> bool:
        return (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id == "trace")

    def visit_ImportFrom(self, node):
        return None if [a.name for a in node.names] == ["trace"] else node

    def visit_Expr(self, node):
        return None if self._traces(node.value) else node

    def visit_With(self, node):
        self.generic_visit(node)
        if all(self._traces(item.context_expr) for item in node.items):
            return node.body
        return node

    def visit_If(self, node):
        self.generic_visit(node)
        return node if node.body or node.orelse else None

    def visit_ClassDef(self, node):
        self.generic_visit(node)
        node.body = [
            st for st in node.body
            if not (isinstance(st, ast.Assign) and any(
                isinstance(t, ast.Name) and (node.name, t.id) in DROPPED
                for t in st.targets))
        ]
        return node


def _code(module):
    """The module's statements with every docstring and the port's tracing
    dropped and the package name unified, as an AST dump."""
    tree = ast.parse(inspect.getsource(module).replace("repro_torch", "repro"))
    tree = _Untraced().visit(tree)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


#: payload dtypes of the seeded request streams, one a request in turn
PAYLOAD_DTYPES = (np.float32, np.uint8, np.bool_, np.int32, np.float64)
#: malformed payloads: (what, payload)
MALFORMED = [
    ("nan", np.array([[0.0, np.nan], [1.0, 0.0]], np.float32)),
    ("inf", np.array([[np.inf, 0.0]])),
    ("two", np.array([[0, 2], [1, 0]], np.int32)),
    ("minus_one", np.array([[-1, 0, 1]], np.int64)),
    ("half", np.array([[0.5, 1.0]], np.float32)),
    ("object", np.array([[0, 1]], dtype=object)),
    ("rank_1", np.zeros(5, np.uint8)),
    ("rank_3", np.zeros((2, 3, 4), np.float32)),
    ("empty", np.zeros((0, 3), np.bool_)),
]


def request_stream(seed, n=40):
    """Seeded requests ``(spikes, model, priority, deadline_ms)`` for the
    queue and the scheduler: the payloads' dtypes in turn."""
    rng = np.random.default_rng(seed)
    stream = []
    for i in range(n):
        model = "b" if rng.random() < 0.35 else "default"
        width = MODELS[model][0][0]
        shape = (int(rng.integers(1, 20)), int(rng.integers(1, width + 1)))
        x = (rng.random(shape) < 0.3).astype(PAYLOAD_DTYPES[i % 5])
        deadline = [None, 5.0, 20.0, 100.0][int(rng.integers(4))]
        stream.append((x, model, int(rng.integers(0, 3)), deadline))
    return stream


def fake_clock(monkeypatch):
    """``time.perf_counter`` reads 0, 1, 2 ... ms from here on, so both
    sides stamp the same stream alike."""
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 1e-3)


def submitted(queue_mod, stream, monkeypatch, **kw):
    """The stream submitted to a fresh queue of ``queue_mod`` on the fake
    clock: the queue, the requests taken and how many were refused full."""
    fake_clock(monkeypatch)
    q = queue_mod.RequestQueue(**kw)
    taken, full = [], 0
    for x, model, prio, deadline in stream:
        try:
            taken.append(q.submit(x, model=model, priority=prio,
                                  deadline_ms=deadline))
        except queue_mod.QueueFull:
            full += 1
    return q, taken, full


def refusal(queue_mod, payload) -> str:
    with pytest.raises(ValueError) as err:
        queue_mod.RequestQueue().submit(payload)
    return str(err.value)


def assert_same_requests(got, want):
    """Port requests against the reference's: the same ids, routing and
    deadlines, and trains equal in value (uint8 against float32)."""
    assert [r.request_id for r in got] == [r.request_id for r in want]
    for a, b in zip(got, want):
        assert (a.model, a.priority, a.deadline_ms, a.t_enqueue) == (
            b.model, b.priority, b.deadline_ms, b.t_enqueue)
        assert a.spikes.dtype == np.uint8 and b.spikes.dtype == np.float32
        np.testing.assert_array_equal(a.spikes, b.spikes)


def queue_behaves_as_reference(ref, port, monkeypatch):
    """The same seeded streams: the same ids, refusals when full, pop
    order (by batches, then the rest at once), shed set at a fixed
    instant, stored trains equal in value, and each malformed payload
    refused with the reference's message."""
    for seed in (11, 12):
        stream = request_stream(seed)
        sides = []
        for mod in (ref, port):
            q, taken, full = submitted(mod, stream, monkeypatch, max_pending=32)
            popped = q.pop_batch(5) + q.pop_batch(3, timeout=0.0) + q.pop_all()
            shed = {r.request_id for r in popped if r.expired(now=0.02)}
            sides.append((taken, full, popped, shed, q.empty()))
        (r_taken, r_full, r_pop, r_shed, r_empty), (
            p_taken, p_full, p_pop, p_shed, p_empty) = sides
        assert p_full == r_full == 8 and p_empty and r_empty
        assert_same_requests(p_taken, r_taken)
        assert_same_requests(p_pop, r_pop)
        assert p_shed == r_shed and 0 < len(p_shed) < len(p_pop)
    for _, payload in MALFORMED:
        assert refusal(port, payload) == refusal(ref, payload)


def batches_of(mbs):
    return [(mb.model, mb.key.shape, [r.request_id for r in mb.requests],
             mb.valid_steps, mb.spikes, mb.aged_out) for mb in mbs]


def scheduler_behaves_as_reference(ref, port, monkeypatch):
    """The same seeded streams through both schedulers, in wave mode and
    in continuous admission with an age-out: the same launches in the
    same order, bucket keys, members, valid steps and age-out flags, and
    padded trains equal in value, every padded entry an exact zero."""
    queues = {ref: RS.queue, port: PS.queue}
    for seed in (21, 22):
        stream = request_stream(seed)
        sides = []
        for mod in (ref, port):
            _, reqs, _ = submitted(queues[mod], stream, monkeypatch)
            sched = mod.ShapeBucketingScheduler(12, micro_batch=MICRO,
                                                min_bucket_steps=4)
            sched.set_model_input("b", 9)
            wave = sched.form_microbatches(reqs)
            cont = mod.ShapeBucketingScheduler(12, micro_batch=MICRO,
                                               min_bucket_steps=4,
                                               max_wait_ms=7.0)
            cont.set_model_input("b", 9)
            launched = []
            for i, req in enumerate(reqs):
                cont.admit(req)
                mb = cont.pop_launchable(now=(i + 1) * 1e-3)
                if mb is not None:
                    launched.append(mb)
            while cont.has_open():
                launched.append(cont.pop_launchable(force=True))
            sides.append((batches_of(wave), batches_of(launched)))
        for r_mbs, p_mbs in zip(*sides):
            assert len(p_mbs) == len(r_mbs) > 4
            for p, r in zip(p_mbs, r_mbs):
                assert p[:3] == r[:3] and p[5] == r[5]
                np.testing.assert_array_equal(p[3], r[3])
                assert p[4].dtype == np.uint8 and r[4].dtype == np.float32
                np.testing.assert_array_equal(p[4], r[4])
            for model, shape, ids, valid, spikes, _ in p_mbs:
                live = np.zeros(shape, bool)
                for b, v in enumerate(valid):
                    width = stream[ids[b]][0].shape[1] if b < len(ids) else 0
                    live[:v, b, :width] = True
                assert not spikes[~live].any()
        assert any(mb[5] for mb in sides[1][1])        # an age-out launched


#: host copies held by behaviour, where the port's carries uint8 spikes
BEHAVIOUR = {"repro_torch.serving.queue": queue_behaves_as_reference,
             "repro_torch.serving.scheduler": scheduler_behaves_as_reference}


@pytest.mark.parametrize("ref,port", [
    (RS.queue, PS.queue), (RS.scheduler, PS.scheduler),
    (RS.metrics, PS.metrics), (r_ft, p_ft),
    (RPL.grid, PPL.grid), (RPL.mapper, PPL.mapper), (RPL.tiling, PPL.tiling),
], ids=lambda m: m.__name__)
def test_host_copy_statements_equal_reference(ref, port, monkeypatch):
    """Statement for statement, but for the queue and the scheduler, which
    keep trains as uint8 and are held to the reference's behaviour."""
    if port.__name__ in BEHAVIOUR:
        BEHAVIOUR[port.__name__](ref, port, monkeypatch)
    else:
        assert _code(port) == _code(ref)


@pytest.fixture(scope="module")
def float_traffic_replies():
    """Seeded float32 traffic and the reference engine's replies to it."""
    reqs = traffic(12, seed=41)
    return reqs, serve("ref", reqs)[2]


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int32, np.float32])
def test_payload_dtypes_give_the_references_replies(dtype,
                                                    float_traffic_replies):
    """A payload of any of these dtypes is served as its 0/1 values: the
    replies equal the reference's to float32 payloads."""
    reqs, r_rep = float_traffic_replies
    _, _, p_rep, _ = serve("port", [(m, p, x.astype(dtype)) for m, p, x in reqs])
    assert_replies_equal(p_rep, r_rep)


@pytest.mark.parametrize("what,payload", MALFORMED, ids=[w for w, _ in MALFORMED])
def test_a_malformed_payload_is_refused_as_the_reference_refuses_it(
        what, payload):
    """The engine refuses it with the reference engine's ValueError, and
    nothing is queued."""
    port, _ = make_engine("port")
    ref, _ = make_engine("ref")
    with pytest.raises(ValueError) as p_err:
        port.submit(payload)
    with pytest.raises(ValueError) as r_err:
        ref.submit(payload)
    assert str(p_err.value) == str(r_err.value)
    assert port.queue.empty()
