"""The port's serving stack against the reference package's, on the CPU.

The same seeded traffic goes through ``repro.serving.ServingEngine`` (JAX
on the CPU) and ``repro_torch.serving.ServingEngine(device="cpu")``: two
small models, no deadlines, and only ``drain()`` / ``step_continuous()``,
so that no scheduling decision depends on the wall clock.  Replies must
be bitwise equal, and so must the scheduler's, the pool's and the
supervisor's counters, with and without a seeded fault storm.  The host
copies (queue, scheduler, metrics, fault tolerance, placement) are held
to the originals statement for statement.
"""
import ast
import asyncio
import inspect

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
    assert got.keys() == want.keys()
    for rid in want:
        a, b = got[rid], want[rid]
        assert type(a).__name__ == type(b).__name__ or (
            isinstance(a, list) and isinstance(b, list)), rid
        if isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
                np.testing.assert_array_equal(x, y)


STAT_KEYS = ("requests", "batches", "shed", "failed", "mean_batch_occupancy",
             "bucket_hits", "bucket_misses", "relowerings", "ageout_launches",
             "padding_overhead", "by_model")
#: Supervisor counters that do not read the wall clock.
SUP_KEYS = ("launch_attempts", "retries", "watchdog_stalls",
            "validation_failures", "degraded_launches", "breaker_skips",
            "bisections", "quarantined", "breakers", "breaker_trips",
            "breaker_probes", "open_breakers")


def assert_stats_equal(a, b):
    sa, sb = a.stats(), b.stats()
    for k in STAT_KEYS:
        assert sa[k] == sb[k], k
    for k in SUP_KEYS:
        assert sa["supervisor"][k] == sb["supervisor"][k], k
    assert a.pool.counters_by_model() == b.pool.counters_by_model()
    assert (a.pool.evictions, a.pool.revivals) == (
        b.pool.evictions, b.pool.revivals)


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


def _code(module):
    """The module's statements with every docstring dropped and the
    package name unified, as an AST dump."""
    tree = ast.parse(inspect.getsource(module).replace("repro_torch", "repro"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("ref,port", [
    (RS.queue, PS.queue), (RS.scheduler, PS.scheduler),
    (RS.metrics, PS.metrics), (r_ft, p_ft),
    (RPL.grid, PPL.grid), (RPL.mapper, PPL.mapper), (RPL.tiling, PPL.tiling),
], ids=lambda m: m.__name__)
def test_host_copy_statements_equal_reference(ref, port):
    assert _code(port) == _code(ref)
