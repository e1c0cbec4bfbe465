"""The benchmark's frozen generator copies give the port's arrays byte for
byte, and the plain reference's trains equal the port's CPU path."""
import numpy as np
import pytest
import torch

from snnbench.tests.helpers import config, scaffold
from snnbench.configs import cerebellum, feedforward
from snnbench.reference import Simulator
from snnbench import system


def test_feedforward_copy_matches_port():
    from repro_torch.core import feedforward_network

    cfg = config("gesture")
    graph = feedforward.generate(cfg)
    net = feedforward_network(cfg["sizes"], density=cfg["density"],
                              delay_range=cfg["delay_range"], seed=cfg["seed"],
                              name=cfg["name"])
    for e, layer in zip(graph["projections"], net.layers):
        w, d = e["dense"]
        assert w.dtype == layer.weights.dtype and np.array_equal(w, layer.weights)
        assert np.array_equal(d, layer.delays)


@pytest.mark.parametrize("n", [1000, 10_000])
def test_cerebellum_copy_matches_port(n):
    from repro_torch.scaffold import build_cerebellum

    cfg = scaffold(n)
    graph = cerebellum.generate(cfg)
    sc = build_cerebellum(n, seed=cfg["seed"])
    assert [p["name"] for p in graph["populations"]] == [p.name for p in sc.network.populations]
    for q, p in zip(graph["populations"], sc.network.populations):
        assert q["size"] == p.size
        if p.lif is not None:
            assert (q["alpha"], q["v_th"]) == (p.lif.alpha, p.lif.v_th)
    for e, p in zip(graph["projections"], sc.network.projections):
        assert (e["pre"], e["post"], e["delay_range"]) == (p.pre, p.post, p.delay_range)
        for mine, theirs in (("indptr", p.indptr), ("indices", p.indices),
                             ("weights", p.values), ("delays", p.delay_values)):
            assert e[mine].dtype == theirs.dtype and np.array_equal(e[mine], theirs)


def _port_trains(graph, cfg, x, valid):
    from repro_torch.core.runtime import NetworkExecutable

    net = system.port_network(graph)
    reports, _ = system.compile_tenants(cfg, net)
    return {name: NetworkExecutable.build(net, rep, device="cpu").run(x, valid_steps=valid)
            for name, rep in reports.items()}


@pytest.mark.parametrize("which", ["gesture", "scaffold-1k"])
def test_reference_equals_port_cpu_path(which):
    rng = np.random.default_rng(7)
    if which == "gesture":
        cfg = dict(config("gesture"), tenants={"serial": {"compile": "serial"},
                                               "parallel": {"compile": "parallel"}})
        graph, rate = feedforward.generate(cfg), 0.2
    else:
        cfg = scaffold(1000)
        graph, rate = cerebellum.generate(cfg), 0.08
    sim = Simulator(graph)
    T, B = 40, 5
    x = (rng.random((T, B, sim.n_input)) < rate).astype(np.float32)
    valid = np.array([40, 33, 1, 0, 17], np.int32)
    x[np.arange(T)[:, None] >= valid[None, :]] = 0.0
    ref = [t.numpy() for t in sim.run(torch.as_tensor(x))]
    fired = 0
    for name, outs in _port_trains(graph, cfg, x, valid).items():
        assert len(outs) == len(graph["projections"])
        for j, z in enumerate(outs):
            want = ref[sim.post_of[j]]
            for b in range(B):
                assert np.array_equal(z[: valid[b], b], want[: valid[b], b]), (name, j, b)
                fired += int(want[: valid[b], b].sum())
    assert fired > 0
