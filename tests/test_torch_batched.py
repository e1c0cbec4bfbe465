"""The port's batched and sharded launch paths and placement engine, held
against the reference package's.

``run_batched`` (and ``run(batched=True)``) of the port, on the CPU, must
give spike trains bit-identical to the reference's ``run_batched`` (a
``jax.vmap`` of width-1 scans) on ``test_batch_equivalence.py``'s
fixtures, masked lanes included, and record the same ``("vmap", B)``
forms.  ``shard()`` is the identity on one card; ``shard(assignment=)``
records ``report.placement`` and leaves the outputs unchanged.  The
placement engine's host copies (tiling, mapper, partition) must equal the
reference's on ``test_placement.py``'s and ``test_tiling.py``'s fixtures.
All weights are int8-magnitude integers, so equality is the tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as R
import repro.placement as RPL
import repro_torch.core as P
import repro_torch.placement as PPL
from repro.core.runtime import network_executable as r_network_executable
from repro.core.runtime import run_graph_reference as r_run_graph_reference
from repro_torch.core.runtime import network_executable
from repro_torch.distributed import snn_mesh, snn_rules
from test_batch_equivalence import GRAPHS, MIXES
from test_tiling import BUDGETS, GEOMETRIES
from test_torch_host import assert_same

T, BATCH = 12, 4


def _lif(mod):
    return mod.LIFParams(alpha=0.5, v_th=64.0)


def build_mix(mod, name):
    """``test_batch_equivalence.py``'s paradigm-mix chain in ``mod``."""
    paradigms, seed = MIXES[name]
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(12, 28)) for _ in range(len(paradigms) + 1)]
    layers = []
    for i in range(len(paradigms)):
        layer = mod.random_layer(
            sizes[i], sizes[i + 1],
            density=float(rng.uniform(0.2, 0.8)),
            delay_range=int(rng.integers(1, 7)),
            seed=int(rng.integers(0, 2**31)),
            delay_granularity=rng.choice(["source", "synapse"]),
        )
        layer.lif = _lif(mod)
        layers.append(layer)
    net = mod.SNNNetwork(layers=layers)
    return net, paradigms, rng


def build_graph(mod, name):
    """``test_batch_equivalence.py``'s recurrent geometry in ``mod``."""
    pop_spec, proj_spec, paradigms, seed = GRAPHS[name]
    rng = np.random.default_rng(seed)
    pops = {n: mod.Population(n, s) for n, s in pop_spec}
    projs = []
    for pre, post, density, delay_range in proj_spec:
        p = mod.random_projection(
            pops[pre], pops[post], density, delay_range,
            seed=int(rng.integers(0, 2**31)),
            delay_granularity=rng.choice(["source", "synapse"]),
        )
        p.lif = _lif(mod)
        projs.append(p)
    net = mod.SNNNetwork(populations=list(pops.values()), projections=projs,
                         name=name)
    return net, paradigms, rng


FIXTURES = [("mix", m) for m in sorted(MIXES)] + [
    ("graph", g) for g in sorted(GRAPHS)
]
_CACHE = {}


def fixture(kind, name):
    """Both packages' net, report and executable, the inputs, and the
    reference's ``run_batched`` trains (masked and unmasked)."""
    key = (kind, name)
    if key in _CACHE:
        return _CACHE[key]
    build = build_mix if kind == "mix" else build_graph
    sides = {}
    for tag, mod in (("ref", R), ("port", P)):
        net, paradigms, rng = build(mod, name)
        report = mod.CompileReport(layers=[
            mod.SwitchingCompiler(p).compile_layer(layer)
            for p, layer in zip(paradigms, net.layers)
        ])
        sides[tag] = (net, report, rng)
    rng = sides["ref"][2]
    n_in = sides["ref"][0].n_input
    spikes = (rng.random((T, BATCH, n_in)) < 0.3).astype(np.float32)
    # a full lane, two cut lanes and an empty (padded) lane
    valid = np.asarray(
        [T, int(rng.integers(1, T)), int(rng.integers(1, T)), 0], np.int32
    )
    net, report, _ = sides["ref"]
    rexe = r_network_executable(net, report)
    want = {
        "masked": [np.asarray(z) for z in rexe.run_batched(spikes, valid_steps=valid)],
        "unmasked": [np.asarray(z) for z in rexe.run_batched(spikes)],
    }
    pnet, preport, _ = sides["port"]
    pexe = network_executable(pnet, preport, device="cpu")
    _CACHE[key] = (report, pnet, preport, pexe, spikes, valid, want)
    return _CACHE[key]


def assert_trains_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.float32 and a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: output {i}")


@pytest.mark.parametrize("masked", ["masked", "unmasked"])
@pytest.mark.parametrize("kind,name", FIXTURES)
def test_run_batched_equals_reference_run_batched(kind, name, masked):
    """``run_batched`` and ``run(batched=True)`` against the reference's
    vmapped path, bit for bit; an empty lane emits exact zeros."""
    report, pnet, preport, exe, spikes, valid, want = fixture(kind, name)
    vs = valid if masked == "masked" else None
    outs = exe.run_batched(spikes, valid_steps=vs)
    assert all(isinstance(z, torch.Tensor) for z in outs)
    assert_trains_equal([z.numpy() for z in outs], want[masked], "run_batched")
    assert_trains_equal(exe.run(spikes, valid_steps=vs, batched=True),
                        want[masked], "run(batched=True)")
    if vs is not None:
        for z in outs:
            assert not z[:, 3].any()
    # the batched path is the fused loop: same bits as run_device
    assert_trains_equal(exe.run(spikes, valid_steps=vs), want[masked],
                        "run_device")
    key = ("vmap", BATCH)
    assert preport.serial_forms[key] == report.serial_forms[key]


def test_vmap_forms_recorded_separately_and_entries_counted():
    report, pnet, preport, exe, spikes, valid, _ = fixture("mix", "serial-first")
    exe.run(spikes, valid_steps=valid, batched=True)
    forms = preport.serial_forms[("vmap", BATCH)]
    assert forms == report.serial_forms[("vmap", BATCH)]
    assert all((f == "-") == (m.paradigm == "parallel")
               for f, m in zip(forms, exe.metas))
    # one entry a (path, forms), as the reference's jit cache keys them
    n = exe.jit_entries()
    exe.run(spikes[:5], valid_steps=valid, batched=True)
    assert exe.jit_entries() == n
    exe.run(spikes, serial_form="event")
    assert exe.jit_entries() == n + 1


def test_empty_serial_layer_survives_batched_path():
    """A serial layer with zero synaptic rows, on the batched path."""
    layer = P.random_layer(10, 8, density=0.4, delay_range=2, seed=0)
    layer.weights[:] = 0.0
    layer.lif = _lif(P)
    net = P.SNNNetwork(layers=[layer])
    report = P.CompileReport(
        layers=[P.SwitchingCompiler("serial").compile_layer(layer)])
    exe = network_executable(net, report, device="cpu")
    assert exe.metas[0].n_rows == 0
    outs = exe.run(np.ones((5, 3, 10), np.float32), batched=True)
    assert outs[0].shape == (5, 3, 8) and outs[0].sum() == 0


def test_shard_is_the_identity_on_one_card(monkeypatch):
    """``snn_mesh()`` is None here and ``shard()`` keeps every operand:
    same tensors, same outputs; the rules table resolves every axis."""
    assert snn_mesh() is None
    rules = snn_rules()
    for axis in ("batch", "neurons", "rows", "steps", "cols", None):
        assert axis in rules
    _, _, _, exe, spikes, valid, want = fixture("mix", "parallel-first")
    before = [tuple(map(id, p)) for p in exe.params]
    assert exe.shard() is exe
    assert exe.mesh is None
    assert [tuple(map(id, p)) for p in exe.params] == before
    assert_trains_equal(exe.run(spikes, valid_steps=valid, batched=True),
                        want["masked"], "sharded")
    assert exe.shard(rules=rules) is exe
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        exe.shard(mesh=object())
    # a host with two cards: the multi-card mesh is not ported
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        snn_mesh()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        exe.shard()


# -- placement ---------------------------------------------------------------

def build_tiling_net(mod, name):
    """``test_tiling.py``'s geometry in ``mod``."""
    pop_spec, proj_spec, seed = GEOMETRIES[name]
    rng = np.random.default_rng(seed)
    pops = {n: mod.Population(n, s) for n, s in pop_spec}
    projs = []
    for pre, post, density, delay_range in proj_spec:
        p = mod.random_projection(
            pops[pre], pops[post], density, delay_range,
            seed=int(rng.integers(0, 2**31)),
            delay_granularity=rng.choice(["source", "synapse"]),
        )
        p.lif = _lif(mod)
        projs.append(p)
    return mod.SNNNetwork(populations=list(pops.values()), projections=projs,
                          name=name), rng


def _tiled(mod, pl, name, max_neurons):
    net, rng = build_tiling_net(mod, name)
    return net, pl.tile_network(net, max_neurons=max_neurons), rng


def _same_tiling(rt, pt, name):
    assert rt.tiles_of == pt.tiles_of, name
    assert {k: dataclasses.astuple(v) for k, v in rt.tile_slices.items()} == {
        k: dataclasses.astuple(v) for k, v in pt.tile_slices.items()}, name
    assert rt.blocks_of == pt.blocks_of and rt.max_neurons == pt.max_neurons
    rn, pn = rt.network, pt.network
    assert [(p.name, p.size) for p in rn.populations] == [
        (p.name, p.size) for p in pn.populations]
    assert rn.endpoints == pn.endpoints and rn.back_edges == pn.back_edges
    for a, b in zip(rn.layers, pn.layers):
        np.testing.assert_array_equal(a.weights, b.weights)
        np.testing.assert_array_equal(a.delays, b.delays)
    for tile in pt.tile_slices:
        if pn.population_index(tile) not in pn.input_indices:
            assert_same(rt.tile_usage(tile), pt.tile_usage(tile), tile)


def _placements(pl, tiled, grid):
    traffic = pl.estimate_traffic(tiled)
    rr = pl.round_robin_place(tiled, grid, traffic)
    greedy = pl.greedy_place(tiled, grid, traffic)
    return traffic, rr, greedy, pl.refine(greedy, tiled, grid, traffic), \
        pl.place_network(tiled, grid)


def _same_placement(a, b, what):
    assert a.assignment == b.assignment, what
    assert a.cost == b.cost, what
    assert list(a.mapping) == list(b.mapping), what
    assert_same(a.core_usage, b.core_usage, what)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_tiling_and_mapper_equal_reference(geometry):
    """Tiles, blocks, tile usage, traffic, every placer's assignment and
    cut traffic, and the device partition at 1 and 4 devices."""
    budget = BUDGETS[geometry]
    rnet, rt, _ = _tiled(R, RPL, geometry, budget)
    pnet, pt, _ = _tiled(P, PPL, geometry, budget)
    _same_tiling(rt, pt, geometry)
    rgrid, pgrid = RPL.CoreGrid(rows=4, cols=4), PPL.CoreGrid(rows=4, cols=4)
    assert pgrid.budget == PPL.CoreGrid(rows=4, cols=4).budget
    rside, pside = _placements(RPL, rt, rgrid), _placements(PPL, pt, pgrid)
    np.testing.assert_array_equal(rside[0], pside[0])
    for what, a, b in zip(("rr", "greedy", "refine", "place"), rside[1:],
                          pside[1:]):
        _same_placement(a, b, what)
        for n in (1, 2, 4):
            ra = RPL.build_device_assignment(a, rt, rgrid, n_devices=n)
            pa = PPL.build_device_assignment(b, pt, pgrid, n_devices=n)
            assert ra.summary() == pa.summary(), (what, n)
            assert (ra.groups, ra.tile_device, ra.proj_device) == (
                pa.groups, pa.tile_device, pa.proj_device)
            assert [dataclasses.astuple(h) for h in ra.halo] == [
                dataclasses.astuple(h) for h in pa.halo]
    # measured rates and the activity check, on the same trains
    spikes = np.ones((4, 1, pnet.n_input), np.float32)
    outs = [np.zeros((4, 1, layer.n_target), np.float32)
            for layer in pnet.layers]
    rates = PPL.measured_rates(pnet, spikes, outs)
    assert rates == RPL.measured_rates(rnet, spikes, outs)
    np.testing.assert_array_equal(PPL.estimate_traffic(pt, rates),
                                  RPL.estimate_traffic(rt, rates))
    assert PPL.check_activity_budgets(
        pt, pside[4].assignment, pgrid.budget) == RPL.check_activity_budgets(
        rt, rside[4].assignment, rgrid.budget)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_tiled_net_outputs_equal_untiled_reference(geometry):
    """The port's tiled network, assembled back, equals the reference's
    unrolled oracle on the untiled net, fused, batched and sharded."""
    rnet, _, _ = _tiled(R, RPL, geometry, BUDGETS[geometry])
    pnet, pt, rng = _tiled(P, PPL, geometry, BUDGETS[geometry])
    tn = pt.network
    report = P.CompileReport(layers=[
        P.SwitchingCompiler("serial" if i % 2 else "parallel").compile_layer(l)
        for i, l in enumerate(tn.layers)
    ])
    exe = network_executable(tn, report, device="cpu")
    spikes = (rng.random((T, 3, pnet.n_input)) < 0.3).astype(np.float32)
    want = r_run_graph_reference(rnet, spikes)
    got = {"fused": exe.run(spikes), "vmap": exe.run(spikes, batched=True)}
    exe.shard()
    got["sharded"] = exe.run(spikes)
    for path, outs in got.items():
        assert_trains_equal(pt.assemble(outs), want, path)


def test_shard_assignment_records_placement_and_keeps_outputs():
    """``test_placement.py``'s bridge on the ``long-back-edge`` fixture:
    place, partition (one device), ``shard(assignment=)``, run."""
    sides = {}
    for tag, mod, pl in (("ref", R, RPL), ("port", P, PPL)):
        net, tiled, _ = _tiled(mod, pl, "long-back-edge", 6)
        grid = pl.CoreGrid(rows=4, cols=4)
        da = pl.build_device_assignment(
            pl.place_network(tiled, grid), tiled, grid, n_devices=1)
        tn = tiled.network
        report = mod.CompileReport(layers=[
            mod.SwitchingCompiler("serial" if i % 2 else "parallel")
            .compile_layer(l) for i, l in enumerate(tn.layers)
        ])
        sides[tag] = (net, tn, da, report)
    net, tn, da, report = sides["port"]
    assert da.summary() == sides["ref"][2].summary()
    assert da.is_identity
    rng = np.random.default_rng(42)
    spikes = (rng.random((10, 2, net.n_input)) < 0.3).astype(np.float32)
    rexe = r_network_executable(sides["ref"][1], sides["ref"][3])
    want = rexe.run(spikes)
    exe = network_executable(tn, report, device="cpu")
    assert_trains_equal(exe.run(spikes), want, "before")
    exe.run(spikes, serial_form="sparse")
    assert exe._sparse and exe.jit_entries() == 2
    ids = [tuple(map(id, p)) for p in exe.params]
    assert exe.shard(assignment=da) is exe
    assert report.placement is da
    assert [tuple(map(id, p)) for p in exe.params] == ids   # one device
    assert not exe._sparse and exe._tplan is None and exe.jit_entries() == 0
    assert_trains_equal(exe.run(spikes), want, "after")
    assert_trains_equal(exe.run(spikes, batched=True), want, "after, batched")
    short = dataclasses.replace(da, proj_device=da.proj_device[:-1])
    with pytest.raises(ValueError, match="projections"):
        exe.shard(assignment=short)
    two = dataclasses.replace(da, n_devices=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        exe.shard(assignment=two)
    assert report.placement is da
