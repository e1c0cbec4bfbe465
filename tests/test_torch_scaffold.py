"""The port's cerebellum scaffold and activity profiler, held against the
reference package's on the CPU.

The generator (``repro_torch.scaffold``) must give the byte-identical
network, stimulus and compile report the reference gives on the same seeds;
the generated 1.2k cerebellum and ``test_scaffold_equivalence.py``'s three
multi-input geometries must run bit-identically to the reference's launch
paths and to ``run_graph_reference`` on solo, fused, batched, sharded and
temporal (with the same ``report.temporal`` records); the profiler
(``repro_torch.core.runtime.profiler``) must equal the reference's,
rasters and ISI histograms included; and the serving engine must reply to
multi-input payloads as the reference's does.  Weights are int8-magnitude
integers, so equality is the tolerance throughout.
"""
import dataclasses
import hashlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.runtime as RR
import repro.scaffold as RS
import repro_torch.core as P
import repro_torch.core.runtime as PR
import repro_torch.scaffold as PS
from repro.serving import ServingEngine as RServingEngine
from repro_torch.serving import ServingEngine
from test_scaffold_equivalence import MULTI_INPUT_GRAPHS, _HASH_SNIPPET
from test_torch_host import assert_same
from test_torch_temporal import assert_same_record, build_fixture, fixture_spikes

#: (n_neurons, seed): the reference's determinism snippet, its oracle
#: fixture, and the scale benchmark's 10k size
BUILDS = [(500, 314), (1200, 90), (10_000, 2024)]
PATHS = ["solo", "fused", "vmap", "sharded", "temporal"]


def _network_digest(net) -> list:
    """Everything a built network holds, as comparable host values."""
    out = [net.name, [(p.name, p.size, p.lif and dataclasses.astuple(p.lif))
                      for p in net.populations],
           list(net.endpoints), list(net.back_edges), list(net.input_slices),
           list(net.topo_order)]
    for e in net.projections:
        out.append((e.name, e.n_source, e.n_target, e.delay_range,
                    dataclasses.astuple(e.lif)))
        for arr in (e.indptr, e.indices, e.values, e.delay_values):
            arr = np.asarray(arr)
            out.append((arr.dtype.str, arr.shape, arr.tobytes()))
    return out


@pytest.mark.parametrize("n,seed", BUILDS)
def test_build_cerebellum_byte_identical(n, seed):
    r, p = RS.build_cerebellum(n, seed=seed), PS.build_cerebellum(n, seed=seed)
    assert (r.n_neurons, r.seed, r.sizes, r.convergence, r.input_rates) == (
        p.n_neurons, p.seed, p.sizes, p.convergence, p.input_rates)
    assert (r.total_neurons, r.total_synapses) == (p.total_neurons,
                                                   p.total_synapses)
    assert_same(r.spec, p.spec, "spec")
    assert _network_digest(r.network) == _network_digest(p.network)
    assert RS.scaffold_policies(r.network) == PS.scaffold_policies(p.network)


def test_seed_determinism_across_processes_matches_reference():
    """The reference's hash snippet, run with the port in a fresh
    interpreter, prints the hash the reference gives in this one."""
    h = hashlib.sha256()
    sc = RS.build_cerebellum(500, seed=314)
    h.update(repr(sorted(sc.sizes.items())).encode())
    for e in sc.network.projections:
        for arr in (e.indptr, e.indices, e.values, e.delay_values):
            h.update(np.ascontiguousarray(arr).tobytes())
    snippet = _HASH_SNIPPET.replace("from repro.scaffold",
                                    "from repro_torch.scaffold")
    got = subprocess.run([sys.executable, "-c", snippet], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert got == h.hexdigest()


def test_generator_rejects_bad_knobs():
    with pytest.raises(ValueError, match="too small"):
        PS.build_cerebellum(30)
    bad = dataclasses.replace(PS.CEREBELLUM,
                              populations=PS.CEREBELLUM.populations[:-1])
    with pytest.raises(ValueError, match="sum to 1"):
        PS.build_cerebellum(1000, spec=bad)
    undriven = dataclasses.replace(PS.CEREBELLUM, projections=tuple(
        e for e in PS.CEREBELLUM.projections if e.post != "basket_stellate"))
    with pytest.raises(ValueError, match="undriven"):
        PS.build_cerebellum(1000, spec=undriven)


@pytest.mark.parametrize("rates", [None, 0.3, {"mossy": 0.5}, {"climbing": 1.0}])
def test_poisson_stimulus_equals_reference(rates):
    r, p = RS.build_cerebellum(500, seed=3), PS.build_cerebellum(500, seed=3)
    for steps, batch in ((0, 1), (7, 3)):
        want = RS.poisson_stimulus(r.network, steps, batch, seed=11, rates=rates)
        got = PS.poisson_stimulus(p.network, steps, batch, seed=11, rates=rates)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(p.stimulus(5, 2, seed=4), r.stimulus(5, 2, seed=4))
    for bad in (dict(steps=-1), dict(batch=0), dict(rates={"granule": 0.1}),
                dict(rates={"mossy": 1.5})):
        kw = dict(steps=3, batch=1, seed=0) | bad
        with pytest.raises(ValueError):
            RS.poisson_stimulus(r.network, **kw)
        with pytest.raises(ValueError):
            PS.poisson_stimulus(p.network, **kw)


# -- the generated 1.2k cerebellum on every launch path ------------------------
_CACHE = {}


def scaffold_pair():
    """Both packages' 1.2k cerebellum (``test_scaffold_equivalence.py``'s
    fixture), reports, executables, stimulus and masked oracle."""
    if "scaffold" not in _CACHE:
        sides = {}
        for tag, mod, rt, dev in (("ref", RS, RR, {}), ("port", PS, PR,
                                                         {"device": "cpu"})):
            sc = mod.build_cerebellum(1200, seed=90)
            report = mod.compile_scaffold(sc)
            sides[tag] = (sc, report, rt.network_executable(sc.network, report,
                                                             **dev))
        spikes = sides["port"][0].stimulus(10, 3, seed=91)
        valid = np.asarray([10, 6, 0], np.int32)
        _CACHE["scaffold"] = (sides, spikes, valid,
                              masked_oracle(sides["port"][0].network, spikes, valid))
    return _CACHE["scaffold"]


def masked_oracle(net, spikes, valid):
    """Each live lane alone through the port's unrolled NumPy oracle."""
    outs = [np.zeros(spikes.shape[:2] + (l.n_target,), np.float32)
            for l in net.layers]
    for b, n in enumerate(valid):
        if n:
            for dst, z in zip(outs, PR.run_graph_reference(net, spikes[:n, b:b + 1])):
                dst[:n, b] = z[:, 0]
    return outs


def launch(exe, path, spikes, valid):
    """``test_scaffold_equivalence._launch`` plus the temporal path; solo
    runs each lane alone and unmasked."""
    if path == "solo":
        return [np.concatenate([exe.run(spikes[:, b:b + 1])[i]
                                for b in range(spikes.shape[1])], axis=1)
                for i in range(len(exe.metas))]
    if path == "sharded":
        exe.shard()
    return [np.asarray(z) for z in exe.run(spikes, valid_steps=valid,
                                           batched=path == "vmap",
                                           temporal=path == "temporal")]


def assert_trains_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.float32 and a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: output {i}")


def test_compile_scaffold_equals_reference():
    sides, *_ = scaffold_pair()
    (_, rrep, _), (_, prep, _) = sides["ref"], sides["port"]
    assert len(rrep.layers) == len(prep.layers) == 8
    for rc, pc in zip(rrep.layers, prep.layers):
        assert (rc.layer_name, rc.paradigm, rc.predicted_label, rc.pe_count,
                rc.n_compilations, rc.host_bytes_peak) == (
            pc.layer_name, pc.paradigm, pc.predicted_label, pc.pe_count,
            pc.n_compilations, pc.host_bytes_peak)
        assert_same(rc.program, pc.program, rc.layer_name)
    assert rrep.total_pes == prep.total_pes
    with pytest.raises(ValueError, match="policies"):
        PS.compile_scaffold(sides["port"][0], policies=["serial"])


@pytest.mark.parametrize("path", PATHS)
def test_scaffold_paths_equal_reference_and_oracle(path):
    """The 1.2k cerebellum (CSR, mossy + climbing inputs, the recurrent
    Golgi loop) on every path: the port equals the reference's launch and
    the oracle; the temporal path records the reference's passes."""
    sides, spikes, valid, want = scaffold_pair()
    (rsc, rrep, rexe), (psc, prep, pexe) = sides["ref"], sides["port"]
    net = psc.network
    assert [p.name for p in net.input_populations] == ["mossy", "climbing"]
    assert net.back_edges
    vs = None if path == "solo" else valid
    got = launch(pexe, path, spikes, vs)
    ref = launch(rexe, path, spikes, vs)
    assert_trains_equal(got, ref, f"{path}: port against reference")
    oracle = PR.run_graph_reference(net, spikes) if path == "solo" else want
    assert_trains_equal(got, oracle, f"{path}: port against the oracle")
    if path == "temporal":
        key = (spikes.shape[1], spikes.shape[0])
        assert prep.temporal[key].split == (0, 2, 2)
        assert_same_record(prep.temporal[key], rrep.temporal[key])
        assert prep.serial_forms[("temporal", 3)] == rrep.serial_forms[("temporal", 3)]
    elif path != "solo":
        tag = ("vmap" if path == "vmap" else "fused", 3)
        assert prep.serial_forms[tag] == rrep.serial_forms[tag]


# -- test_scaffold_equivalence.py's multi-input geometries ----------------------
def multi_net(mod, rt, name, **dev):
    """``test_scaffold_equivalence._multi_net_for`` in package ``mod``,
    built once a package and geometry."""
    key = (mod.__name__, name)
    if key not in _CACHE:
        _CACHE[key] = _build_multi_net(mod, rt, name, **dev)
    return _CACHE[key]


def _build_multi_net(mod, rt, name, **dev):
    pop_spec, proj_spec, paradigms, seed = MULTI_INPUT_GRAPHS[name]
    rng = np.random.default_rng(seed)
    pops = {n: mod.Population(n, s) for n, s in pop_spec}
    projs = []
    for pre, post, density, delay_range in proj_spec:
        p = mod.random_projection(
            pops[pre], pops[post], density, delay_range,
            seed=int(rng.integers(0, 2**31)),
            delay_granularity=rng.choice(["source", "synapse"]),
        )
        p.lif = mod.LIFParams(alpha=0.5, v_th=64.0)
        projs.append(p)
    net = mod.SNNNetwork(populations=list(pops.values()), projections=projs,
                         name=name)
    report = mod.CompileReport(layers=[
        mod.SwitchingCompiler(p).compile_layer(l)
        for p, l in zip(paradigms, net.layers)
    ])
    spikes = (rng.random((12, 4, net.n_input)) < 0.3).astype(np.float32)
    valid = np.asarray([12, int(rng.integers(1, 12)), int(rng.integers(1, 12)), 0],
                       np.int32)
    return net, report, rt.network_executable(net, report, **dev), spikes, valid


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("graph", sorted(MULTI_INPUT_GRAPHS))
def test_multi_input_graphs_equal_reference(graph, path):
    rnet, rrep, rexe, spikes, valid = multi_net(R, RR, graph)
    pnet, prep, pexe, pspikes, pvalid = multi_net(P, PR, graph, device="cpu")
    np.testing.assert_array_equal(pspikes, spikes)
    np.testing.assert_array_equal(pvalid, valid)
    assert len(pnet.input_indices) >= 2
    vs = None if path == "solo" else valid
    got = launch(pexe, path, spikes, vs)
    assert_trains_equal(got, launch(rexe, path, spikes, vs), path)
    oracle = (PR.run_graph_reference(pnet, spikes) if path == "solo"
              else masked_oracle(pnet, spikes, valid))
    assert_trains_equal(got, oracle, f"{path}: oracle")
    if path == "temporal":
        key = (4, 12)
        assert_same_record(prep.temporal[key], rrep.temporal[key])


# -- the activity profiler ------------------------------------------------------
def assert_same_profile(p, r, names):
    assert p.as_dict() == r.as_dict()
    assert set(p.pop_counts) == set(r.pop_counts)
    for k in r.pop_counts:
        np.testing.assert_array_equal(p.pop_counts[k], r.pop_counts[k])
    if r.rasters is None:
        assert p.rasters is None
        return
    assert set(p.rasters) == set(r.rasters)
    for k in names:
        np.testing.assert_array_equal(np.asarray(p.rasters[k]),
                                      np.asarray(r.rasters[k]))
        np.testing.assert_array_equal(p.isi_histogram(k), r.isi_histogram(k))


@pytest.mark.parametrize("temporal", [False, True])
def test_scaffold_profile_run_equals_reference(temporal):
    """``profile_run`` on the 1.2k cerebellum: the same trains, the same
    profile (rates, peaks, traffic, rasters, ISI histograms), attached to
    the report, as the reference's."""
    sides, spikes, _, _ = scaffold_pair()
    (rsc, rrep, _), (psc, prep, _) = sides["ref"], sides["port"]
    names = [p.name for p in psc.network.populations]
    outs, prof = PR.profile_run(psc.network, prep, spikes, record_rasters=True,
                                device="cpu", temporal=temporal)
    routs, rprof = RR.profile_run(rsc.network, rrep, spikes, record_rasters=True,
                                  temporal=temporal)
    assert prep.activity is prof
    assert_trains_equal(outs, [np.asarray(z) for z in routs], "profile_run")
    assert_same_profile(prof, rprof, names)
    a, b = psc.network.input_slices[0]
    assert prof.total("mossy") == int(spikes[:, :, a:b].sum())


def test_profile_run_needs_a_device_or_the_cpu(monkeypatch):
    sides, spikes, _, _ = scaffold_pair()
    psc, prep, _ = sides["port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PR.profile_run(psc.network, prep, spikes)


@pytest.mark.parametrize("name", ["alpha0-mix", "count-chain"])
def test_profile_outputs_rasters_and_isi_equal_reference(name):
    """``test_temporal_equivalence.py``'s profiler cases: rasters off by
    default, on they keep the trains, and the ISI histograms and
    ``profile_run(temporal=)`` equal the reference's."""
    rnet, rrep = build_fixture(R, name)
    pnet, prep = build_fixture(P, name)
    spikes = fixture_spikes(name, pnet.n_input)
    outs = PR.run_graph_reference(pnet, spikes)
    names = [p.name for p in pnet.populations]
    plain = PR.profile_outputs(pnet, spikes, outs)
    assert plain.rasters is None
    with pytest.raises(ValueError, match="record_rasters"):
        plain.isi_histogram(names[1])
    assert_same_profile(plain, RR.profile_outputs(rnet, spikes, outs), names)
    prof = PR.profile_outputs(pnet, spikes, outs, record_rasters=True)
    assert_same_profile(prof, RR.profile_outputs(rnet, spikes, outs,
                                                 record_rasters=True), names)
    np.testing.assert_array_equal(prof.rasters[names[1]], outs[0])
    assert prof.isi_histogram(names[1])[0] == 0
    for temporal in (False, True):
        got, p = PR.profile_run(pnet, prep, spikes, record_rasters=not temporal,
                                device="cpu", temporal=temporal)
        want, r = RR.profile_run(rnet, rrep, spikes, record_rasters=not temporal,
                                 temporal=temporal)
        assert prep.activity is p
        assert_trains_equal(got, [np.asarray(z) for z in want], name)
        assert_same_profile(p, r, names)
    with pytest.raises(ValueError, match="spikes must be"):
        PR.profile_outputs(pnet, spikes[:, :, 1:], outs)


#: fixed examples of test_scaffold_property.py's profiler property:
#: (n_neurons, seed, steps)
PROFILE_EXAMPLES = [(80, 0, 1), (150, 12345, 5), (300, 2**31 - 1, 8)]


@pytest.mark.parametrize("n,seed,steps", PROFILE_EXAMPLES)
def test_profiler_counts_equal_oracle_sums(n, seed, steps):
    """Profiler counts are exactly ``np.sum`` over the oracle's trains, and
    the port's profile equals the reference's on the same trains."""
    psc, rsc = PS.build_cerebellum(n, seed=seed), RS.build_cerebellum(n, seed=seed)
    net = psc.network
    spikes = psc.stimulus(steps, 2, seed=seed ^ 0x5EED)
    outs = PR.run_graph_reference(net, spikes)
    assert_trains_equal(outs, RR.run_graph_reference(rsc.network, spikes), "oracle")
    prof = PR.profile_outputs(net, spikes, outs, record_rasters=True)
    assert (prof.steps, prof.batch) == (steps, 2)
    assert_same_profile(prof, RR.profile_outputs(rsc.network, spikes, outs,
                                                 record_rasters=True),
                        [p.name for p in net.populations])
    trains = {p.name: spikes[:, :, a:b]
              for p, (a, b) in zip(net.input_populations, net.input_slices)}
    for (_, post), z in zip(net.endpoints, outs):
        trains.setdefault(post, z)
    for name, z in trains.items():
        np.testing.assert_array_equal(prof.pop_counts[name], z.sum(axis=(1, 2)))
        t, c = prof.peak(name)
        assert prof.total(name) == int(z.sum()) and c == int(z[t].sum())
    for e, (pre, _) in zip(net.projections, net.endpoints):
        assert prof.proj_traffic[e.name] == pytest.approx(
            float(trains[pre].sum()) / (steps * 2))


# -- serving multi-input payloads --------------------------------------------------
def test_engine_multi_input_payloads_equal_reference_engine():
    """Concatenated two-input payloads through both engines: the same
    replies, bit for bit, equal to the oracle; a wrong width raises."""
    rnet, rrep, *_ = multi_net(R, RR, "two-source-fanin")
    pnet, prep, *_ = multi_net(P, PR, "two-source-fanin", device="cpu")
    rng = np.random.default_rng(77)
    requests = [(rng.random((int(rng.integers(4, 9)), pnet.n_input)) < 0.3
                 ).astype(np.float32) for _ in range(5)]
    engines = (RServingEngine(rnet, rrep, micro_batch=2, min_bucket_steps=4),
               ServingEngine(pnet, prep, micro_batch=2, min_bucket_steps=4,
                             device="cpu"))
    served = []
    for engine in engines:
        rids = [engine.submit(r) for r in requests]
        replies = engine.drain()
        assert set(replies) == set(rids)
        served.append([replies[rid] for rid in rids])
        with pytest.raises(ValueError):
            engine.submit(np.zeros((4, pnet.n_input + 3), np.float32))
    for r, want, got in zip(requests, *served):
        solo = PR.run_graph_reference(pnet, r[:, None, :])
        for a, b, o in zip(got, want, solo):
            np.testing.assert_array_equal(a, np.asarray(b))
            np.testing.assert_array_equal(a, o[:, 0])
