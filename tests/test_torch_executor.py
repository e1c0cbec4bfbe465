"""The port's fused executor against the reference package's.

``NetworkExecutable.run_device`` of the port (on the CPU, through the
kernels' plain versions) must give spike trains bit-identical to the
reference's ``run_device`` and to ``run_graph_reference`` on a chain, the
self-loop plus feedback graph of ``examples/recurrent_snn.py``, a fan-in
graph, a two-input graph and the paper's gesture network at full width
(2048-20-4, T = 50, B = 8) under three switching policies.  The same holds
when the port runs on the reference's own lowered operands
(``repro_torch.convert``).  All weights are int8-magnitude integers, so
every current is an exact f32 integer and equality is the tolerance.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.runtime import network_executable as jax_network_executable
from repro_torch.convert import executable_from_operands
from repro_torch.core.runtime import (
    OutputValidationError,
    lowering_counts,
    network_executable,
    release_network_executable,
    run_graph_reference,
    validate_spike_outputs,
)

#: Small geometries: (populations, projections (pre, post, density,
#: delay_range), paradigm per projection, seed).
GRAPHS = {
    "chain": (
        [("in", 20), ("a", 16), ("b", 10)],
        [("in", "a", 0.4, 3), ("a", "b", 0.5, 2)],
        ["parallel", "serial"],
        101,
    ),
    # examples/recurrent_snn.py: self-loop on hid, feedback out -> hid
    "recurrent": (
        [("in", 24), ("hid", 32), ("out", 10)],
        [("in", "hid", 0.4, 2), ("hid", "hid", 0.25, 3),
         ("hid", "out", 0.5, 2), ("out", "hid", 0.3, 1)],
        ["serial", "parallel", "serial", "parallel"],
        202,
    ),
    "fan-in": (
        [("in", 15), ("a", 12), ("b", 10), ("c", 8)],
        [("in", "a", 0.4, 2), ("in", "b", 0.3, 4), ("a", "c", 0.5, 1),
         ("b", "c", 0.5, 3)],
        ["serial", "parallel", "parallel", "serial"],
        303,
    ),
    "two-input": (
        [("in1", 10), ("in2", 8), ("h", 12), ("out", 6)],
        [("in1", "h", 0.5, 2), ("in2", "h", 0.4, 3), ("h", "out", 0.6, 2)],
        ["parallel", "serial", "serial"],
        404,
    ),
}

T_SMALL, B_SMALL = 14, 4


def build_graph(mod, name):
    """The geometry ``name`` in package ``mod`` (reference or port), its
    report with the paradigms forced, from the same seeds."""
    pop_spec, proj_spec, paradigms, seed = GRAPHS[name]
    rng = np.random.default_rng(seed)
    lif = mod.LIFParams(alpha=0.5, v_th=64.0)
    pops = {n: mod.Population(n, s) for n, s in pop_spec}
    projs = []
    for pre, post, density, delay_range in proj_spec:
        p = mod.random_projection(
            pops[pre], pops[post], density, delay_range,
            seed=int(rng.integers(0, 2**31)),
            delay_granularity=str(rng.choice(["source", "synapse"])),
        )
        p.lif = lif
        projs.append(p)
    net = mod.SNNNetwork(populations=list(pops.values()), projections=projs,
                         name=name)
    report = mod.CompileReport(layers=[
        mod.SwitchingCompiler(par).compile_layer(layer)
        for par, layer in zip(paradigms, net.layers)
    ])
    return net, report


def gesture(mod, policy):
    """The paper's gesture network (serve_snn.py) and its report."""
    net = mod.feedforward_network([2048, 20, 4], density=0.0316,
                                  delay_range=1, seed=0, name="gesture")
    for layer in net.layers:
        layer.lif = mod.LIFParams(alpha=0.5, v_th=64.0)
    return net, mod.SwitchingCompiler(policy).compile_network(net)


def inputs(n_input, steps, batch, seed, rate=0.3):
    rng = np.random.default_rng(seed)
    x = (rng.random((steps, batch, n_input)) < rate).astype(np.float32)
    valid = rng.integers(1, steps + 1, batch).astype(np.int32)
    valid[0] = steps
    return x, valid


def port_device(exe, x, **kw):
    return [z.numpy() for z in exe.run_device(x, **kw)]


def jax_device(exe, x, **kw):
    return [np.asarray(z) for z in exe.run_device(x, **kw)]


def assert_trains_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.float32 and a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: output {i}")


def held_to_reference(name, rnet, rrep, pnet, prep, x, valid):
    """Port == reference run_device == run_graph_reference, unmasked and
    masked; the serial-form records agree."""
    rexe = jax_network_executable(rnet, rrep)
    pexe = network_executable(pnet, prep, device="cpu")
    got = port_device(pexe, x)
    assert sum(int(z.sum()) for z in got) > 0, name
    assert_trains_equal(got, jax_device(rexe, x), f"{name} vs reference")
    assert_trains_equal(got, run_graph_reference(pnet, x), f"{name} vs oracle")
    masked = port_device(pexe, x, valid_steps=valid)
    assert_trains_equal(masked, jax_device(rexe, x, valid_steps=valid),
                        f"{name} masked vs reference")
    assert bool(pexe.last_check)
    assert prep.serial_forms == rrep.serial_forms
    return pexe, rexe, masked


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_matches_reference_run_device(name):
    rnet, rrep = build_graph(R, name)
    pnet, prep = build_graph(P, name)
    x, valid = inputs(pnet.n_input, T_SMALL, B_SMALL, seed=len(name))
    held_to_reference(name, rnet, rrep, pnet, prep, x, valid)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_masked_lanes_equal_their_solo_runs(name):
    """valid_steps: every lane's live prefix equals that request run
    alone, and its padded steps emit exact zeros."""
    pnet, prep = build_graph(P, name)
    x, valid = inputs(pnet.n_input, T_SMALL, B_SMALL, seed=7 + len(name))
    valid[-1] = 1
    exe = network_executable(pnet, prep, device="cpu")
    masked = port_device(exe, x, valid_steps=valid)
    for b, steps in enumerate(valid):
        solo = port_device(exe, x[:steps, b : b + 1])
        oracle = run_graph_reference(pnet, x[:steps, b : b + 1])
        for z, s, o in zip(masked, solo, oracle):
            np.testing.assert_array_equal(z[:steps, b : b + 1], s)
            np.testing.assert_array_equal(s, o)
            assert not z[steps:, b].any()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_converted_operands_reproduce_reference(name):
    """The port on the reference executable's own lowered operands."""
    rnet, rrep = build_graph(R, name)
    pnet, _ = build_graph(P, name)
    rexe = jax_network_executable(rnet, rrep)
    ops = [tuple(np.asarray(a) for a in p) for p in rexe.params]
    pexe = executable_from_operands(pnet, ops, device="cpu")
    x, valid = inputs(pnet.n_input, T_SMALL, B_SMALL, seed=11)
    for kw in ({}, {"valid_steps": valid}):
        assert_trains_equal(port_device(pexe, x, **kw), jax_device(rexe, x, **kw),
                            f"{name} converted {kw}")


@pytest.mark.parametrize("policy", ["serial", "parallel", "ideal"])
def test_gesture_full_width_matches_reference(policy):
    """2048-20-4 at T = 50 and a micro-batch of 8, as the server runs it:
    serial projections take the sparse (ELL gather) form at batch 8."""
    rnet, rrep = gesture(R, policy)
    pnet, prep = gesture(P, policy)
    x, valid = inputs(2048, 50, 8, seed=0, rate=0.2)
    pexe, rexe, masked = held_to_reference(
        f"gesture/{policy}", rnet, rrep, pnet, prep, x, valid
    )
    forms = prep.serial_forms[("fused", 8)]
    for layer, form in zip(prep.layers, forms):
        assert form == ("sparse" if layer.paradigm == "serial" else "-")
    for b in (0, 7):          # the longest lane and a padded one, alone
        steps = int(valid[b])
        solo = port_device(pexe, x[:steps, b : b + 1])
        for z, s in zip(masked, solo):
            np.testing.assert_array_equal(z[:steps, b : b + 1], s)
            assert not z[steps:, b].any()
    ops = [tuple(np.asarray(a) for a in p) for p in rexe.params]
    conv = executable_from_operands(pnet, ops, device="cpu")
    assert_trains_equal(port_device(conv, x, valid_steps=valid), masked,
                        f"gesture/{policy} converted")


def test_forced_forms_and_dense_cap():
    """A forced serial form is recorded; forcing dense over the cap raises."""
    pnet, prep = build_graph(P, "recurrent")
    exe = network_executable(pnet, prep, device="cpu")
    x, _ = inputs(pnet.n_input, 6, 2, seed=3)
    base = port_device(exe, x)
    for form in ("event", "sparse", "dense"):
        assert_trains_equal(port_device(exe, x, serial_form=form), base, form)
        assert prep.serial_forms[("fused", 2)] == tuple(
            form if l.paradigm == "serial" else "-" for l in prep.layers
        )
    with pytest.raises(ValueError, match="unknown serial_form"):
        exe.serial_forms(2, "bogus")
    big_net, big_rep = gesture(P, "serial")
    big = network_executable(big_net, big_rep, device="cpu")
    big.cost_model = type(big.cost_model)(dense_element_cap=1000)
    with pytest.raises(ValueError, match="exceeds"):
        big.serial_forms(8, "dense")


def test_executable_cache_and_release():
    """One lowering per projection per report and device, until released."""
    pnet, prep = build_graph(P, "chain")
    before = sum(lowering_counts().values())
    exe = network_executable(pnet, prep, device="cpu")
    assert network_executable(pnet, prep, device="cpu") is exe
    exe.run(np.zeros((3, 1, pnet.n_input), np.float32))
    assert sum(lowering_counts().values()) == before + len(prep.layers)
    assert release_network_executable(prep) == 1 + len(prep.layers)
    assert prep.executable is None
    assert network_executable(pnet, prep, device="cpu") is not exe
    assert sum(lowering_counts().values()) == before + 2 * len(prep.layers)


def test_validate_spike_outputs():
    good = [np.zeros((3, 2, 4), np.float32), np.ones((3, 2, 5), np.float32)]
    validate_spike_outputs(good, steps=3, batch=2, sizes=(4, 5))
    validate_spike_outputs([torch.from_numpy(a) for a in good], steps=3, batch=2)
    bad = [good[0], good[1] * 2]
    with pytest.raises(OutputValidationError, match="non-binary"):
        validate_spike_outputs(bad, steps=3, batch=2)
    nan = [good[0], np.full((3, 2, 5), np.nan, np.float32)]
    with pytest.raises(OutputValidationError, match="non-finite"):
        validate_spike_outputs(nan, steps=3, batch=2)
    with pytest.raises(OutputValidationError, match="shape"):
        validate_spike_outputs(good, steps=4, batch=2)
    with pytest.raises(OutputValidationError, match="float32"):
        validate_spike_outputs([good[0].astype(np.float64)], steps=3, batch=2)
    with pytest.raises(OutputValidationError, match="expected 3"):
        validate_spike_outputs(good, steps=3, batch=2, sizes=(4, 5, 6))


def test_convert_refuses_out_of_range_operands():
    rnet, rrep = build_graph(R, "chain")
    pnet, _ = build_graph(P, "chain")
    ops = [[np.array(a) for a in p] for p in jax_network_executable(rnet, rrep).params]
    executable_from_operands(pnet, ops, device="cpu")
    bad = [list(p) for p in ops]
    bad[1][2][0] = pnet.layers[1].n_source          # serial row_src
    with pytest.raises(ValueError, match="row_src outside"):
        executable_from_operands(pnet, bad, device="cpu")
    bad = [list(p) for p in ops]
    bad[0][2][0] = 0                                 # parallel col_delay
    with pytest.raises(ValueError, match="col_delay outside"):
        executable_from_operands(pnet, bad, device="cpu")
    with pytest.raises(ValueError, match="WDM"):
        executable_from_operands(pnet, [ops[0][:1] + [ops[0][1][:-1], ops[0][2][:-1]],
                                        ops[1]], device="cpu")
