"""The port's temporal-parallel launch path against the reference package's.

``NetworkExecutable.run_temporal`` of the port (on the CPU, through the
kernels' plain versions) must give spike trains bit-identical to the
reference's ``run_temporal``, to the port's ``run_device`` and to
``run_graph_reference`` on the five fixtures of
``tests/test_temporal_equivalence.py`` (one per reset-resolution mode, a
sparse iterative one and a recurrent hybrid), with the same launch record
(split, modes, fixed-point passes, residual) and the same forms.  The same
holds on the reference executable's own lowered operands
(``repro_torch.convert``) and for the paper's gesture network at full
width under three switching policies.

The reference resolves the iterative mode's affine scan as a tree
(``associative_scan``), the port in sequence; with integer weights and
these train lengths every partial sum of the fixtures is exact, so the
tolerance is equality throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.layer as RL
import repro.core.runtime as RR
import repro_torch.core as P
import repro_torch.core.layer as PL
import repro_torch.core.runtime as PR
from repro.core.switching import temporal_character as r_temporal_character
from repro_torch.convert import executable_from_operands
from repro_torch.core.switching import temporal_character as p_temporal_character
from test_temporal_equivalence import BATCH, FIXTURES, MODES, STEPS

_PKG = {R: RL, P: PL}


def build_fixture(mod, name):
    """Fixture ``name`` of the reference harness, built in package ``mod``
    from the same seeds, with its report (paradigms forced)."""
    pop_spec, proj_spec, paradigms, lif, sparse, seed = FIXTURES[name]
    layer = _PKG[mod]
    pops = {n: mod.Population(f"{name}.{n}", s) for n, s in pop_spec}
    make = layer.random_sparse_projection if sparse else layer.random_projection
    projs = []
    for i, (pre, post, density, dr, inhib) in enumerate(proj_spec):
        p = make(pops[pre], pops[post], density, dr, seed=seed + i,
                 inhibitory_fraction=inhib)
        p.lif = mod.LIFParams(alpha=lif.alpha, v_th=lif.v_th)
        projs.append(p)
    net = mod.SNNNetwork(populations=[pops[n] for n, _ in pop_spec],
                         projections=projs, name=name)
    report = mod.CompileReport(layers=[
        mod.SwitchingCompiler(par).compile_layer(l)
        for par, l in zip(paradigms, net.layers)
    ])
    return net, report


def fixture_spikes(name, n_input):
    rng = np.random.default_rng(FIXTURES[name][-1])
    return (rng.random((STEPS, BATCH, n_input)) < 0.3).astype(np.float32)


def port_temporal(exe, x, **kw):
    return [z.numpy() for z in exe.run_temporal(x, **kw)]


def jax_temporal(exe, x, **kw):
    return [np.asarray(z) for z in exe.run_temporal(x, **kw)]


def assert_trains_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.float32 and a.shape == b.shape, (what, i)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: output {i}")


def assert_same_record(p_rec, r_rec):
    """A port TemporalReport equals the reference's, field by field."""
    assert type(p_rec).__name__ == type(r_rec).__name__ == "TemporalReport"
    assert p_rec.split == r_rec.split
    assert p_rec.modes == r_rec.modes
    assert p_rec.iterations == {k: int(v) for k, v in r_rec.iterations.items()}
    assert p_rec.residual == {k: int(v) for k, v in r_rec.residual.items()}
    assert p_rec.max_iters == r_rec.max_iters
    assert p_rec.as_dict() == r_rec.as_dict()


def _pair(name):
    rnet, rrep = build_fixture(R, name)
    pnet, prep = build_fixture(P, name)
    rexe = RR.network_executable(rnet, rrep)
    pexe = PR.network_executable(pnet, prep, device="cpu")
    return rnet, rrep, rexe, pnet, prep, pexe


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_temporal_matches_reference(name):
    """Port run_temporal == reference run_temporal == port run_device ==
    run_graph_reference; same record and same forms."""
    rnet, rrep, rexe, pnet, prep, pexe = _pair(name)
    x = fixture_spikes(name, pnet.n_input)
    got = port_temporal(pexe, x)
    assert sum(float(z.sum()) for z in got) > 0, name
    assert_trains_equal(got, jax_temporal(rexe, x), f"{name} vs reference")
    assert_trains_equal(got, [z.numpy() for z in pexe.run_device(x)],
                        f"{name} vs run_device")
    assert_trains_equal(got, PR.run_graph_reference(pnet, x), f"{name} vs oracle")
    assert bool(pexe.last_check)
    rec = prep.temporal[(BATCH, STEPS)]
    assert_same_record(rec, rrep.temporal[(BATCH, STEPS)])
    if name != "hybrid-loop":
        assert set(rec.modes.values()) == {MODES[name]}
    for p, iters in rec.iterations.items():
        assert iters < rec.max_iters and rec.residual[p] == 0
    assert prep.serial_forms[("temporal", BATCH)] == rrep.serial_forms[
        ("temporal", BATCH)]
    assert pexe.run(x, temporal=True)[0].shape == got[0].shape


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_temporal_masking_matches_reference(name):
    """valid_steps on the temporal path: the fused contract, as the
    reference's masking test holds it, and the reference's own bits."""
    rnet, rrep, rexe, pnet, prep, pexe = _pair(name)
    x = fixture_spikes(name, pnet.n_input)
    valid = np.asarray([STEPS, 4, 0], np.int32)
    got = port_temporal(pexe, x, valid_steps=valid)
    assert_trains_equal(got, jax_temporal(rexe, x, valid_steps=valid),
                        f"{name} masked vs reference")
    assert_trains_equal(got, [z.numpy() for z in
                              pexe.run_device(x, valid_steps=valid)],
                        f"{name} masked vs run_device")
    for z in got:
        assert z[:, 2].sum() == 0
        assert z[4:, 1].sum() == 0


def test_max_iters_cap_matches_reference():
    """A one-pass cap: same (not converged) trains, same positive residual."""
    rnet, rrep, rexe, pnet, prep, pexe = _pair("iter-mix")
    x = fixture_spikes("iter-mix", pnet.n_input)
    got = port_temporal(pexe, x, max_iters=1)
    assert_trains_equal(got, jax_temporal(rexe, x, max_iters=1), "capped")
    rec = prep.temporal[(BATCH, STEPS)]
    assert_same_record(rec, rrep.temporal[(BATCH, STEPS)])
    assert rec.max_iters == 1
    assert all(v == 1 for v in rec.iterations.values())
    assert sum(rec.residual.values()) > 0


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_forced_temporal_forms_match_reference(form):
    rnet, rrep, rexe, pnet, prep, pexe = _pair("iter-sparse")
    x = fixture_spikes("iter-sparse", pnet.n_input)
    got = port_temporal(pexe, x, serial_form=form)
    assert_trains_equal(got, jax_temporal(rexe, x, serial_form=form), form)
    assert prep.serial_forms[("temporal", BATCH)] == rrep.serial_forms[
        ("temporal", BATCH)]
    assert set(prep.serial_forms[("temporal", BATCH)]) == {
        "temporal_sparse" if form == "sparse" else "temporal"}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_converted_operands_run_temporal(name):
    """The port on the reference executable's own lowered operands."""
    rnet, rrep, rexe, pnet, _, _ = _pair(name)
    ops = [tuple(np.asarray(a) for a in p) for p in rexe.params]
    prep = P.CompileReport(layers=[])
    conv = executable_from_operands(pnet, ops, report=prep, device="cpu")
    x = fixture_spikes(name, pnet.n_input)
    valid = np.asarray([STEPS, 6, 1], np.int32)
    for kw in ({}, {"valid_steps": valid}):
        assert_trains_equal(port_temporal(conv, x, **kw),
                            jax_temporal(rexe, x, **kw), f"{name} converted {kw}")
        assert_same_record(prep.temporal[(BATCH, STEPS)],
                           rrep.temporal[(BATCH, STEPS)])


# ---------------------------------------------------------------------------
# mode choice, the switching surface, the standalone functions


def test_choose_temporal_mode_matches_reference():
    for alpha in (0.0, 0.5, 0.9, 1.0):
        for v_th in (0.5, 1.0, 64.0, 64.5):
            for nonneg in (False, True):
                assert PR.choose_temporal_mode(
                    alpha, v_th, nonneg_weights=nonneg
                ) == RR.choose_temporal_mode(alpha, v_th, nonneg_weights=nonneg)
    assert PR.choose_temporal_mode(1.0, 64.0, nonneg_weights=True) == "count"
    assert PR.choose_temporal_mode(1.0, 64.0, nonneg_weights=False) == "iterative"


def test_count_ineligible_mixed_sign_matches_reference():
    """alpha == 1 with inhibitory synapses runs iterative in both packages,
    with the same bits, record and temporal character."""
    built = {}
    for mod in (R, P):
        a, b = mod.Population("ci.a", 12), mod.Population("ci.b", 10)
        p = mod.random_projection(a, b, 0.4, 2, seed=7, inhibitory_fraction=0.3)
        p.lif = mod.LIFParams(alpha=1.0, v_th=64.0)
        net = mod.SNNNetwork(populations=[a, b], projections=[p])
        report = mod.CompileReport(
            layers=[mod.SwitchingCompiler("serial").compile_layer(p)])
        built[mod] = (p, net, report)
    spikes = (np.random.default_rng(7).random((STEPS, 2, 12)) < 0.3).astype(
        np.float32)
    (rp, rnet, rrep), (pp, pnet, prep) = built[R], built[P]
    got = PR.network_executable(pnet, prep, device="cpu").run(spikes, temporal=True)
    want = RR.network_executable(rnet, rrep).run(spikes, temporal=True)
    assert_trains_equal(got, want, "mixed sign")
    assert_trains_equal(got, PR.run_graph_reference(pnet, spikes), "oracle")
    assert_same_record(prep.temporal[(2, STEPS)], rrep.temporal[(2, STEPS)])
    assert set(prep.temporal[(2, STEPS)].modes.values()) == {"iterative"}
    tc, rc = p_temporal_character(pp), r_temporal_character(rp)
    assert (tc["mode"], tc["exact"], tc["nonneg_weights"]) == (
        rc["mode"], rc["exact"], rc["nonneg_weights"]) == ("iterative", False, False)
    np.testing.assert_array_equal(tc["character"].as_features(),
                                  rc["character"].as_features())


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_temporal_character_matches_reference(name):
    rnet, _ = build_fixture(R, name)
    pnet, _ = build_fixture(P, name)
    for rl, pl in zip(rnet.layers, pnet.layers):
        rc, pc = r_temporal_character(rl), p_temporal_character(pl)
        assert {k: v for k, v in pc.items() if k != "character"} == {
            k: v for k, v in rc.items() if k != "character"}
        np.testing.assert_array_equal(pc["character"].as_features(),
                                      rc["character"].as_features())
        if name != "hybrid-loop":
            assert pc["mode"] == MODES[name]


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_temporal_step_standalone_matches_reference(alpha):
    """temporal_step (one projection + LIF over the whole train) against
    the reference's and against the sequential oracle, as the reference's
    standalone test builds it."""
    layer = P.random_layer(20, 16, density=0.4, delay_range=3, seed=11)
    layer.lif = P.LIFParams(alpha=alpha, v_th=64.0)
    rng = np.random.default_rng(11)
    spikes = (rng.random((24 if alpha == 0.0 else STEPS, 2, 20)) < 0.3).astype(
        np.float32)
    w = np.zeros((3 + 1, 20, 16), np.float32)
    s, n = np.nonzero(layer.connectivity())
    w[layer.delays[s, n], s, n] = layer.weights[s, n]
    z, iters, resid = PR.temporal_step(
        torch.from_numpy(w), torch.from_numpy(spikes), alpha=alpha, v_th=64.0)
    rz, riters, rresid = RR.temporal_step(w, spikes, alpha=alpha, v_th=64.0)
    np.testing.assert_array_equal(z.numpy(), np.asarray(rz))
    assert (iters, resid) == (int(riters), int(rresid))
    want = PR.run_reference(layer, spikes, device="cpu")
    np.testing.assert_array_equal(z.numpy(), np.asarray(want))
    if alpha == 0.0:
        assert (iters, resid) == (1, 0)


@pytest.mark.parametrize("mode,alpha,lo,hi", [
    ("alpha0", 0.0, -80, 200),
    ("count", 1.0, 0, 60),
    ("iterative", 0.5, -40, 120),
    ("iterative", 1.0, -40, 120),
])
def test_temporal_lif_matches_reference(mode, alpha, lo, hi):
    """Each reset-resolution mode on an integer current train (T 12, in
    the exact window), spikes and passes equal to the reference's."""
    seed = {"alpha0": 1, "count": 2, "iterative": 3}[mode] + int(alpha * 10)
    rng = np.random.default_rng(seed)
    i_full = rng.integers(lo, hi, size=(12, 3, 7)).astype(np.float32)
    z, iters, resid = PR.temporal_lif(torch.from_numpy(i_full), alpha=alpha,
                                      v_th=64.0, mode=mode)
    rz, riters, rresid = RR.temporal_lif(jnp.asarray(i_full), alpha=alpha,
                                         v_th=64.0, mode=mode)
    np.testing.assert_array_equal(z.numpy(), np.asarray(rz))
    assert (iters, resid) == (int(riters), int(rresid))
    assert float(z.sum()) > 0


def test_temporal_projections_match_reference():
    """Dense einsum and the single-launch sparse gather over T*B columns
    give the reference's (T, B, N) currents, delays shifted alike."""
    pnet, prep = build_fixture(P, "iter-sparse")
    rnet, rrep = build_fixture(R, "iter-sparse")
    pexe = PR.network_executable(pnet, prep, device="cpu")
    rexe = RR.network_executable(rnet, rrep)
    x = fixture_spikes("iter-sparse", pnet.n_input)
    meta = pexe.metas[0]
    val, idx = pexe._form_operands(0, "sparse")
    rval, ridx = rexe._sparse_param(0)
    sparse = PR.temporal_project_sparse(
        val, idx, torch.from_numpy(x), delay_range=meta.delay_range,
        n_target=meta.n_target).numpy()
    want = np.asarray(RR.temporal_project_sparse(
        rval, ridx, jnp.asarray(x), delay_range=meta.delay_range,
        n_target=meta.n_target))
    np.testing.assert_array_equal(sparse, want)
    (w,) = pexe._form_operands(0, "dense")
    dense = PR.temporal_project_dense(w, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(
        dense, np.asarray(RR.temporal_project_dense(np.asarray(w), jnp.asarray(x))))
    assert np.abs(want).sum() > 0


# ---------------------------------------------------------------------------
# the paper's gesture network at full width


def gesture(mod, policy):
    net = mod.feedforward_network([2048, 20, 4], density=0.0316,
                                  delay_range=1, seed=0, name="gesture")
    for layer in net.layers:
        layer.lif = mod.LIFParams(alpha=0.5, v_th=64.0)
    return net, mod.SwitchingCompiler(policy).compile_network(net)


@pytest.mark.parametrize("policy", ["serial", "parallel", "ideal"])
def test_gesture_full_width_temporal_matches_reference(policy):
    """2048-20-4, alpha 0.5, one micro-batch of 8 at T = 50: the port's
    run_temporal equals the reference's run_temporal and run_device, and
    the fixed-point passes per population are the reference's."""
    rnet, rrep = gesture(R, policy)
    pnet, prep = gesture(P, policy)
    rexe = RR.network_executable(rnet, rrep)
    pexe = PR.network_executable(pnet, prep, device="cpu")
    rng = np.random.default_rng(0)
    x = (rng.random((50, 8, 2048)) < 0.2).astype(np.float32)
    got = port_temporal(pexe, x)
    assert sum(float(z.sum()) for z in got) > 0
    assert_trains_equal(got, jax_temporal(rexe, x), f"{policy} vs reference")
    assert_trains_equal(got, [np.asarray(z) for z in rexe.run_device(x)],
                        f"{policy} vs reference run_device")
    rec = prep.temporal[(8, 50)]
    assert_same_record(rec, rrep.temporal[(8, 50)])
    assert set(rec.modes.values()) == {"iterative"}
    assert all(v == 0 for v in rec.residual.values())
    assert prep.serial_forms[("temporal", 8)] == rrep.serial_forms[("temporal", 8)]
