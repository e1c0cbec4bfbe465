"""The port's host side equals the reference package's, array for array.

The graph IR, both paradigm compilers, the lowering, the serial form
choice, the paradigm dataset and AdaBoost are NumPy code that the port
keeps as its own copy; these tests hold each copy to the original on the
same seeds.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core.cost_model import DEFAULT_SERIAL_BATCH_COST as R_COST
from repro.core.runtime import lower_parallel as r_lower_parallel
from repro.core.runtime import lower_serial as r_lower_serial
from repro_torch.core.cost_model import DEFAULT_SERIAL_BATCH_COST as P_COST
from repro_torch.core.runtime import lower_parallel as p_lower_parallel
from repro_torch.core.runtime import lower_serial as p_lower_serial


def assert_same(a, b, where="value"):
    """Deep equality of two host objects: dataclasses field by field,
    arrays exactly (dtype included), containers item by item."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            if f.compare:
                assert_same(getattr(a, f.name), getattr(b, f.name),
                            f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


NETS = [
    ([2048, 20, 4], 0.0316, 1, 0),      # the gesture network
    ([60, 50, 40], 0.5, 4, 3),
    ([33, 17], 1.0, 8, 11),
]


@pytest.mark.parametrize("sizes,density,delay_range,seed", NETS)
def test_feedforward_network_weights_and_delays(sizes, density, delay_range, seed):
    rn = R.feedforward_network(sizes, density=density, delay_range=delay_range,
                               seed=seed)
    pn = P.feedforward_network(sizes, density=density, delay_range=delay_range,
                               seed=seed)
    assert len(rn.layers) == len(pn.layers)
    for rl, pl in zip(rn.layers, pn.layers):
        np.testing.assert_array_equal(rl.weights, pl.weights)
        np.testing.assert_array_equal(rl.delays, pl.delays)
        assert rl.delay_range == pl.delay_range
        assert_same(rl.character(), pl.character())
    assert rn.topo_order == pn.topo_order
    assert rn.input_slices == pn.input_slices


LAYERS = [
    (40, 30, 0.3, 4, "source"),
    (64, 48, 0.6, 1, "synapse"),
    (100, 80, 0.15, 8, "synapse"),
    (33, 17, 1.0, 3, "source"),
    (2048, 20, 0.0316, 1, "source"),
    (20, 10, 0.0, 2, "source"),         # empty layer
]


def _pair(ns, nt, dens, dr, gran, seed=0):
    return (
        R.random_layer(ns, nt, dens, dr, seed=seed, delay_granularity=gran),
        P.random_layer(ns, nt, dens, dr, seed=seed, delay_granularity=gran),
    )


@pytest.mark.parametrize("ns,nt,dens,dr,gran", LAYERS)
def test_compiled_programs_equal(ns, nt, dens, dr, gran):
    rl, pl = _pair(ns, nt, dens, dr, gran)
    assert_same(R.compile_serial(rl), P.compile_serial(pl), "serial")
    assert_same(R.compile_parallel(rl), P.compile_parallel(pl), "parallel")
    assert R.serial_pe_count(rl.character()) == P.serial_pe_count(pl.character())
    assert R.serial_pe_count_exact(rl) == P.serial_pe_count_exact(pl)
    assert R.parallel_pe_count_exact(rl) == P.parallel_pe_count_exact(pl)


@pytest.mark.parametrize("ns,nt,dens,dr,gran", LAYERS)
def test_lowered_operands_equal(ns, nt, dens, dr, gran):
    rl, pl = _pair(ns, nt, dens, dr, gran)
    rs = r_lower_serial(R.compile_serial(rl))
    ps = p_lower_serial(P.compile_serial(pl), device="cpu")
    for name in ("row_weight", "row_delay", "row_src", "row_tgt"):
        np.testing.assert_array_equal(np.asarray(getattr(rs, name)),
                                      getattr(ps, name).numpy(), err_msg=name)
        assert np.asarray(getattr(rs, name)).dtype == getattr(ps, name).numpy().dtype
    rp = r_lower_parallel(R.compile_parallel(rl))
    pp = p_lower_parallel(P.compile_parallel(pl), device="cpu")
    for name in ("wdm_stack", "col_source", "col_delay"):
        np.testing.assert_array_equal(np.asarray(getattr(rp, name)),
                                      getattr(pp, name).numpy(), err_msg=name)
        assert np.asarray(getattr(rp, name)).dtype == getattr(pp, name).numpy().dtype
    assert (rp.n_source, rp.n_target, rp.delay_range) == (
        pp.n_source, pp.n_target, pp.delay_range)


def test_choose_form_grid():
    """The three-way serial form choice, over (rows, S, T, D, B)."""
    assert R_COST.as_dict() == P_COST.as_dict()
    seen = set()
    for rows in (0, 3, 60, 1279, 20_000, 400_000):
        for s in (20, 300, 2048, 20_000):
            for t in (4, 20, 300, 5_000):
                for d in (1, 4, 16):
                    for b in (1, 2, 3, 8, 64, 256):
                        want = R_COST.choose_form(rows, s, t, d, b)
                        assert P_COST.choose_form(rows, s, t, d, b) == want, (
                            rows, s, t, d, b)
                        seen.add(want)
                        assert (P_COST.dense_fits(s, t, d)
                                == R_COST.dense_fits(s, t, d))
    assert seen == {"event", "sparse", "dense"}


GRID = dict(
    source_grid=(50, 300, 2048), target_grid=(10, 20, 100),
    density_grid=(0.03, 0.1, 0.5, 0.9), delay_grid=(1, 4), seed=0,
)


def test_dataset_and_adaboost_predictions_equal():
    rds, pds = R.generate_dataset(**GRID), P.generate_dataset(**GRID)
    assert_same(rds, pds, "dataset")
    rclf, racc = R.train_switch_classifier(rds, seed=0)
    pclf, pacc = P.train_switch_classifier(pds, seed=0)
    assert racc == pacc
    probe = np.random.default_rng(5).uniform(
        [10, 4, 0.0, 1], [3000, 400, 1.0, 16], (400, 4)
    )
    X = np.concatenate([rds.features, probe])
    np.testing.assert_array_equal(rclf.predict(X), pclf.predict(X))
    np.testing.assert_array_equal(rclf.decision_function(X),
                                  pclf.decision_function(X))
    # the classifier prejudges the gesture net's projections alike
    rn = R.feedforward_network([2048, 20, 4], density=0.0316, delay_range=1, seed=0)
    pn = P.feedforward_network([2048, 20, 4], density=0.0316, delay_range=1, seed=0)
    rr = R.SwitchingCompiler("classifier", rclf).compile_network(rn)
    pr = P.SwitchingCompiler("classifier", pclf).compile_network(pn)
    assert [l.paradigm for l in rr.layers] == [l.paradigm for l in pr.layers]
    assert rr.total_pes == pr.total_pes


@pytest.mark.parametrize("policy", ["serial", "parallel", "ideal"])
def test_switching_policies_equal(policy):
    rn = R.feedforward_network([2048, 20, 4], density=0.0316, delay_range=1, seed=0)
    pn = P.feedforward_network([2048, 20, 4], density=0.0316, delay_range=1, seed=0)
    rr = R.SwitchingCompiler(policy).compile_network(rn)
    pr = P.SwitchingCompiler(policy).compile_network(pn)
    for rc, pc in zip(rr.layers, pr.layers):
        assert (rc.paradigm, rc.predicted_label, rc.pe_count, rc.n_compilations,
                rc.host_bytes_peak) == (pc.paradigm, pc.predicted_label,
                                        pc.pe_count, pc.n_compilations,
                                        pc.host_bytes_peak)
        assert_same(rc.program, pc.program, policy)
