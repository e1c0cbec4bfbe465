"""Single-projection runtimes of the port against the reference package.

``run_reference``, ``run_serial`` and ``run_parallel`` of the port (on the
CPU, through the kernels' plain versions) must give spike trains bit-equal
to the reference's ``run_reference`` on the grid of
``tests/test_runtime_equiv.py``; the three serial forms, forced, must give
identical trains.  LIF parameters are dyadic (alpha=0.5, v_th=64) as in
that file, plus one non-dyadic alpha=0.9 case.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.runtime import run_reference as jax_run_reference
from repro_torch.core.runtime import (
    init_state,
    lower_serial,
    network_executable,
    run_network,
    run_network_layerwise,
    run_parallel,
    run_reference,
    run_serial,
    serial_step,
)

R_LIF = R.LIFParams(alpha=0.5, v_th=64.0)
P_LIF = P.LIFParams(alpha=0.5, v_th=64.0)


def make_pair(ns, nt, dens, dr, gran, seed=0):
    rl = R.random_layer(ns, nt, dens, dr, seed=seed, delay_granularity=gran)
    pl = P.random_layer(ns, nt, dens, dr, seed=seed, delay_granularity=gran)
    rl.lif, pl.lif = R_LIF, P_LIF
    return rl, pl


@pytest.mark.parametrize("gran", ["source", "synapse"])
@pytest.mark.parametrize("ns,nt,dens,dr", [
    (40, 30, 0.3, 4),
    (64, 48, 0.6, 1),
    (100, 80, 0.15, 8),
    (33, 17, 1.0, 3),
])
def test_three_executors_match_jax_reference(ns, nt, dens, dr, gran):
    rl, pl = make_pair(ns, nt, dens, dr, gran)
    spikes = (np.random.default_rng(1).random((24, 2, ns)) < 0.25).astype(np.float32)
    want = jax_run_reference(rl, spikes, R_LIF)
    assert want.sum() > 0
    for run in (run_reference, run_serial, run_parallel):
        got = run(pl, spikes, P_LIF, device="cpu")
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=run.__name__)


def test_non_dyadic_alpha_matches_jax_reference():
    """alpha=0.9: the membrane is no longer exact, the spikes still equal."""
    rl = R.random_layer(50, 40, 0.4, 3, seed=5)
    pl = P.random_layer(50, 40, 0.4, 3, seed=5)
    rl.lif, pl.lif = R.LIFParams(alpha=0.9, v_th=64.0), P.LIFParams(alpha=0.9, v_th=64.0)
    spikes = (np.random.default_rng(2).random((30, 3, 50)) < 0.3).astype(np.float32)
    want = jax_run_reference(rl, spikes)
    assert want.sum() > 0
    for run in (run_reference, run_serial, run_parallel):
        np.testing.assert_array_equal(run(pl, spikes, device="cpu"), want)


def test_empty_layer():
    _, pl = make_pair(20, 10, 0.0, 2, "source")
    spikes = np.ones((5, 1, 20), np.float32)
    for run in (run_serial, run_parallel, run_reference):
        z = run(pl, spikes, P_LIF, device="cpu")
        assert z.shape == (5, 1, 10) and z.sum() == 0


def test_delay_range_zero_parallel():
    """The degenerate delay_range == 0 program executes (ring depth >= 1)."""
    layer = P.SNNLayer(
        weights=np.zeros((12, 8)), delays=np.ones((12, 8), dtype=np.int64),
        delay_range=0, lif=P_LIF,
    )
    z = run_parallel(layer, np.ones((6, 2, 12), np.float32), P_LIF, device="cpu")
    assert z.shape == (6, 2, 8) and z.sum() == 0


@pytest.mark.parametrize("run", [run_parallel, run_serial])
def test_batch_consistency(run):
    """Batched execution == per-sample execution, and == the JAX oracle."""
    rl, pl = make_pair(30, 30, 0.4, 2, "source")
    spikes = (np.random.default_rng(3).random((10, 4, 30)) < 0.3).astype(np.float32)
    z_all = run(pl, spikes, P_LIF, device="cpu")
    np.testing.assert_array_equal(z_all, jax_run_reference(rl, spikes, R_LIF))
    for b in range(4):
        z_one = run(pl, spikes[:, b : b + 1], P_LIF, device="cpu")
        np.testing.assert_array_equal(z_all[:, b : b + 1], z_one)


def test_serial_step_keeps_the_consumed_current():
    """The ring slot is zeroed in place after it is read: the current the
    step hands to the LIF update must be a copy, not a view of the slot."""
    _, pl = make_pair(16, 8, 1.0, 1, "source")
    exe = lower_serial(P.compile_serial(pl), device="cpu")
    state = init_state(1, 8, exe.delay_range, device="cpu")
    x = torch.ones((1, 16))
    args = (exe.row_weight, exe.row_delay, exe.row_src, exe.row_tgt)
    kw = dict(delay_range=exe.delay_range, n_target=8, alpha=0.5, v_th=1e9)
    state, _ = serial_step(*args, state, x, 0, **kw)   # lands in slot 1
    state, _ = serial_step(*args, state, x * 0, 1, **kw)
    want = np.zeros(8, np.float32)
    np.add.at(want, exe.row_tgt.numpy(), exe.row_weight.numpy())
    np.testing.assert_array_equal(state.v[0].numpy(), want)
    assert not state.ring.any()


def test_serial_forms_give_identical_trains():
    """event, sparse and dense, forced, on a mixed serial/parallel chain."""
    layers = [P.random_layer(48, 40, 0.3, 4, seed=1),
              P.random_layer(40, 30, 0.5, 2, seed=2, delay_granularity="synapse"),
              P.random_layer(30, 12, 0.6, 3, seed=3)]
    for l in layers:
        l.lif = P_LIF
    net = P.SNNNetwork(layers=layers)
    report = P.CompileReport(layers=[
        P.SwitchingCompiler(par).compile_layer(l)
        for par, l in zip(["serial", "parallel", "serial"], layers)
    ])
    spikes = (np.random.default_rng(4).random((20, 3, 48)) < 0.3).astype(np.float32)
    exe = network_executable(net, report, device="cpu")
    runs = {f: exe.run(spikes, serial_form=f) for f in ("event", "sparse", "dense")}
    assert sum(int(z.sum()) for z in runs["event"]) > 0
    assert report.serial_forms[("fused", 3)] == ("dense", "-", "dense")
    for f in ("sparse", "dense"):
        for a, b in zip(runs["event"], runs[f]):
            np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(
        runs["event"][-1], run_network_layerwise(net, report, spikes, device="cpu")[-1]
    )
    np.testing.assert_array_equal(
        runs["event"][-1], run_network(net, report, spikes, device="cpu")[-1]
    )


def test_serial_step_wrappers_agree():
    """serial_step, serial_step_dense and serial_step_sparse, stepped by
    hand over the same train, equal the JAX oracle."""
    from repro_torch.core.runtime import (
        dense_serial_weights,
        serial_step_dense,
        serial_step_sparse,
        sparse_serial_operands,
    )

    rl, pl = make_pair(36, 20, 0.4, 3, "synapse", seed=6)
    spikes = (np.random.default_rng(6).random((16, 3, 36)) < 0.3).astype(np.float32)
    want = jax_run_reference(rl, spikes, R_LIF)
    exe = lower_serial(P.compile_serial(pl), device="cpu")
    ops = {
        "event": (exe.row_weight, exe.row_delay, exe.row_src, exe.row_tgt),
        "dense": (torch.from_numpy(dense_serial_weights(exe)),),
        "sparse": tuple(map(torch.from_numpy, sparse_serial_operands(exe))),
    }
    steps = {"event": serial_step, "dense": serial_step_dense,
             "sparse": serial_step_sparse}
    kw = dict(delay_range=exe.delay_range, n_target=20, alpha=0.5, v_th=64.0)
    x = torch.from_numpy(spikes)
    for form, step in steps.items():
        state = init_state(3, 20, exe.delay_range, device="cpu")
        zs = []
        for t in range(16):
            state, z = step(*ops[form], state, x[t], t, **kw)
            zs.append(z.numpy())
        np.testing.assert_array_equal(np.stack(zs), want, err_msg=form)
