"""The fused K4 and K2 entry points' plain versions, on the CPU.

``lif_fixed_point`` runs the iterative temporal mode's whole fixed point
(one launch on the card, each feature running its own passes) and
``spike_wdm_project`` the parallel projection's whole current (the ring
gather folded into the int8 product).  On the CPU both wrappers run their
plain versions; these tests hold those to the reference package
(``_temporal_iterative`` and ``parallel_project``, run as the reference's
own tests run them on the CPU), and hold NumPy models of the kernels'
algorithms to the plain versions: the per-feature stopping rule with its
max and sum, and the truncating-``%`` slot arithmetic made a floor-mod.
That is how the CPU checks what the kernels will do; the kernels
themselves are held to the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

With integer currents and integer weights every partial sum here is exact
at alpha 0.5, and the currents stay away from the threshold by more than
the reference's tree-ordered rounding at alpha 0.9, so the tolerance is
equality throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.parallel_compiler import compile_parallel as r_compile_parallel
from repro.core.runtime.parallel_runtime import lower_parallel as r_lower_parallel
from repro.core.runtime.parallel_runtime import parallel_project as r_parallel_project
from repro.core.runtime.temporal_runtime import _temporal_iterative as r_iterative
from repro_torch.core.parallel_compiler import compile_parallel
from repro_torch.core.runtime.parallel_runtime import (
    init_history,
    lower_parallel,
    parallel_project,
)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.lif_parallel_scan import (
    lif_fixed_point,
    lif_fixed_point_launch,
    lif_fixed_point_ref,
)
from repro_torch.kernels.spike_wdm_matmul import (
    spike_wdm_project,
    spike_wdm_project_ref,
)
from test_torch_cuda import fixed_point_operands

V_TH = 64.0


def np_fixed_point(i, alpha, v_th, cap):
    """The fused K4's algorithm in NumPy: every column runs its own passes
    (reset currents from its previous pass, the sequential f32 scan,
    threshold, flip count) and stops after a flip-free pass or at ``cap``.
    Returns ``(z, passes per column, last pass's flips per column)``; the
    kernel's outputs are ``z``, ``passes.max()`` and ``flips.sum()``."""
    steps, feat = i.shape
    a, th = np.float32(alpha), np.float32(v_th)
    z = np.zeros((steps, feat), np.float32)
    passes = np.zeros(feat, np.int64)
    flips = np.zeros(feat, np.int64)
    for f in range(feat):
        while True:
            zold = z[:, f].copy()
            zprev = np.float32(0.0)
            v = np.float32(0.0)
            for t in range(steps):
                c = np.float32(i[t, f] - np.float32(zprev * th))
                v = c if t == 0 else np.float32(np.float32(a * v) + c)
                z[t, f] = np.float32(v >= th)
                zprev = zold[t]
            passes[f] += 1
            flips[f] = int((z[:, f] != zold).sum())
            if flips[f] == 0 or passes[f] >= cap:
                break
    return z, passes, flips


def np_ring_columns(col_source, col_delay, t, depth, n_source):
    """The fused K2's gather addresses in NumPy, as the kernel computes
    them: C's truncating ``%`` with ``depth`` added back when negative."""
    slot = np.fmod(t - col_delay.astype(np.int64), depth)
    slot = np.where(slot < 0, slot + depth, slot)
    return slot * n_source + col_source


# -- K4: the fixed point ---------------------------------------------------------
@pytest.mark.parametrize("alpha", [0.5, 0.9])
@pytest.mark.parametrize("cap", [2, 5, None])
@pytest.mark.parametrize("shape", [(30, 24), (12, 7)])
def test_fixed_point_ref_matches_jax(shape, cap, alpha):
    """lif_fixed_point_ref against the reference's _temporal_iterative (the
    lax.while_loop over the associative-scan reference): same spikes,
    passes and residual, with a cap that cuts the loop and without."""
    i = fixed_point_operands(shape, seed=shape[0] + int(alpha * 10))
    cap = cap or shape[0] + 1
    z, iters, residual = lif_fixed_point_ref(
        torch.from_numpy(i), alpha=alpha, v_th=V_TH, cap=cap)
    rz, riters, rresidual = r_iterative(jnp.asarray(i), V_TH, alpha, cap, None)
    np.testing.assert_array_equal(z.numpy(), np.asarray(rz))
    assert (iters, residual) == (int(riters), int(rresidual))
    _, passes, _ = np_fixed_point(i, alpha, V_TH, shape[0] + 1)
    assert len(set(passes.tolist())) > 1        # columns settle apart
    if cap < passes.max():
        assert iters == cap and residual > 0
    else:
        assert iters == passes.max() and residual == 0


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.9])
@pytest.mark.parametrize("cap", [1, 2, 3, 6, None])
def test_fixed_point_model_matches_ref(alpha, cap):
    """The per-feature stopping rule gives the global loop's result: z,
    passes = min(cap, max of the columns' passes), residual = the sum of
    the last pass's flips."""
    i = fixed_point_operands((40, 16), seed=int(alpha * 10))
    cap = cap or 41
    z, iters, residual = lif_fixed_point_ref(
        torch.from_numpy(i), alpha=alpha, v_th=V_TH, cap=cap)
    mz, passes, flips = np_fixed_point(i, alpha, V_TH, cap)
    np.testing.assert_array_equal(z.numpy(), mz)
    assert iters == passes.max() == min(cap, passes.max())
    assert residual == flips.sum()


def test_fixed_point_wrapper_on_the_cpu_runs_the_plain_version():
    """The wrapper, its launch form and the plain version agree on the CPU;
    an empty train is one empty pass, as the plain loop makes it; a cap
    below 1 and a train that is not (T, F) are refused."""
    i = torch.from_numpy(fixed_point_operands((20, 9), seed=4))
    reset_launch_counts()
    want = lif_fixed_point_ref(i, alpha=0.5, v_th=V_TH, cap=3)
    got = lif_fixed_point(i, alpha=0.5, v_th=V_TH, cap=3)
    z, stats = lif_fixed_point_launch(i, alpha=0.5, v_th=V_TH, cap=3)
    assert torch.equal(got[0], want[0]) and torch.equal(z, want[0])
    assert got[1:] == want[1:] == tuple(stats.tolist())
    assert launch_counts()["lif_fixed_point"] == 0
    for shape in ((0, 5), (4, 0)):
        z, iters, residual = lif_fixed_point(torch.zeros(shape), alpha=0.5,
                                             v_th=V_TH, cap=5)
        assert z.shape == shape and (iters, residual) == (1, 0)
        assert lif_fixed_point_ref(torch.zeros(shape), alpha=0.5, v_th=V_TH,
                                   cap=5)[1:] == (1, 0)
    with pytest.raises(ValueError, match="cap"):
        lif_fixed_point(i, alpha=0.5, v_th=V_TH, cap=0)
    with pytest.raises(ValueError, match=r"\(T, F\)"):
        lif_fixed_point(i[None], alpha=0.5, v_th=V_TH, cap=2)


# -- K2: the projection with its ring gather ---------------------------------------
def projection_pair(ns, nt, density, delay_range, seed):
    """One layer lowered by both packages: (reference executable, port
    executable on the CPU)."""
    if delay_range == 0:        # the degenerate program: no WDM columns
        w, d = np.zeros((ns, nt)), np.ones((ns, nt), np.int64)
        rl = R.SNNLayer(weights=w, delays=d, delay_range=0)
        pl = P.SNNLayer(weights=w, delays=d, delay_range=0)
    else:
        rl = R.random_layer(ns, nt, density, delay_range, seed=seed)
        pl = P.random_layer(ns, nt, density, delay_range, seed=seed)
    rexe = r_lower_parallel(r_compile_parallel(rl))
    pexe = lower_parallel(compile_parallel(pl), device="cpu")
    np.testing.assert_array_equal(pexe.wdm_stack.numpy(), np.asarray(rexe.wdm_stack))
    return rexe, pexe


@pytest.mark.parametrize("delay_range", [0, 1, 4])
def test_project_ref_matches_jax(delay_range):
    """spike_wdm_project_ref, then the ring write, step by step against the
    reference's parallel_project current, for t from 0 past the ring depth
    (so the slots wrap around)."""
    rexe, pexe = projection_pair(40, 24, 0.3, delay_range, seed=delay_range)
    batch, depth = 3, pexe.ring_depth
    rng = np.random.default_rng(delay_range)
    x_hist = init_history(batch, depth, pexe.n_source, device="cpu")
    r_hist = jnp.zeros((rexe.ring_depth, rexe.n_source, batch), jnp.int8)
    fired = 0
    for t in range(3 * depth + 2):
        x_t = (rng.random((batch, pexe.n_source)) < 0.3).astype(np.float32)
        i_t = spike_wdm_project_ref(pexe.wdm_stack, pexe.col_source,
                                    pexe.col_delay, x_hist, t)
        x_hist, i_port = parallel_project(pexe.wdm_stack, pexe.col_source,
                                          pexe.col_delay, x_hist,
                                          torch.from_numpy(x_t), t)
        r_hist, r_i = r_parallel_project(rexe.wdm_stack, rexe.col_source,
                                         rexe.col_delay, r_hist,
                                         jnp.asarray(x_t), jnp.int32(t))
        assert i_t.dtype == torch.float32 and i_t.shape == (batch, pexe.n_target)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(r_i).T, err_msg=f"t={t}")
        np.testing.assert_array_equal(i_port.numpy(), i_t.numpy())
        np.testing.assert_array_equal(x_hist.numpy(),
                                      np.asarray(r_hist).transpose(2, 0, 1))
        fired += int(np.abs(i_t.numpy()).sum() > 0)
    assert fired > 0 or delay_range == 0


@pytest.mark.parametrize("depth", [1, 3, 4])
def test_project_model_matches_ref(depth):
    """The kernel's addressing (truncating % made a floor-mod) and an exact
    integer product give the plain version's current, for t from 0 to
    past 3 ring depths; t - delay < 0 occurs, so the floor-mod matters."""
    rng = np.random.default_rng(depth)
    batch, n_source, n_target, cols = 4, 11, 6, 29
    wdm = rng.integers(-128, 128, (n_target, cols)).astype(np.int8)
    col_source = rng.integers(0, n_source, cols).astype(np.int32)
    col_delay = rng.integers(1, depth + 1, cols).astype(np.int32)
    x_hist = (rng.random((batch, depth, n_source)) < 0.4).astype(np.int8)
    negative = 0
    for t in range(3 * depth + 1):
        addr = np_ring_columns(col_source, col_delay, t, depth, n_source)
        stacked = x_hist.reshape(batch, -1)[:, addr].astype(np.int64)
        want = (stacked @ wdm.astype(np.int64).T).astype(np.float32)
        got = spike_wdm_project_ref(*map(torch.from_numpy, (wdm, col_source,
                                                            col_delay, x_hist)), t)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"t={t}")
        negative += int((t - col_delay < 0).any())
    assert negative > 0
    # C's % alone (no floor-mod) would address outside the ring
    trunc = np.fmod(0 - col_delay.astype(np.int64), depth)
    assert depth == 1 or (trunc < 0).any()


def test_project_wrapper_on_the_cpu_runs_the_plain_version():
    _, pexe = projection_pair(40, 24, 0.3, 4, seed=4)
    x_hist = (torch.rand((2, pexe.ring_depth, pexe.n_source)) < 0.3).to(torch.int8)
    reset_launch_counts()
    for t in range(6):
        ops = (pexe.wdm_stack, pexe.col_source, pexe.col_delay, x_hist, t)
        assert torch.equal(spike_wdm_project(*ops), spike_wdm_project_ref(*ops))
    assert launch_counts()["spike_wdm_project"] == 0
