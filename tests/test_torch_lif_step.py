"""K1's population step on the CPU: its plain version against the route it
replaced, a NumPy model of the kernel's per-element algorithm, and the
executor built on it against the reference package.

``lif_step_ref`` must be bitwise equal, on ``v``, ``z``, the spike row and
every delay ring, to the executor's old route op for op: each serial
edge's ``ring += roll(upd, shift)`` and copy-out-and-zero of its current
slot, the currents summed in in-edge order, the int8 spikes cast to f32,
the LIF update, and the casts back.  The NumPy model follows the CUDA
kernel (``csrc/lif_update.cu``) element by element: floor-mod slot
indices, the ring written slot by slot, the current slot read and zeroed
in place, one separately rounded f32 operation at a time, and past eight
in-edges the launches chained through the partial sum in the spike row.
The port's ``run_device`` on the CPU (which runs ``lif_step_ref``) must
stay bit-identical to the reference's ``run_device`` and to
``run_graph_reference``, also for a population with more in-edges than
one launch takes.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as P
from repro.core.runtime import network_executable as jax_network_executable
from repro_torch.core.runtime import network_executable, run_graph_reference
from repro_torch.kernels.lif_update import (
    MAX_EDGES,
    CurrentEdge,
    RingEdge,
    lif_step,
    lif_step_ref,
    lif_update_ref,
)
from test_torch_cuda import (
    EDGE_KINDS,
    assert_steps_equal,
    lif_step_operands,
    lif_step_tensors,
)
from test_torch_executor import (
    GRAPHS,
    assert_trains_equal,
    build_graph,
    gesture,
    held_to_reference,
    inputs,
    jax_device,
    port_device,
)

D_SLOTS = 3
#: rings up to this depth go through registers in the kernel (deliver<D>)
K_SLOTS = 8


def old_route(edges, v, z, out, t, *, alpha, v_th):
    """The executor's population step before the fused kernel, op for op:
    ``_roll_in`` (sparse, dense) or ``ring += upd`` (event), ``_consume``,
    the sum, the f32 cast of the int8 carry, ``lif_update``, the int8 cast
    and the copy into the output train."""
    i = None
    for e in edges:
        if isinstance(e, RingEdge):
            d_slots = e.ring.shape[0]
            if e.shift:
                e.ring.add_(torch.roll(e.upd, e.shift % d_slots, 0))
            else:
                e.ring.add_(e.upd)
            slot = t % d_slots
            i_e = e.ring[slot].clone()
            e.ring[slot] = 0.0
        else:
            i_e = e.i
        i = i_e if i is None else i + i_e
    v_new, z_new = lif_update_ref(i, v, z.to(torch.float32), alpha=alpha,
                                  v_th=v_th)
    v.copy_(v_new)
    z.copy_(z_new.to(torch.int8))
    out.copy_(z_new)


#: In-degree 1 (each kind), 3, and 9: one more than a launch takes.
KINDS = [(k,) for k in EDGE_KINDS] + [
    ("current", "sparse", "event"),
    ("dense", "current", "sparse"),
    ("current", "sparse", "current", "event", "current", "dense", "current",
     "sparse", "current"),
]


@pytest.mark.parametrize("t", [0, 1, 2 * D_SLOTS + 1])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("alpha", [0.5, 0.9])
@pytest.mark.parametrize("kinds", KINDS, ids=lambda k: "-".join(k))
def test_plain_step_equals_old_route(kinds, alpha, batch, t):
    """Bitwise on v, z, the spike row and every ring."""
    ops = lif_step_operands(kinds, batch, 20, D_SLOTS, seed=len(kinds) + t,
                            alpha=alpha)
    got = lif_step_tensors(ops, t, "cpu")
    want = lif_step_tensors(ops, t, "cpu")
    out = lif_step(*got, t, alpha=alpha, v_th=ops[3])
    assert out is got[3]
    old_route(*want, t, alpha=alpha, v_th=ops[3])
    assert_steps_equal(got, want)
    assert 0 < float(want[3].mean()) < 1


def kernel_launch(edges, v, z, out, t, alpha, v_th, fire):
    """One launch of the CUDA kernel in NumPy, one element k = b*N + n at a
    time (vectorised over k): per edge, its current through the strides, or
    the ring slots (d + shift) floor-mod d_slots updated for d = 0..d_slots-1
    and slot t floor-mod d_slots read and zeroed; the currents summed in
    order; then either the summed current written into ``out`` (``fire``
    false) or the separately rounded f32 fire into ``v``, ``z`` and
    ``out``.  ``edges`` hold flat f32 buffers and element strides; every
    buffer is updated in place."""
    batch, n = v.shape
    k = np.arange(batch * n)
    b, j = k // n, k % n
    f32 = np.float32
    i = np.zeros(batch * n, f32)
    for e, edge in enumerate(edges):
        if edge["ring"] is None:
            s1, s2 = edge["strides"][1:]
            cur = edge["upd"][b * s1 + j * s2]
        else:
            ring, d_slots, shift = edge["ring"], edge["d_slots"], edge["shift"]
            s0, s1, s2 = edge["strides"]
            plane = batch * n
            upd = lambda d: edge["upd"][d * s0 + b * s1 + j * s2]
            now = t - (t // d_slots) * d_slots                        # floor-mod
            if d_slots <= K_SLOTS:
                # deliver<D>: every slot and the update landing in it
                # loaded first, then the sums stored, the current one as 0
                s = shift - (shift // d_slots) * d_slots
                r = [ring[slot * plane + k].copy() for slot in range(d_slots)]
                u = [upd(slot - s if slot >= s else slot - s + d_slots)
                     for slot in range(d_slots)]
                for slot in range(d_slots):
                    x = r[slot] + u[slot]
                    if slot == now:
                        cur = x
                    ring[slot * plane + k] = f32(0.0) if slot == now else x
            else:
                # slot by slot: read-modify-write, then take and zero slot t
                for d in range(d_slots):
                    slot = (d + shift) - ((d + shift) // d_slots) * d_slots
                    at = slot * plane + k
                    ring[at] = ring[at] + upd(d)
                cur = ring[now * plane + k].copy()
                ring[now * plane + k] = f32(0.0)
        i = cur if e == 0 else (i + cur).astype(f32)
    if not fire:
        out.reshape(-1)[:] = i
        return
    vf, zf = v.reshape(-1), z.reshape(-1).astype(f32)
    vn = ((i + f32(alpha) * vf).astype(f32) - (zf * f32(v_th)).astype(f32)).astype(f32)
    fired = vn >= f32(v_th)
    v[:] = vn.reshape(batch, n)
    z[:] = fired.astype(np.int8).reshape(batch, n)
    out[:] = fired.astype(f32).reshape(batch, n)


def kernel_model(edges, v, z, t, alpha, v_th):
    """The wrapper's launches in NumPy: the first takes up to MAX_EDGES
    edges, each further one the spike row (the partial sum the one before
    wrote) and up to MAX_EDGES - 1 more, and only the last fires.  Returns
    (v, z, out) and updates the rings' buffers in place."""
    v, z = v.copy(), z.copy()
    out = np.full(v.shape, -1.0, np.float32)
    row = {"upd": out.reshape(-1), "strides": (0,) + (v.shape[1], 1), "ring": None}
    chunks = [edges[:MAX_EDGES]] + [
        [row] + edges[j:j + MAX_EDGES - 1]
        for j in range(MAX_EDGES, len(edges), MAX_EDGES - 1)]
    for c, chunk in enumerate(chunks):
        assert len(chunk) <= MAX_EDGES
        kernel_launch(chunk, v, z, out, t, alpha, v_th, c == len(chunks) - 1)
    return v, z, out


def flat_edges(edges):
    """Each torch edge as the kernel sees it: a flat buffer of its storage
    and the update's element strides."""
    def buffer(x):          # the storage from x's first element on
        n = x.untyped_storage().nbytes() // 4 - x.storage_offset()
        return x.as_strided((n,), (1,), x.storage_offset()).numpy().copy()

    flat = []
    for e in edges:
        if isinstance(e, RingEdge):
            flat.append({"upd": buffer(e.upd), "strides": e.upd.stride(),
                         "ring": e.ring.numpy().reshape(-1).copy(),
                         "d_slots": e.ring.shape[0], "shift": int(e.shift)})
        else:
            flat.append({"upd": buffer(e.i), "strides": (0,) + e.i.stride(),
                         "ring": None})
    return flat


@pytest.mark.parametrize("seed", range(9))
@pytest.mark.parametrize("alpha", [0.5, 0.9])
def test_kernel_model_equals_plain_step(seed, alpha):
    """Random rings, random in-edge mixes of up to eight edges (one launch;
    every third seed up to 24, chained launches), ring depths 1-8 (in
    registers) and 9-20 (slot by slot) and t far past them: the
    per-element model equals the plain step on v, z, the spike row and
    every ring."""
    rng = np.random.default_rng(seed)
    most = 3 * MAX_EDGES if seed % 3 == 2 else MAX_EDGES
    kinds = tuple(rng.choice(EDGE_KINDS, int(rng.integers(1, most + 1))))
    d_slots = int(rng.integers(*((1, 5), (5, 9), (9, 21))[seed % 3]))
    t = int(rng.integers(0, 50))
    ops = lif_step_operands(kinds, int(rng.integers(1, 9)), 13, d_slots,
                            seed=seed, alpha=alpha)
    edges, v, z, out = lif_step_tensors(ops, t, "cpu")
    model = flat_edges(edges)
    mv, mz, mout = kernel_model(model, v.numpy(), z.numpy(), t, alpha, ops[3])
    lif_step_ref(edges, v, z, out, t, alpha=alpha, v_th=ops[3])
    np.testing.assert_array_equal(mv.view(np.int32), v.numpy().view(np.int32))
    np.testing.assert_array_equal(mz, z.numpy())
    np.testing.assert_array_equal(mout, out.numpy())
    for e, m in zip(edges, model):
        if isinstance(e, RingEdge):
            np.testing.assert_array_equal(m["ring"].view(np.int32),
                                          e.ring.numpy().reshape(-1).view(np.int32))


def test_plain_step_without_in_edges():
    v = torch.tensor([[70.0, 10.0]])
    z = torch.tensor([[0, 1]], dtype=torch.int8)
    out = torch.empty(1, 2)
    lif_step([], v, z, out, 3, alpha=0.5, v_th=64.0)
    assert v.tolist() == [[35.0, -59.0]] and out.tolist() == [[0.0, 0.0]]
    assert z.tolist() == [[0, 0]]


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("form", ["event", "sparse", "dense"])
def test_graphs_every_serial_form_match_reference(name, form):
    """Every serial edge's update half (event: unshifted; sparse and dense:
    shifted by t) delivered by the population step: the port's run_device
    with the form forced equals the reference's and run_graph_reference,
    unmasked and masked."""
    rnet, rrep = build_graph(R, name)
    pnet, prep = build_graph(P, name)
    x, valid = inputs(pnet.n_input, 12, 3, seed=len(name) + len(form))
    rexe = jax_network_executable(rnet, rrep)
    pexe = network_executable(pnet, prep, device="cpu")
    oracle = run_graph_reference(pnet, x)
    for kw in ({}, {"valid_steps": valid}):
        got = port_device(pexe, x, serial_form=form, **kw)
        assert_trains_equal(got, jax_device(rexe, x, **kw), f"{name}/{form} {kw}")
        if not kw:
            assert_trains_equal(got, oracle, f"{name}/{form} vs oracle")
    assert prep.serial_forms[("fused", 3)] == tuple(
        form if l.paradigm == "serial" else "-" for l in prep.layers)


def test_gesture_classifier_mix_matches_reference():
    """The gesture net with the classifier report's paradigms (a parallel
    hidden projection, a serial output projection: one current edge and one
    ring edge) at T = 50 and a micro-batch of 8."""
    rnet, _ = gesture(R, "serial")
    pnet, _ = gesture(P, "serial")
    reps = [mod.CompileReport(layers=[
        mod.SwitchingCompiler(par).compile_layer(layer)
        for par, layer in zip(("parallel", "serial"), net.layers)])
        for mod, net in ((R, rnet), (P, pnet))]
    x, valid = inputs(2048, 50, 8, seed=5, rate=0.2)
    held_to_reference("gesture/classifier-mix", rnet, reps[0], pnet, reps[1],
                      x, valid)
    assert reps[1].serial_forms[("fused", 8)] == ("-", "sparse")


def wide_fan_in(mod, n_serial):
    """Input -> eight hidden populations -> one output population with nine
    in-edges (from the input and each hidden one), ``n_serial`` of them
    serial and the rest parallel."""
    rng = np.random.default_rng(505)
    lif = mod.LIFParams(alpha=0.9, v_th=12.0)
    pops = [mod.Population("in", 14)] + [mod.Population(f"h{j}", 6) for j in range(8)]
    pops.append(mod.Population("out", 5))
    specs = [(0, j, 0.5, 2) for j in range(1, 9)]
    specs += [(j, 9, 0.6, 1 + j % 3) for j in range(9)]
    projs = []
    for pre, post, density, delay_range in specs:
        p = mod.random_projection(pops[pre], pops[post], density, delay_range,
                                  seed=int(rng.integers(0, 2**31)))
        p.lif = lif
        projs.append(p)
    net = mod.SNNNetwork(populations=pops, projections=projs, name="wide")
    into_out = [i for i, (pre, post, *_) in enumerate(specs) if post == 9]
    serial = set(into_out[:n_serial])
    report = mod.CompileReport(layers=[
        mod.SwitchingCompiler("serial" if i in serial or i not in into_out
                              else "parallel").compile_layer(layer)
        for i, layer in enumerate(net.layers)])
    return net, report


@pytest.mark.parametrize("n_serial", [4, 9])
def test_population_with_more_in_edges_than_a_launch_takes(n_serial):
    """Nine in-edges into one population (four serial and five parallel, or
    all nine serial): the port stays bit-identical to the reference and to
    run_graph_reference."""
    rnet, rrep = wide_fan_in(R, n_serial)
    pnet, prep = wide_fan_in(P, n_serial)
    assert len(pnet.in_edges[9]) == MAX_EDGES + 1
    x, valid = inputs(pnet.n_input, 16, 3, seed=9, rate=0.4)
    held_to_reference("wide fan-in", rnet, rrep, pnet, prep, x, valid)
