"""The event form's update half on the CPU: the plain sweep
(``event_scatter_ref``) and the rows' index by source
(``source_major_index``) that the CUDA kernel walks, each held to a NumPy
model, and the executor's routing between them.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here a NumPy model of its algorithm (walk the rows of each fired source
through ``row_ptr``) is held to the sweep on the same cases.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch.core.runtime import network_executable, serial_update, source_major_index
from repro_torch.kernels.event_scatter import event_scatter, event_scatter_ref


def projection(n_source, n_target, n_rows, delay_range, seed, silent=()):
    """Random rows in cell order (source-major in runs, not overall), int8
    weights, delays in 1..delay_range; sources in ``silent`` own no row."""
    rng = np.random.default_rng(seed)
    live = np.setdiff1d(np.arange(n_source), np.asarray(silent, np.int64))
    src = rng.choice(live, n_rows) if live.size else np.zeros(0, np.int64)
    # a few cells, each source-major within itself, as lower_serial leaves them
    cells = np.array_split(np.arange(n_rows), 3)
    src = np.concatenate([np.sort(src[c]) for c in cells]) if n_rows else src
    w = rng.integers(-127, 128, src.size).astype(np.float32)
    d = rng.integers(1, delay_range + 1, src.size).astype(np.int32)
    tgt = rng.integers(0, n_target, src.size).astype(np.int32)
    return [torch.from_numpy(a) for a in (w, d, src.astype(np.int32), tgt)]


def swept_model(w, d, src, tgt, x, t, d_slots, n_target):
    """NumPy: every row's spike times its weight, added at its slot."""
    x = np.asarray(x)
    out = np.zeros((x.shape[0], d_slots, n_target), np.float32)
    slot = (d.numpy().astype(np.int64) + t) % d_slots
    for b in range(x.shape[0]):
        np.add.at(out[b], (slot, tgt.numpy()), x[b, src.numpy()] * w.numpy())
    return out


def driven_model(w, d, tgt, row_ptr, x, t, d_slots, n_target):
    """NumPy model of the kernel: for each lane and fired source, its rows
    ``row_ptr[s] .. row_ptr[s + 1]`` added at their slots; silent sources
    are never read."""
    x = np.asarray(x)
    ptr = row_ptr.numpy()
    out = np.zeros((x.shape[0], d_slots, n_target), np.float32)
    for b, s in zip(*np.nonzero(x)):
        rows = slice(ptr[s], ptr[s + 1])
        slot = (d.numpy()[rows].astype(np.int64) + t) % d_slots
        np.add.at(out[b], (slot, tgt.numpy()[rows]), x[b, s] * w.numpy()[rows])
    return out


def spikes(batch, n_source, fired, seed):
    """(B, S) 0/1 spikes: ``fired`` is "none", "all" or a rate."""
    if fired == "none":
        return torch.zeros((batch, n_source))
    if fired == "all":
        return torch.ones((batch, n_source))
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((batch, n_source)) < fired).astype(np.float32))


CASES = [
    # (B, S, T, R, delay_range, fired, silent sources)
    (1, 40, 30, 500, 1, 0.2, ()),
    (3, 40, 30, 500, 4, 0.2, ()),
    (1, 70, 9, 900, 3, "none", ()),
    (3, 70, 9, 900, 2, "all", ()),
    (3, 50, 20, 300, 4, 0.5, (0, 7, 8, 9, 49)),
    (1, 5, 4, 0, 2, "all", ()),
]


@pytest.mark.parametrize("batch,n_source,n_target,n_rows,delay_range,fired,silent", CASES)
def test_the_sweep_and_the_driven_walk_equal_numpy(batch, n_source, n_target, n_rows,
                                                  delay_range, fired, silent):
    """The plain version equals the NumPy sweep bitwise, and so does the
    model of the kernel's walk over the source-major index, at every t
    across the ring's wrap; ``serial_update`` gives the same update with
    and without the index (on the CPU both sweep)."""
    w, d, src, tgt = projection(n_source, n_target, n_rows, delay_range, seed=n_rows)
    d_slots = delay_range + 1
    x = spikes(batch, n_source, fired, seed=batch)
    indexed = [a.clone() for a in (w, d, src, tgt)]
    row_ptr = source_major_index(*indexed, n_source=n_source)
    for t in range(2 * d_slots + 1):
        want = swept_model(w, d, src, tgt, x, t, d_slots, n_target)
        got = event_scatter_ref(w, d, src, tgt, x, t, d_slots=d_slots, n_target=n_target)
        assert got.shape == (batch, d_slots, n_target)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            driven_model(indexed[0], indexed[1], indexed[3], row_ptr, x, t, d_slots,
                         n_target), want)
        got = event_scatter(*indexed, row_ptr, x, t, d_slots=d_slots, n_target=n_target)
        np.testing.assert_array_equal(got.numpy(), want)
        for rows, ptr in ((indexed, row_ptr), ((w, d, src, tgt), None)):
            upd, shift = serial_update(*rows, ptr, x, t, delay_range=delay_range,
                                       n_target=n_target)
            assert shift == 0 and upd.shape == (d_slots, batch, n_target)
            np.testing.assert_array_equal(upd.numpy(), want.transpose(1, 0, 2))


@pytest.mark.parametrize("batch", [1, 3])
def test_an_input_edge_reads_a_strided_column_slice(batch):
    """An input edge's spikes are a column slice of the step's train: both
    versions read the slice as it is, not a copy."""
    n_source, n_target, delay_range = 60, 25, 4
    w, d, src, tgt = projection(n_source, n_target, 700, delay_range, seed=5)
    row_ptr = source_major_index(w, d, src, tgt, n_source=n_source)
    train = spikes(batch, 200, 0.3, seed=6)
    x = train[:, 70:130]
    assert x.stride() == (200, 1) and x.data_ptr() == train.data_ptr() + 70 * 4
    for t in (0, 3, 9):
        want = swept_model(w, d, src, tgt, x.contiguous(), t, delay_range + 1, n_target)
        np.testing.assert_array_equal(
            event_scatter(w, d, src, tgt, row_ptr, x, t, d_slots=delay_range + 1,
                          n_target=n_target).numpy(), want)
        np.testing.assert_array_equal(
            driven_model(w, d, tgt, row_ptr, x, t, delay_range + 1, n_target), want)


@pytest.mark.parametrize("n_source,n_rows,silent", [
    (40, 500, ()), (50, 300, (0, 7, 8, 9, 49)), (5, 0, ()), (1, 17, ()),
])
def test_the_index_gives_each_source_exactly_its_rows(n_source, n_rows, silent):
    """``row_ptr`` is int32, monotone, starts at 0 and ends at R; the rows
    are reordered in place (the same storage), source-major, and each
    source's block holds exactly its rows as a multiset of (weight, delay,
    target)."""
    rows = projection(n_source, 30, n_rows, 4, seed=n_source, silent=silent)
    before = [a.clone() for a in rows]
    ptrs = [a.data_ptr() for a in rows]
    row_ptr = source_major_index(*rows, n_source=n_source)
    assert [a.data_ptr() for a in rows] == ptrs
    ptr = row_ptr.numpy()
    assert row_ptr.dtype == torch.int32 and ptr.shape == (n_source + 1,)
    assert ptr[0] == 0 and ptr[-1] == n_rows and np.all(np.diff(ptr) >= 0)
    w, d, src, tgt = (a.numpy() for a in rows)
    w0, d0, src0, tgt0 = (a.numpy() for a in before)
    for s in range(n_source):
        block = slice(ptr[s], ptr[s + 1])
        assert np.all(src[block] == s)
        mine = src0 == s
        assert sorted(zip(w[block], d[block], tgt[block])) == \
            sorted(zip(w0[mine], d0[mine], tgt0[mine]))
        if s in silent:
            assert ptr[s] == ptr[s + 1]


def slabs(rows, n_slabs):
    """The rows split along their one axis into ``n_slabs`` contiguous
    slabs, each a copy, as ``shard(mesh=)`` gives each rank its own."""
    cuts = np.linspace(0, rows[0].shape[0], n_slabs + 1).astype(int)
    return [[a[lo:hi].clone() for a in rows] for lo, hi in zip(cuts, cuts[1:])]


@pytest.mark.parametrize("n_slabs", [2, 3])
@pytest.mark.parametrize("batch", [1, 3])
def test_a_slab_of_rows_indexed_alone_sums_to_the_whole(n_slabs, batch):
    """A rank's slab of rows is indexed over all the sources: each slab's
    walk through its own ``row_ptr`` is a partial update, and the partials
    sum (as the launch's all-reduce sums them) to the whole rows' sweep."""
    n_source, n_target, delay_range = 50, 20, 3
    rows = projection(n_source, n_target, 800, delay_range, seed=11, silent=(3, 4))
    x = spikes(batch, n_source, 0.3, seed=12)
    parts = slabs(rows, n_slabs)
    ptrs = [source_major_index(*part, n_source=n_source) for part in parts]
    assert [int(p[-1]) for p in ptrs] == [part[0].shape[0] for part in parts]
    for t in (0, 2, 5):
        want = swept_model(*rows, x, t, delay_range + 1, n_target)
        walked = sum(driven_model(w, d, tgt, ptr, x, t, delay_range + 1, n_target)
                     for (w, d, _, tgt), ptr in zip(parts, ptrs))
        np.testing.assert_array_equal(walked, want)
        summed = sum(event_scatter(*part, ptr, x, t, d_slots=delay_range + 1,
                                   n_target=n_target)
                     for part, ptr in zip(parts, ptrs))
        np.testing.assert_array_equal(summed.numpy(), want)


def test_the_executor_sweeps_on_the_cpu_and_leaves_the_rows_as_lowered():
    """Off the card the event form's operands carry no index: the rows stay
    in the order ``lower_serial`` left them, and the launch sweeps them."""
    layers = []
    for i, (a, b) in enumerate([(12, 10), (10, 6)]):
        layer = P.random_layer(a, b, density=0.5, delay_range=2 + i, seed=40 + i)
        layer.lif = P.LIFParams(alpha=0.5, v_th=64.0)
        layers.append(layer)
    net = P.SNNNetwork(layers=layers)
    report = P.CompileReport(layers=[P.SwitchingCompiler("serial").compile_layer(l)
                                     for l in net.layers])
    exe = network_executable(net, report, device="cpu")
    rows = [tuple(a.clone() for a in p) for p in exe.params]
    forms = exe.serial_forms(2, "event")
    params = exe._params_for(forms)
    assert all(len(p) == 5 and p[4] is None for p in params)
    x = (np.random.default_rng(2).random((6, 2, 12)) < 0.4).astype(np.float32)
    got = exe.run_device(x, serial_form="event")
    want = exe.run_device(x, serial_form="dense")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert [ops[4] for (_, kind), ops in exe._operands.items()
            if kind == "rows"] == [None, None]
    for p, q in zip(exe.params, rows):
        assert all(torch.equal(a, b) for a, b in zip(p, q))
