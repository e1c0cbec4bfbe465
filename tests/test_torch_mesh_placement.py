"""``shard(assignment=)`` over four ranks, and the int8 all-reduces.

``test_placement.py``'s three recurrent fixtures (``skip-and-loop``,
``long-back-edge`` and ``self-loop``, tiled at their budgets, placed
round-robin on a 4 x 4 grid) are split over four devices by
``build_device_assignment``, whose device count defaults to the world's
four ranks, and run on four gloo processes (this file started as ``python
tests/test_torch_mesh_placement.py --rank r``): rank ``d`` keeps the
projections the plan gives device ``d`` and updates its tiles, and each
step a fired tile's row goes to every other device that the plan's halo
names.  Each path's trains must be bitwise the reference's **unsharded**
run (the reference's own ``shard(assignment=)`` over several devices
fails: ``ROADMAP.md`` §3), ``report.serial_forms`` and
``report.temporal`` the one-process run's, and the spike elements sent
must be the halo's rows, each ``(pre, dst_device)`` pair once a step.

``psum_compressed`` and ``ring_psum_int8`` on the four ranks must equal,
bitwise, the reference's under ``shard_map`` over a four-device ``pod``
axis (a subprocess with four forced host devices).
"""
import pickle
import sys

import numpy as np
import pytest

import repro.core as R
import repro.placement as RPL
import repro_torch.core as P
import repro_torch.placement as PPL
from repro.core.runtime import network_executable as r_network_executable
from test_tiling import BUDGETS
from test_torch_batched import _tiled
from test_torch_mesh_rules import (
    WORLD, finish, init_rank, start_ranks, start_reference,
)

GEOMETRIES = ("skip-and-loop", "long-back-edge", "self-loop")
PATHS = ("run_device", "run_batched", "valid_steps", "run_temporal")
T, BATCH = 12, 3
VALID = np.asarray([T, 5, 0], np.int32)


def placed(mod, pl, geometry, n_devices=None):
    """The tiled fixture, its report, its assignment and its spikes."""
    net, tiled, rng = _tiled(mod, pl, geometry, BUDGETS[geometry])
    grid = pl.CoreGrid(rows=4, cols=4)
    da = pl.build_device_assignment(
        pl.round_robin_place(tiled, grid), tiled, grid, n_devices=n_devices)
    tn = tiled.network
    report = mod.CompileReport(layers=[
        mod.SwitchingCompiler("serial" if i % 2 else "parallel").compile_layer(l)
        for i, l in enumerate(tn.layers)
    ])
    spikes = (rng.random((T, BATCH, net.n_input)) < 0.3).astype(np.float32)
    return tn, report, da, spikes


def launch(exe, path, spikes):
    if path == "run_device":
        return exe.run(spikes)
    if path == "run_batched":
        return exe.run(spikes, batched=True, serial_form="sparse")
    if path == "valid_steps":
        return exe.run(spikes, valid_steps=VALID, serial_form="event")
    return exe.run(spikes, valid_steps=VALID, temporal=True)


def records(report):
    return (dict(report.serial_forms),
            {k: v.as_dict() for k, v in report.temporal.items()})


def grads_for(rank):
    """Rank ``rank``'s gradient tree (f32 leaves; ``h`` runs in bf16)."""
    rng = np.random.default_rng(100 + rank)
    return {"w": (rng.normal(size=(6, 5)) * (rank + 1)).astype(np.float32),
            "b": [rng.uniform(-3, 3, 11).astype(np.float32),
                  np.zeros(3, np.float32)],
            "h": (rng.normal(size=(4, 4)) * 0.1).astype(np.float32)}


# -- the reference, on four host devices ----------------------------------------

def reference_compression(out):
    """The reference's psum_compressed and ring_psum_int8 under shard_map
    over a four-device ``pod`` axis."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as Spec

    from repro.distributed.compat import compat_shard_map
    from repro.optim.compression import psum_compressed, ring_psum_int8

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("pod",))
    trees = [grads_for(r) for r in range(WORLD)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    stacked["h"] = stacked["h"].astype(jnp.bfloat16)
    got = {}
    for name, fn in (("psum", lambda g: psum_compressed(g, "pod")),
                     ("ring", lambda g: ring_psum_int8(g, "pod", WORLD))):
        def body(tree, fn=fn):
            local = jax.tree.map(lambda x: x[0], tree)
            return jax.tree.map(lambda x: x[None], fn(local))

        res = compat_shard_map(body, mesh=mesh, in_specs=(Spec("pod"),),
                               out_specs=Spec("pod"), check_vma=False)(stacked)
        got[name] = [jax.tree.map(lambda x, r=r: np.asarray(
            x[r].astype(jnp.float32)), res) for r in range(WORLD)]
    with open(f"{out}/ref_compression.pkl", "wb") as fh:
        pickle.dump(got, fh)


# -- the port, one process a rank -------------------------------------------------

def rank_main(argv):
    import torch
    import torch.distributed as dist

    from repro_torch.core.runtime import NetworkExecutable
    from repro_torch.distributed import exchange
    from repro_torch.optim import psum_compressed, ring_psum_int8

    rank, world, out = init_rank(argv)
    res = {"cases": {}, "compression": {}}
    for geometry in GEOMETRIES:
        tn, report, da, spikes = placed(P, PPL, geometry)  # n_devices: world
        exe = NetworkExecutable.build(tn, report, device="cpu")
        assert exe.shard(assignment=da) is exe and report.placement is da
        case = {"summary": da.summary(), "trains": {}, "sent": {},
                "owned": [i for i, p in enumerate(exe.params) if p is not None],
                "halo_per_step": exe.halo_elements_per_step(BATCH)}
        for path in PATHS:
            exchange.reset_exchange_counts()
            case["trains"][path] = launch(exe, path, spikes)
            sent = exchange.exchange_counts()["send"]["elements"]
            total = torch.tensor([sent])
            dist.all_reduce(total)
            case["sent"][path] = int(total)
        case["records"] = records(report)
        if rank == 0:
            tn, report, _, spikes = placed(P, PPL, geometry, n_devices=1)
            one = NetworkExecutable.build(tn, report, device="cpu")
            for path in PATHS:
                launch(one, path, spikes)
            case["one"] = records(report)
        res["cases"][geometry] = case
    g = grads_for(rank)
    tree = {"w": torch.as_tensor(g["w"]),
            "b": [torch.as_tensor(x) for x in g["b"]],
            "h": torch.as_tensor(g["h"]).to(torch.bfloat16)}
    for name, fn in (("psum", lambda t: psum_compressed(t, None)),
                     ("ring", lambda t: ring_psum_int8(t, None, world))):
        out_tree = fn(tree)
        res["compression"][name] = {
            "w": out_tree["w"].numpy(),
            "b": [x.numpy() for x in out_tree["b"]],
            "h": out_tree["h"].to(torch.float32).numpy(),
            "h_dtype": str(out_tree["h"].dtype)}
    with open(out / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()


# -- the tests --------------------------------------------------------------------

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The ranks' and the compression oracle's records, and the
    reference's unsharded trains and records of every path (run here
    while the ranks run)."""
    out = tmp_path_factory.mktemp("mesh_placement")
    started = start_ranks(__file__, out) + [
        start_reference("test_torch_mesh_placement", "reference_compression",
                        out)]
    runs = {}
    for geometry in GEOMETRIES:
        tn, report, da, spikes = placed(R, RPL, geometry, n_devices=WORLD)
        exe = r_network_executable(tn, report)
        trains = {path: launch(exe, path, spikes) for path in PATHS}
        runs[geometry] = (da, trains, records(report))
    finish(started)
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    with open(out / "ref_compression.pkl", "rb") as fh:
        ref = pickle.load(fh)
    return ranks, ref, runs


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_assignment_over_four_ranks_equals_the_unsharded_reference(
        results, geometry, path):
    ranks, _, runs = results
    da, trains, recs = runs[geometry]
    want = trains[path]
    assert ranks[0]["cases"][geometry]["one"] == recs
    # the halo: each (pre, dst_device) pair once a step, a row of its tile
    pairs = {(h.pre, h.dst_device): h.n_bits for h in da.halo}
    per_step = BATCH * sum(pairs.values())
    assert per_step > 0
    owned = []
    for r, res in enumerate(ranks):
        case = res["cases"][geometry]
        assert case["summary"] == da.summary(), r
        for i, (a, b) in enumerate(zip(case["trains"][path], want)):
            assert a.dtype == np.float32 and a.shape == b.shape, (r, i)
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"rank {r} output {i}")
        assert len(case["trains"][path]) == len(want)
        assert case["records"] == ranks[0]["cases"][geometry]["one"], r
        assert case["halo_per_step"] == per_step, r
        assert case["sent"][path] == T * per_step, (r, path)
        assert case["owned"] == [j for j, d in enumerate(da.proj_device)
                                 if d == r], r
        owned += case["owned"]
    assert sorted(owned) == list(range(len(da.proj_device)))


def test_skip_and_loop_plan_is_the_logged_fault_fixture(results):
    """The fixture of ROADMAP.md §3's reference fault: 9 tiles, 36
    projections, 28 halo edges, 168 bits a step over four devices (130 of
    them distinct (pre, dst_device) rows)."""
    _, _, da, _ = placed(R, RPL, "skip-and-loop", n_devices=WORLD)
    assert len(da.tile_device) == 9 and len(da.proj_device) == 36
    assert len(da.halo) == 28 and da.halo_bits_per_step() == 168
    assert sum({(h.pre, h.dst_device): h.n_bits for h in da.halo}.values()) == 130
    assert results[0][0]["cases"]["skip-and-loop"]["summary"] == da.summary()


@pytest.mark.parametrize("name", ["psum", "ring"])
def test_int8_all_reduce_on_four_ranks_equals_the_reference(results, name):
    ranks, ref, _ = results
    for r, res in enumerate(ranks):
        got, want = res["compression"][name], ref[name][r]
        np.testing.assert_array_equal(got["w"], want["w"])
        for a, b in zip(got["b"], want["b"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["h"], want["h"])
        assert got["h_dtype"] == "torch.bfloat16"
        # every rank holds the same reduced tree
        np.testing.assert_array_equal(got["w"], ranks[0]["compression"][name]["w"])


if __name__ == "__main__":
    rank_main(sys.argv[1:])
