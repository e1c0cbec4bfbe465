"""``shard(mesh=)`` over four ranks, held against the reference's sharded
run on four host devices.

The four paradigm mixes of ``tests/test_batch_equivalence.py`` run on
meshes 4 x 1, 2 x 2 and 1 x 4 (``snn_mesh(model_axis=m)``) through
``run_device``, ``run_batched``, ``run_device`` with ``valid_steps`` and
``run_temporal`` (batch 4, 12 steps; the batched run forces the sparse
serial form and the masked run the event form, so every operand kind is
placed).  Four gloo processes run the port (this file started as ``python
tests/test_torch_mesh_snn.py --rank r``); three processes run the
reference, one a mesh, with ``--xla_force_host_platform_device_count=4``.
Both start once a module and cache their results under
``tmp_path_factory``.  For each case and rank ``r``:

* every operand this rank holds equals the reference's block on device
  ``r`` (its ``devices_indices_map``), the fit's replication included;
* the trains are bitwise the reference's (the integer weights make every
  current an exact f32 integer);
* ``report.serial_forms`` and ``report.temporal`` equal the one-process
  run's and the reference's;
* where no operand is split and the batch is not, no collective ran.

``test_mesh_builders_over_four_ranks`` holds ``snn_mesh``,
``make_host_mesh``, ``make_production_mesh`` and ``placement_put`` on the
same four ranks.
"""
import pickle
import sys

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from test_torch_batched import build_mix
from test_torch_mesh_rules import (
    WORLD, finish, init_rank, ref_shards, start_ranks, start_reference,
)

MIX_NAMES = ("serial-only", "parallel-only", "serial-first", "parallel-first")
#: model axis -> the (data, model) mesh of four ranks
MODEL_AXES = (1, 2, 4)
PATHS = ("run_device", "run_batched", "valid_steps", "run_temporal")
T, BATCH = 12, 4


def case_inputs(mod, name):
    """One mix's net, a fresh report, the spikes and the valid steps."""
    net, paradigms, rng = build_mix(mod, name)
    report = mod.CompileReport(layers=[
        mod.SwitchingCompiler(p).compile_layer(layer)
        for p, layer in zip(paradigms, net.layers)
    ])
    spikes = (rng.random((T, BATCH, net.n_input)) < 0.3).astype(np.float32)
    valid = np.asarray([T, 5, 9, 0], np.int32)
    return net, report, spikes, valid


def launch(exe, path, spikes, valid):
    if path == "run_device":
        return exe.run(spikes)
    if path == "run_batched":
        return exe.run(spikes, batched=True, serial_form="sparse")
    if path == "valid_steps":
        return exe.run(spikes, valid_steps=valid, serial_form="event")
    return exe.run(spikes, valid_steps=valid, temporal=True)


def records(report):
    return (dict(report.serial_forms),
            {k: v.as_dict() for k, v in report.temporal.items()})


# -- the reference, on four host devices ----------------------------------------

def reference_main(out, model_axis):
    """The reference's sharded runs of every mix on one mesh."""
    from repro.core.runtime import network_executable
    from repro.distributed.sharding import snn_mesh

    res = {}
    for name in MIX_NAMES:
        net, report, spikes, valid = case_inputs(R, name)
        exe = network_executable(net, report).shard(
            mesh=snn_mesh(model_axis=model_axis))
        trains = {p: launch(exe, p, spikes, valid) for p in PATHS}
        shards = {(i, "event"): [ref_shards(a) for a in p]
                  for i, p in enumerate(exe.params)}
        for kind, cache in (("dense", exe._dense), ("sparse", exe._sparse),
                            ("temporal", exe._temporal)):
            for i, ops in cache.items():
                ops = ops if isinstance(ops, tuple) else (ops,)
                shards[(i, kind)] = [ref_shards(a) for a in ops]
        res[name] = {"trains": trains, "shards": shards,
                     "records": records(report)}
    with open(f"{out}/ref{model_axis}.pkl", "wb") as fh:
        pickle.dump(res, fh)


# -- the port, one process a rank -------------------------------------------------

def builder_checks(rank):
    """What the mesh builders and the put give on this rank."""
    import torch

    from repro_torch.distributed import placement_put, snn_mesh
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    got = {}
    for m in MODEL_AXES:
        mesh = snn_mesh(model_axis=m)
        got[("snn_mesh", m)] = (tuple(mesh.shape), mesh.mesh_dim_names,
                                tuple(mesh.get_coordinate()))
    for m in (1, 2, 3):
        mesh = make_host_mesh(m)
        coord = mesh.get_coordinate()
        got[("host", m)] = (tuple(mesh.shape),
                            None if coord is None else tuple(coord))
    for kind, fn in (("snn_mesh 3", lambda: snn_mesh(model_axis=3)),
                     ("production", lambda: make_production_mesh()),
                     ("production multi", lambda: make_production_mesh(
                         multi_pod=True)),
                     ("put 4", lambda: placement_put(torch.ones(1), 4))):
        try:
            fn()
            got[kind] = None
        except (ValueError, RuntimeError) as err:
            got[kind] = (type(err).__name__, str(err))
    t = torch.arange(3)
    got["put"] = [placement_put(t, d) is t for d in range(WORLD)]
    return got


def rank_main(argv):
    import torch.distributed as dist

    from repro_torch.core.runtime import network_executable
    from repro_torch.distributed import exchange, snn_mesh
    from repro_torch.distributed.sharding import is_sharded

    rank, _, out = init_rank(argv)
    res = {"builders": builder_checks(rank), "cases": {}}
    for m in MODEL_AXES:
        mesh = snn_mesh(model_axis=m)
        for name in MIX_NAMES:
            net, report, spikes, valid = case_inputs(P, name)
            exe = network_executable(net, report, device="cpu").shard(mesh=mesh)
            case = {"trains": {}, "counts": {}}
            for path in PATHS:
                exchange.reset_exchange_counts()
                case["trains"][path] = launch(exe, path, spikes, valid)
                case["counts"][path] = exchange.exchange_counts()
            case["shards"] = {(i, "event"): [t.numpy() for t in p]
                              for i, p in enumerate(exe.params)}
            # under the reference's names: it keeps a parallel layer's
            # whole-train (d_slots, S, T) operand apart as "temporal"
            for (i, kind), ops in exe._operands.items():
                if kind in ("dense", "sparse"):
                    if kind == "dense" and exe.metas[i].paradigm == "parallel":
                        kind = "temporal"
                    case["shards"][(i, kind)] = [t.numpy() for t in ops]
            case["split"] = any(is_sharded(spec, mesh)
                                for specs in exe._specs.values()
                                for spec in specs)
            case["records"] = records(report)
            if rank == 0:
                net, report, spikes, valid = case_inputs(P, name)
                one = network_executable(net, report, device="cpu")
                for path in PATHS:
                    launch(one, path, spikes, valid)
                case["one"] = records(report)
            res["cases"][(name, m)] = case
    with open(out / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()


# -- the tests --------------------------------------------------------------------

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_snn")
    started = start_ranks(__file__, out) + [
        start_reference("test_torch_mesh_snn", "reference_main", out, m)
        for m in MODEL_AXES
    ]
    finish(started)
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    ref = {}
    for m in MODEL_AXES:
        with open(out / f"ref{m}.pkl", "rb") as fh:
            ref[m] = pickle.load(fh)
    return ranks, ref


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("model_axis", MODEL_AXES)
@pytest.mark.parametrize("mix", MIX_NAMES)
def test_sharded_run_equals_reference(results, mix, model_axis, path):
    ranks, ref = results
    want = ref[model_axis][mix]
    one = ranks[0]["cases"][(mix, model_axis)]["one"]
    assert one == want["records"]
    for r, res in enumerate(ranks):
        case = res["cases"][(mix, model_axis)]
        got = case["trains"][path]
        assert len(got) == len(want["trains"][path])
        for i, (a, b) in enumerate(zip(got, want["trains"][path])):
            assert a.dtype == b.dtype and a.shape == b.shape, (r, i)
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} output {i}")
        assert set(case["shards"]) == set(want["shards"]), r
        for key, blocks in case["shards"].items():
            for k, block in enumerate(blocks):
                w = want["shards"][key][k][r]
                assert block.dtype == w.dtype and block.shape == w.shape, (
                    r, key, k)
                np.testing.assert_array_equal(block, w,
                                              err_msg=f"rank {r} {key} {k}")
        assert case["records"] == one, r
        if not case["split"] and model_axis == WORLD:
            # every operand replicated over model and the batch whole:
            # replicated means no collective at all
            assert all(c["calls"] == 0
                       for c in case["counts"][path].values()), (r, path)


def test_mesh_builders_over_four_ranks(results):
    ranks, _ = results
    for r, res in enumerate(ranks):
        b = res["builders"]
        for m in MODEL_AXES:
            assert b[("snn_mesh", m)] == (
                (WORLD // m, m), ("data", "model"), (r // m, r % m))
        assert b[("host", 1)] == ((4, 1), (r, 0))
        assert b[("host", 2)] == ((2, 2), (r // 2, r % 2))
        # 3 does not divide 4: the first 3 ranks, as the reference's
        # devices[: data * model_parallel]
        assert b[("host", 3)] == ((1, 3), None if r == 3 else (0, r))
        assert b["snn_mesh 3"][0] == "ValueError"
        assert "need 256 ranks" in b["production"][1]
        assert "need 512 ranks" in b["production multi"][1]
        assert b["put 4"][0] == "ValueError"
        assert b["put"] == [d == r for d in range(WORLD)]


if __name__ == "__main__":
    rank_main(sys.argv[1:])
