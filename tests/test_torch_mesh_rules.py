"""The port's sharding rules, mesh builders and int8 compression, held
against the reference package's; and the helpers the multi-rank test
files share.

``make_rules``, ``spec_for`` and ``spec_for_shape`` must give the
reference's specs on ``tests/test_distributed.py::TestShardingRules``'s
cases and over a hypothesis sweep of shapes, logical axes and mesh sizes
(a port spec is a tuple, the reference's a ``PartitionSpec``: they are
compared as tuples).  ``quantize`` and ``dequantize`` must be bitwise the
reference's, and hold
``tests/test_property.py::test_int8_compression_error_bound``.

The multi-rank files (``test_torch_mesh_snn.py``,
``test_torch_mesh_placement.py``) start their ranks with
:func:`start_ranks` (the file runs itself as ``python <file> --rank r``,
one gloo process a rank over a ``FileStore``, no network) and the
reference with :func:`start_reference` (a subprocess with four forced
host devices), once a module, and wait for both with :func:`finish`,
which fails on any rank's error or on the timeout.
"""
import argparse
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

import repro.distributed.sharding as RS
import repro_torch.distributed.sharding as PS
from repro.optim import compression as RC
from repro_torch.distributed import snn_mesh
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim import compression as PC

SRC = Path(__file__).resolve().parents[1] / "src"
TESTS = Path(__file__).resolve().parent
#: ranks of the multi-rank files, and the seconds a launch of them may take
WORLD = 4
RANK_TIMEOUT = 240


# -- multi-rank helpers ---------------------------------------------------------

def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), str(TESTS), env.get("PYTHONPATH", "")) if p)
    env.setdefault("JAX_PLATFORMS", "cpu")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def _start(argv, log: Path, extra=None):
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, *argv], env=_env(extra),
                                stdout=fh, stderr=subprocess.STDOUT,
                                cwd=str(TESTS.parent))
    return proc, log


def start_ranks(test_file: str, out: Path, world: int = WORLD):
    """``python <test_file> --rank r --world n --out <out>`` for each rank."""
    return [
        _start([str(test_file), "--rank", str(r), "--world", str(world),
                "--out", str(out)], out / f"rank{r}.log")
        for r in range(world)
    ]


def start_reference(module: str, func: str, out: Path, *args):
    """``module.func(out, *args)`` in a process with four host devices."""
    code = f"import {module} as m; m.{func}({str(out)!r}, *{args!r})"
    tag = "_".join(map(str, (func,) + args))
    return _start(["-c", code], out / f"{tag}.log",
                  {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})


def finish(started, timeout: float = RANK_TIMEOUT) -> None:
    """Wait for every process; on an error or the timeout end them all and
    fail with the logs."""
    deadline = time.monotonic() + timeout
    failed = []
    for proc, log in started:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            failed.append((log, rc))
    if failed:
        for proc, _ in started:
            proc.kill()
            proc.wait()
        raise AssertionError("\n".join(
            f"{log.name} ended {rc}:\n{log.read_text()[-6000:]}"
            for log, rc in failed))


def init_rank(argv):
    """Parse ``--rank --world --out`` and join the gloo process group."""
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(a.out / "store"), a.world),
        rank=a.rank, world_size=a.world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT // 2))
    return a.rank, a.world, a.out


def ref_shards(arr) -> dict:
    """A sharded reference array's block on each device id."""
    host = np.asarray(arr)
    return {d.id: host[idx]
            for d, idx in arr.sharding.devices_indices_map(arr.shape).items()}


# -- sharding rules ---------------------------------------------------------------

class FakeMesh:
    shape = {"pod": 2, "data": 16, "model": 16}


RULE_CASES = [
    # (make_rules kwargs, logical axes, shape, the spec as a tuple)
    (dict(multi_pod=True), ("batch", None), (256, 4096), (("pod", "data"), None)),
    (dict(multi_pod=True), ("layers", "batch", None, "heads", None),
     (8, 128, 2048, 1, 256), (None, ("pod", "data"), None, None, None)),
    (dict(multi_pod=True), ("layers", None, "heads"), (24, 768, 3352),
     (None, None, None)),
    # a prefix that fits reads as the bare name, as in JAX
    (dict(multi_pod=True), ("batch",), (2,), ("pod",)),
    (dict(fsdp=True), ("embed", "heads"), (4096, 4096), ("data", "model")),
]


@pytest.mark.parametrize("kw,axes,shape,want", RULE_CASES)
def test_spec_for_shape_on_the_reference_cases(kw, axes, shape, want):
    rules = PS.make_rules(**kw)
    assert rules == RS.make_rules(**kw)
    got = PS.spec_for_shape(axes, rules, shape, FakeMesh())
    assert got == want
    assert got == tuple(RS.spec_for_shape(axes, rules, shape, FakeMesh()))
    # the mesh may be a DeviceMesh's sizes or a plain dict
    assert PS.spec_for_shape(axes, rules, shape, FakeMesh.shape) == want


LOGICAL = ["batch", "vocab", "heads", "mlp", "expert", "expert_ff", "embed",
           "seq", "kv_seq", "layers", "neurons", "rows", "steps", "cols", None]


@given(
    dims=st.lists(st.tuples(st.sampled_from(LOGICAL), st.integers(1, 96)),
                  min_size=0, max_size=5),
    sizes=st.tuples(*[st.sampled_from([1, 2, 3, 4, 8, 16])] * 3),
    flags=st.tuples(st.booleans(), st.booleans(), st.booleans(),
                    st.sampled_from([None, "data", "model"])),
    snn=st.booleans(),
)
@settings(max_examples=200, deadline=None)
def test_specs_equal_the_reference_over_a_sweep(dims, sizes, flags, snn):
    """Random shapes, logical axes, mesh sizes and rule tables: the port's
    ``spec_for`` and fitted ``spec_for_shape`` are the reference's."""
    fsdp, multi_pod, kv, seq = flags
    rules = (PS.snn_rules() if snn else PS.make_rules(
        fsdp=fsdp, multi_pod=multi_pod, seq_axis=seq, kv_seq_shard=kv))
    mesh = dict(zip(("pod", "data", "model"), sizes))

    class Mesh:
        shape = mesh

    axes = tuple(a for a, _ in dims)
    shape = tuple(d for _, d in dims)
    assert PS.spec_for(axes, rules) == tuple(RS.spec_for(axes, rules))
    got = PS.spec_for_shape(axes, rules, shape, mesh)
    assert got == tuple(RS.spec_for_shape(axes, rules, shape, Mesh()))
    # every dim the fit splits divides by the product of its axes
    for part, dim in zip(got, shape):
        parts = () if part is None else (part,) if isinstance(part, str) else part
        assert dim % int(np.prod([mesh[a] for a in parts] or [1])) == 0


def test_tree_shardings_and_local_slices():
    """``tree_shardings`` gives ``(mesh, spec)`` per leaf of the spec tree;
    ``local_slices`` the block a coordinate holds, axes major to minor."""
    rules = PS.make_rules(multi_pod=True)
    specs = {"w": ("embed", "heads"), "b": [("batch", None), ("layers",)]}
    shapes = {"w": torch.empty(64, 32), "b": [torch.empty(64, 3),
                                               torch.empty(5)]}
    out = PS.tree_shardings(specs, shapes, FakeMesh.shape, rules)
    assert out["w"] == (FakeMesh.shape, (None, "model"))
    assert out["b"][0] == (FakeMesh.shape, (("pod", "data"), None))
    assert out["b"][1][1] == (None,)
    sl = PS.local_slices((("pod", "data"), None), (64, 3), FakeMesh.shape,
                         {"pod": 1, "data": 3, "model": 0})
    assert sl == (slice(38, 40), slice(0, 3))        # block 16 + 3 of 32


def test_snn_mesh_and_builders_refuse_without_a_process_group(monkeypatch):
    """With one card (or none) and no process group ``snn_mesh`` is the
    identity; with several it says to start one process a card; the mesh
    builders need a process group."""
    assert snn_mesh() is None
    assert snn_mesh(model_axis=3) is None              # a world of one
    t = torch.arange(3)
    assert PS.placement_put(t, 0) is t
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(multi_pod=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        snn_mesh()
    with pytest.raises(RuntimeError, match="one process a card"):
        PS.placement_put(t, 1)


# -- int8 compression -------------------------------------------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.normal(size=(5, 7)) * 3).astype(np.float32),
        "b": [rng.uniform(-1e4, 1e4, 13).astype(np.float32),
              np.zeros(4, np.float32),                    # amax 0: 1e-12
              (rng.normal(size=(3, 2)) * 1e-3).astype(np.float32)],
    }


@pytest.mark.parametrize("seed", range(4))
def test_quantize_and_dequantize_bitwise(seed):
    g = _grads(seed)
    for r, p in zip([g["w"], *g["b"]],
                    [torch.as_tensor(x) for x in [g["w"], *g["b"]]]):
        want = RC.quantize(jnp.asarray(r))
        got = PC.quantize(p)
        assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        assert got.scale.numpy().tobytes() == np.asarray(want.scale).tobytes()
        np.testing.assert_array_equal(PC.dequantize(got).numpy(),
                                      np.asarray(RC.dequantize(want)))
    tree = {k: torch.as_tensor(v) if k == "w" else [torch.as_tensor(x) for x in v]
            for k, v in g.items()}
    back = PC.decompress_tree(PC.compress_tree(tree))
    ref = RC.decompress_tree(RC.compress_tree(
        {"w": jnp.asarray(g["w"]), "b": [jnp.asarray(x) for x in g["b"]]}))
    np.testing.assert_array_equal(back["w"].numpy(), np.asarray(ref["w"]))
    for a, b in zip(back["b"], ref["b"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False), min_size=1, max_size=256))
@example(xs=[7998.194316088906, 8949.521484375])
@settings(max_examples=100, deadline=None)
def test_int8_compression_error_bound(xs):
    """``tests/test_property.py``'s bound, on the port, which must also be
    bitwise the reference.  The bound there, ``amax / 254 + 1e-6``, leaves
    out the f32 rounding of the dequantized value: the example above
    misses it by 3.7e-5 on both packages (``ROADMAP.md`` §3), so the bound
    here adds one f32 spacing at ``amax``."""
    x = np.asarray(xs, np.float32)
    c = PC.quantize(torch.as_tensor(x))
    ref = RC.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(ref.q))
    deq = PC.dequantize(c).numpy()
    np.testing.assert_array_equal(deq, np.asarray(RC.dequantize(ref)))
    err = np.abs(deq - x)
    amax = float(np.max(np.abs(x)))
    assert err.max() <= amax / 127.0 * 0.5 + 1e-6 + np.spacing(np.float32(amax))
