"""The port's boundary: no JAX, nothing of ``repro``, no silent CPU fallback.

``repro_torch`` must import on a host without JAX or the reference package,
and every entry point must run on the CUDA card unless the caller asks for
the CPU: with no device given and no card visible it raises.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import SwitchingCompiler, feedforward_network
from repro_torch.core.runtime import (
    init_state,
    lower_parallel,
    lower_serial,
    network_executable,
    run_reference,
)
from repro_torch.core.parallel_compiler import compile_parallel
from repro_torch.core.serial_compiler import compile_serial
from repro_torch.kernels.lif_parallel_scan import lif_parallel_scan
from repro_torch.kernels.lif_update import CurrentEdge, lif_step, lif_update
from repro_torch.kernels.sparse_gather import sparse_gather
from repro_torch.kernels.spike_wdm_matmul import spike_wdm_matmul
from repro_torch.kernels.ssd_chunk import ssd_chunk
from repro_torch.launch import serve, train
from repro_torch.models import init as minit, model as lm
from repro_torch.configs import smoke_config

PKG = Path(repro_torch.__file__).resolve().parent


def test_import_leaves_jax_and_repro_out():
    """Importing the package and every submodule pulls in neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'repro_torch.core.runtime.temporal_runtime' in names\n"
        "assert 'repro_torch.kernels.lif_parallel_scan.ops' in names\n"
        "for m in ('kernels.ssd_chunk.ops', 'kernels.ssd_chunk.ref',\n"
        "          'models.config', 'models.init', 'models.blocks',\n"
        "          'models.model', 'configs.registry', 'configs.mamba2_130m',\n"
        "          'configs.musicgen_large', 'configs.kimi_k2_1t_a32b',\n"
        "          'configs.olmoe_1b_7b', 'configs.phi3_medium_14b',\n"
        "          'configs.llama3_2_3b', 'configs.qwen1_5_4b', 'configs.qwen3_8b',\n"
        "          'configs.recurrentgemma_2b', 'configs.phi3_vision_4_2b',\n"
        "          'launch.serve', 'serving.engine', 'serving.pool',\n"
        "          'serving.supervisor', 'serving.faults', 'placement.mapper',\n"
        "          'placement.partition', 'placement.tiling',\n"
        "          'distributed.sharding', 'distributed.fault_tolerance',\n"
        "          'scaffold.cerebellum', 'scaffold.stimulus',\n"
        "          'core.runtime.profiler', 'core.classifiers.zoo',\n"
        "          'core.classifiers.mlp', 'core.classifiers.simple',\n"
        "          'kernels.ssd_chunk.backward', 'data.pipeline', 'optim.adamw',\n"
        "          'checkpoint.manager', 'launch.steps', 'launch.train', 'tree',\n"
        "          'launch.shapes', 'launch.roofline', 'launch.dryrun',\n"
        "          'launch.hardware', 'launch.mesh', 'distributed.exchange',\n"
        "          'optim.compression', 'distributed.staged'):\n"
        "    assert 'repro_torch.' + m in names, m\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    src = str(PKG.parent)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 40          # every subpackage was walked


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 25
    for f in files:
        bad = {r for r in _imported_roots(f) if r in ("jax", "jaxlib", "repro")}
        assert not bad, f"{f.relative_to(PKG)} imports {sorted(bad)}"


@pytest.fixture
def no_card(monkeypatch):
    """A host where CUDA is not available, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _gesture_like():
    return feedforward_network([40, 12, 4], density=0.2, delay_range=2, seed=0)


def test_entry_points_raise_without_a_device(no_card):
    net = _gesture_like()
    report = SwitchingCompiler("ideal").compile_network(net)
    spikes = np.zeros((3, 1, 40), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        network_executable(net, report)
    assert report.executable is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_reference(net.layers[0], spikes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lower_serial(compile_serial(net.layers[0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lower_parallel(compile_parallel(net.layers[0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(1, 4, 2)
    cfg = smoke_config("mamba2-130m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-130m", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])                     # recurrentgemma-2b
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])     # mamba2-130m
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_caches(smoke_config("olmoe-1b-7b"), 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minit.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_caches(cfg, 1, 8)
    # asked for, the CPU runs
    exe = network_executable(net, report, device="cpu")
    assert exe.device == torch.device("cpu")
    assert len(exe.run(spikes)) == 2
    assert len(exe.run(spikes, temporal=True)) == 2


def test_serving_and_placement_raise_without_a_device(no_card):
    """The serving engine and the device partition default to the card."""
    from repro_torch.placement import (
        CoreGrid, build_device_assignment, place_network, tile_network,
    )
    from repro_torch.serving import ExecutablePool, ServingEngine

    net = _gesture_like()
    report = SwitchingCompiler("ideal").compile_network(net)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(net, report)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExecutablePool()
    assert report.executable is None
    tiled = tile_network(net, max_neurons=8)
    grid = CoreGrid(rows=2, cols=2)
    placed = place_network(tiled, grid)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_device_assignment(placed, tiled, grid)
    # asked for, the CPU runs
    assert build_device_assignment(placed, tiled, grid, n_devices=1).is_identity
    engine = ServingEngine(net, report, device="cpu")
    assert engine.pool.device == torch.device("cpu")
    rid = engine.submit(np.ones((3, 40), np.float32))
    assert len(engine.drain()[rid]) == 2
    assert report.executable.device == torch.device("cpu")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_wrappers_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel path, which takes
    only CUDA tensors: anything else raises instead of running the plain
    version (no kernel is built or launched).  The one exception is K5's
    meta route, chosen by the device as the CPU route is: all-meta
    operands (the dry run's) give outputs of the kernel's shapes, launch
    nothing and run no plain version; a mix of devices still raises."""
    f32, i8, i32 = torch.float32, torch.int8, torch.int32
    with pytest.raises(ValueError, match="CUDA device"):
        lif_update(*(_meta((4, 3), f32) for _ in range(3)), alpha=0.5, v_th=1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        lif_step([CurrentEdge(_meta((4, 3), f32))], _meta((4, 3), f32),
                 _meta((4, 3), i8), _meta((4, 3), f32), 0, alpha=0.5, v_th=1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        spike_wdm_matmul(_meta((4, 8), i8), _meta((2, 8), i8))
    with pytest.raises(ValueError, match="CUDA device"):
        sparse_gather(_meta((6, 3), f32), _meta((6, 3), i32), _meta((5, 2), f32))
    with pytest.raises(ValueError, match="CUDA device"):
        lif_parallel_scan(_meta((5, 3), f32), alpha=0.5)
    from repro_torch.kernels import launch_counts

    before = launch_counts()
    y, state = ssd_chunk(_meta((8, 2, 4), f32), _meta((8, 2, 3), f32),
                         _meta((8, 2, 3), f32), _meta((8, 2), f32))
    assert (y.device.type, tuple(y.shape)) == ("meta", (8, 2, 4))
    assert (state.device.type, tuple(state.shape)) == ("meta", (2, 3, 4))
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_chunk(_meta((8, 2, 4), f32), torch.zeros((8, 2, 3)),
                  _meta((8, 2, 3), f32), _meta((8, 2), f32))
    # mixed CPU / other-device operands are refused as well
    with pytest.raises(ValueError, match="CUDA device"):
        spike_wdm_matmul(torch.zeros((4, 8), dtype=i8), _meta((2, 8), i8))
