#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; exits non-zero, printing no result, without them.  Seven phases,
none of which is caught and swallowed:

1. **Build.**  Compile the five CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together), print the card's name
   and power limit, and hold each kernel against its plain PyTorch version
   on the card: the LIF update bitwise on ``v`` and ``z`` with
   ``alpha`` in {0.5, 0.9}, the int8 WDM matmul and the ELL gather exactly
   (the gather also with its spikes as strided views and at 600 columns),
   the affine membrane scan bitwise at ``alpha`` in {0, 0.5, 0.9, 1} on
   integer and normal currents, the SSD intra-chunk block within
   ``rtol = atol = 1e-4`` (the reference's tolerance; B and C per head and
   per group of heads), at the paths' shapes and at the shapes of the
   reference package's kernel tests and kernel benchmark.  ptxas's
   registers, shared memory and spills are printed for K3 and K5.
2. **Compile.**  Train AdaBoost on a reduced paradigm-dataset grid that
   holds the gesture regime, and compile the paper's gesture network
   (2048-20-4, density 0.0316, §IV-C) under ``classifier``, ``serial``
   and ``parallel``.
3. **Serve, fused.**  Sixteen seeded requests (25-75 steps, widths
   2048/1536/1024 zero-padded to 2048, rate 0.2) as two padded
   micro-batches of 8 through ``network_executable(...).run_device(...,
   valid_steps=...)`` for each report.  Every reply must equal, bit for
   bit, the request run alone at batch 1 on the card, the port on the CPU,
   and ``run_graph_reference``.
4. **Serve, temporal.**  The same micro-batches through ``run_temporal``
   (whole-train projections, K4 for the fixed-point passes, K3 for the
   sparse projections over all T·B columns).  Every reply must equal the
   report's ``run_device`` reply on the card, the port's ``run_temporal``
   on the CPU and ``run_graph_reference``; every residual is 0 and the
   card's pass counts equal the CPU's.
5. **Exact modes.**  The gesture net with alpha 0 (``alpha0`` in both
   populations) and alpha 1 (``iterative``, then ``count``) through
   ``run_temporal`` under ``classifier``, held the same way.
6. **Step-serial block.**  A small recurrent graph (self-loop on the
   hidden population) through ``run_temporal``: its back-edge interval
   runs the step-serial loop (K1, K2) between whole-train populations.
7. **Serve mamba2-130m** at full width (24 layers, d 768, vocab 50280,
   state 128, head dim 64, chunk 256), random weights from seed 0:
   prefill at batch 4 x 1024 tokens, then 32 greedy decode steps.  (a) In
   float32 with TF32 off: K5 must launch 24 times in the prefill and never
   in decode; the card's logits at every step and its caches after the
   prefill and at the end are held against the port on the CPU on the same
   weights (the CPU decode teacher-forced with the card's tokens).  (b) In
   the published bfloat16: ``repro_torch.launch.serve.main`` serves the
   same request, then prefill and decode are timed, with their device busy
   shares, and held against the float32 run.

Earlier lines print the kernels' launch counts on each served path, their
times (CUDA events) beside the plain versions' and a library call's, and
the served micro-batch's time per step on both paths.  The line before
the card line is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): device
# memory bytes/s, int8 and TF32 tensor-core ops/s, f32 (non-tensor-core)
# flop/s.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
TF32_OPS_S = 495e12
F32_OPS_S = 67e12

N_INPUT = 2048
MICRO_BATCH = 8
REPLACES = {
    "lif_update": "src/repro/kernels/lif_update/kernel.py:41",
    "spike_wdm_matmul": "src/repro/kernels/spike_wdm_matmul/kernel.py:54",
    "sparse_gather": "src/repro/kernels/sparse_gather/kernel.py:48",
    "lif_parallel_scan": "src/repro/kernels/lif_parallel_scan/kernel.py:70",
    "ssd_chunk": "src/repro/kernels/ssd_chunk/kernel.py:64",
}
SCAN_ALPHAS = (0.0, 0.5, 0.9, 1.0)
#: K5's tolerance against its plain version: the reference's kernel test's
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
#: mamba2-130m served in phase 7: batch, prompt tokens, greedy decode steps
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 1024, 32


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """CUDA-event time per call of ``fn`` launched eagerly ``iters`` times:
    at the path's small shapes this is the host's enqueue rate, not the
    kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int = 100, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed between CUDA events, so no host time is in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float):
    """The least time the card could take: max(bytes/bw, ops/peak)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# -- 1. build and hold each kernel against its plain version -----------------
def lif_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    i = torch.tensor(rng.normal(size=shape) * 10, dtype=torch.float32)
    v = torch.tensor(rng.normal(size=shape), dtype=torch.float32)
    z = torch.tensor(rng.integers(0, 2, shape), dtype=torch.float32)
    return [a.cuda() for a in (i, v, z)]


def wdm_inputs(m, k, n, seed, p=0.3):
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.integers(-128, 128, (m, k)), dtype=torch.int8)
    x = torch.tensor(rng.random((n, k)) < p, dtype=torch.int8)
    return a.cuda(), x.cuda()


def ell_inputs(r, lanes, s, b, seed, layout="contiguous"):
    """Ragged ELL rows: each row keeps a random number of lanes, the rest
    padding (weight 0, index 0), with int8-magnitude integer weights.  The
    (S, B) spikes are contiguous, the transposed view of a (B, S) matrix
    (the fused step's ``x_t.t()``) or a column slice of a wider one."""
    rng = np.random.default_rng(seed)
    val = rng.integers(-127, 128, (r, lanes)).astype(np.float32)
    idx = rng.integers(0, s, (r, lanes)).astype(np.int32)
    keep = np.arange(lanes)[None, :] < rng.integers(0, lanes + 1, (r, 1))
    val, idx = np.where(keep, val, 0), np.where(keep, idx, 0).astype(np.int32)
    x = (rng.random((s, b)) < 0.2).astype(np.float32)
    val, idx, x = (torch.tensor(a).cuda() for a in (val, idx, x))
    if layout == "transposed":
        x = x.t().contiguous().t()
    elif layout == "sliced":
        x = torch.cat([torch.zeros((s, 2), device="cuda"), x], 1)[:, 2:]
    return [val, idx, x]


def scan_inputs(shape, seed, kind):
    """(T, F) currents: integers in [-5, 5] or standard normal floats."""
    rng = np.random.default_rng(seed)
    c = (rng.integers(-5, 6, shape) if kind == "int" else rng.normal(size=shape))
    return torch.tensor(c, dtype=torch.float32).cuda()


def ssd_inputs(shape, seed, decay="test"):
    """(G, Q, H, P, N[, Hg]) SSD operands as the reference's kernel test
    draws them (normal x, b, c; la = -|N(0, 0.1)|), or with a mamba2
    layer's log decays (dt ~ 0.69 times A in [-16, -1]); b and c per head,
    or per group of heads when Hg is given.  G = 1 gives the reference's
    own single-chunk layout."""
    g, q, h, p, n = shape[:5]
    hg = shape[5] if len(shape) > 5 else h
    rng = np.random.default_rng(seed)
    x, b, c = (rng.normal(size=(g, q, hh, k)) for hh, k in ((h, p), (hg, n), (hg, n)))
    if decay == "test":
        la = -np.abs(rng.normal(size=(g, q, h)) * 0.1)
    else:
        la = -0.69 * np.linspace(1.0, 16.0, h) * rng.uniform(0.8, 1.2, (g, q, h))
    ops = [torch.tensor(a, dtype=torch.float32).cuda() for a in (x, b, c, la)]
    return [a[0] for a in ops] if g == 1 else ops


def max_abs_diff(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| in float64 (exact for int32 and f32 values)."""
    if out.numel() == 0:
        return 0.0
    return float((out.double() - ref.double()).abs().max())


def check_kernels(shapes) -> dict:
    """Kernel vs plain version on the card at every shape; max |diff| each."""
    from repro_torch.kernels.lif_parallel_scan import (
        lif_parallel_scan, lif_parallel_scan_ref,
    )
    from repro_torch.kernels.lif_update import lif_update, lif_update_ref
    from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
    from repro_torch.kernels.spike_wdm_matmul import (
        spike_wdm_matmul, spike_wdm_matmul_ref,
    )
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref

    err = {name: 0.0 for name in REPLACES}
    err["ssd_chunk/tol"] = 0.0      # max |diff| / (atol + rtol |ref|): the margin
    for seed, shape in enumerate(shapes["lif_update"]):
        for alpha, v_th in ((0.5, 64.0), (0.9, 1.0)):
            i, v, z = lif_inputs(shape, seed)
            vk, zk = lif_update(i, v, z, alpha=alpha, v_th=v_th)
            vp, zp = lif_update_ref(i, v, z, alpha=alpha, v_th=v_th)
            torch.cuda.synchronize()
            require(torch.equal(vk.view(torch.int32), vp.view(torch.int32)),
                    f"lif_update v not bitwise at {shape}, alpha={alpha}")
            require(torch.equal(zk, zp), f"lif_update z differs at {shape}")
            err["lif_update"] = max(err["lif_update"], max_abs_diff(vk, vp),
                                    max_abs_diff(zk, zp))
    for seed, (m, k, n) in enumerate(shapes["spike_wdm_matmul"]):
        a, x = wdm_inputs(m, k, n, seed)
        out, ref = spike_wdm_matmul(a, x), spike_wdm_matmul_ref(a, x)
        torch.cuda.synchronize()
        require(out.dtype == torch.int32 and torch.equal(out, ref),
                f"spike_wdm_matmul differs at {(m, k, n)}")
        err["spike_wdm_matmul"] = max(err["spike_wdm_matmul"], max_abs_diff(out, ref))
    # no saturation: int8 x int8 accumulates in int32
    full = torch.full((128, 512), 127, dtype=torch.int8, device="cuda")
    ones = torch.ones((8, 512), dtype=torch.int8, device="cuda")
    require(int(spike_wdm_matmul(full, ones)[0, 0]) == 127 * 512, "saturated +")
    neg = torch.full((4, 16), -128, dtype=torch.int8, device="cuda")
    ones = torch.ones((2, 16), dtype=torch.int8, device="cuda")
    require(int(spike_wdm_matmul(neg, ones)[0, 0]) == -128 * 16, "saturated -")
    empty = spike_wdm_matmul(
        torch.zeros((32, 0), dtype=torch.int8, device="cuda"),
        torch.zeros((4, 0), dtype=torch.int8, device="cuda"),
    )
    require(empty.shape == (4, 32) and int(empty.abs().sum()) == 0, "K == 0")
    for seed, shape in enumerate(shapes["sparse_gather"]):
        val, idx, x = ell_inputs(*shape[:4], seed, *shape[4:])
        out, ref = sparse_gather(val, idx, x), sparse_gather_ref(val, idx, x)
        torch.cuda.synchronize()
        require(torch.equal(out, ref), f"sparse_gather differs at {shape}")
        err["sparse_gather"] = max(err["sparse_gather"], max_abs_diff(out, ref))
    for seed, shape in enumerate(shapes["lif_parallel_scan"]):
        for alpha in SCAN_ALPHAS:
            for kind in ("int", "randn"):
                c = scan_inputs(shape, seed, kind)
                out = lif_parallel_scan(c, alpha=alpha)
                ref = lif_parallel_scan_ref(c, alpha=alpha)
                torch.cuda.synchronize()
                require(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
                        f"lif_parallel_scan not bitwise at {shape}, alpha={alpha}, {kind}")
                err["lif_parallel_scan"] = max(err["lif_parallel_scan"],
                                               max_abs_diff(out, ref))
    empty = lif_parallel_scan(torch.zeros((0, 160), device="cuda"), alpha=0.5)
    require(empty.shape == (0, 160), "T == 0")
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: the SSD plain version needs full f32")
    for seed, shape in enumerate(shapes["ssd_chunk"]):
        for decay in ("test", "mamba2"):
            ops = ssd_inputs(shape, seed, decay)
            (y, s), (yr, sr) = ssd_chunk(*ops), ssd_chunk_ref(*ops)
            torch.cuda.synchronize()
            for out, ref in ((y, yr), (s, sr)):
                require(out.shape == ref.shape and bool(torch.isfinite(out).all())
                        and torch.allclose(out, ref, **SSD_TOL),
                        f"ssd_chunk differs at {shape}, {decay} decays: max "
                        f"|diff| {max_abs_diff(out, ref)}")
                err["ssd_chunk"] = max(err["ssd_chunk"], max_abs_diff(out, ref))
                err["ssd_chunk/tol"] = max(err["ssd_chunk/tol"], float(
                    ((out - ref).abs() / (SSD_TOL["atol"] + SSD_TOL["rtol"] * ref.abs()))
                    .max()) if out.numel() else 0.0)
    return err


# -- 2. compile ----------------------------------------------------------------
def gesture_net(alpha=0.5):
    from repro_torch.core import feedforward_network
    from repro_torch.core.layer import LIFParams

    net = feedforward_network([N_INPUT, 20, 4], density=0.0316, delay_range=1,
                              seed=0, name="gesture")
    for layer in net.layers:
        layer.lif = LIFParams(alpha=alpha, v_th=64.0)
    return net


def compile_reports(net):
    from repro_torch.core import (
        SwitchingCompiler, generate_dataset, train_switch_classifier,
    )

    t0 = time.perf_counter()
    ds = generate_dataset(
        source_grid=(100, 300, 1024, 2048), target_grid=(10, 20, 100, 300),
        density_grid=(0.01, 0.03, 0.05, 0.1, 0.5, 0.9), delay_grid=(1, 4, 8),
        seed=0,
    )
    clf, acc = train_switch_classifier(ds, seed=0)
    print(f"compile: AdaBoost on {len(ds)} layers, test accuracy "
          f"{acc * 100:.1f}% ({time.perf_counter() - t0:.1f} s on the host)")
    reports = {
        "classifier": SwitchingCompiler("classifier", clf).compile_network(net),
        "serial": SwitchingCompiler("serial").compile_network(net),
        "parallel": SwitchingCompiler("parallel").compile_network(net),
    }
    for name, rep in reports.items():
        print(f"compile: {name:10s} -> "
              f"{'/'.join(l.paradigm for l in rep.layers)}, {rep.total_pes} PEs")
    return reports, clf


# -- 3. serve ------------------------------------------------------------------
def make_requests(n=16, seed=0, rate=0.2):
    """Seeded requests as examples/serve_snn.py draws them (steps, width)."""
    rng = np.random.default_rng(seed)
    widths = [N_INPUT, 3 * N_INPUT // 4, N_INPUT // 2]
    reqs = []
    for _ in range(n):
        steps = int(rng.integers(25, 76))
        width = int(rng.choice(widths))
        x = np.zeros((steps, N_INPUT), np.float32)
        x[:, :width] = rng.random((steps, width)) < rate
        reqs.append(x)
    return reqs


def micro_batch(reqs):
    t_max = max(r.shape[0] for r in reqs)
    x = np.zeros((t_max, len(reqs), N_INPUT), np.float32)
    for b, r in enumerate(reqs):
        x[: r.shape[0], b] = r
    return x, np.array([r.shape[0] for r in reqs], np.int32)


def serve_main_path(net, reports, batches):
    """The port's main path: every micro-batch through run_device on the
    card, for each report.  Returns the replies as host arrays."""
    from repro_torch.core.runtime import network_executable

    served = {}
    for name, rep in reports.items():
        exe = network_executable(net, rep)
        served[name] = []
        for x, vs in batches:
            outs = exe.run_device(x, valid_steps=vs)
            require(bool(exe.last_check), f"{name}: last_check is False")
            served[name].append([z.cpu().numpy() for z in outs])
    torch.cuda.synchronize()
    return served


def lane_oracles(net, batches):
    """run_graph_reference of every request alone, per micro-batch."""
    from repro_torch.core.runtime import run_graph_reference

    return [[run_graph_reference(net, x[:steps, b : b + 1])
             for b, steps in enumerate(vs)] for x, vs in batches]


def hold_replies(net, reports, batches, served, oracles):
    """Every served reply against its solo run on the card, the port on the
    CPU, and run_graph_reference."""
    from repro_torch.core.runtime import NetworkExecutable, network_executable

    for name, rep in reports.items():
        exe = network_executable(net, rep)
        forms = rep.serial_forms.get(("fused", MICRO_BATCH))
        for layer, form in zip(rep.layers, forms):
            if layer.paradigm == "serial":
                require(form == "sparse", f"{name}: serial form {form} at batch 8")
        for (x, vs), outs, lanes in zip(batches, served[name], oracles):
            for b, steps in enumerate(vs):
                solo = exe.run(x[:steps, b : b + 1])
                for z, s, o in zip(outs, solo, lanes[b]):
                    require(np.array_equal(z[:steps, b : b + 1], s),
                            f"{name}: reply {b} differs from its solo run")
                    require(np.array_equal(s, o),
                            f"{name}: solo run {b} differs from run_graph_reference")
                    require(not z[steps:, b].any(), f"{name}: padded steps fired")
        solo_forms = rep.serial_forms.get(("fused", 1))
        cpu = NetworkExecutable.build(net, rep, device="cpu")
        for (x, vs), outs in zip(batches, served[name]):
            for z, c in zip(outs, cpu.run(x, valid_steps=vs)):
                require(np.array_equal(z, c), f"{name}: card and CPU differ")
        n_rep = sum(len(vs) for _, vs in batches)
        print(f"serve: {name:10s} {n_rep} replies bit-identical to solo runs "
              f"(forms at batch 1: {solo_forms}), to the port on the CPU and to "
              f"run_graph_reference; forms at batch 8: {forms}")


def serve_temporal(net, reports, batches):
    """The temporal path: every micro-batch through run_temporal on the
    card, for each report.  Returns the replies as host arrays and each
    report's launch records as the card left them."""
    from repro_torch.core.runtime import network_executable

    served, records = {}, {}
    for name, rep in reports.items():
        exe = network_executable(net, rep)
        served[name] = []
        for x, vs in batches:
            outs = exe.run_temporal(x, valid_steps=vs)
            require(bool(exe.last_check), f"{name}: temporal last_check is False")
            served[name].append([z.cpu().numpy() for z in outs])
        records[name] = dict(rep.temporal)
    torch.cuda.synchronize()
    return served, records


def hold_temporal(net, reports, batches, served, fused, records, oracles,
                  what="temporal"):
    """Every temporal reply against the report's run_device reply on the
    card, the port's run_temporal on the CPU and run_graph_reference; the
    launch records (converged, card == CPU) and forms."""
    from repro_torch.core.runtime import NetworkExecutable

    for name, rep in reports.items():
        forms = rep.serial_forms[("temporal", MICRO_BATCH)]
        require(all(f in ("temporal", "temporal_sparse") for f in forms),
                f"{what} {name}: non-temporal forms {forms}")
        passes = []
        for i, ((x, vs), outs) in enumerate(zip(batches, served[name])):
            rec = records[name][(MICRO_BATCH, x.shape[0])]
            require(all(r == 0 for r in rec.residual.values()),
                    f"{what} {name}: residual {rec.residual}")
            require(all(k < rec.max_iters for k in rec.iterations.values()),
                    f"{what} {name}: passes {rec.iterations} hit the cap")
            passes.append(rec.iterations)
            for z, f in zip(outs, fused[name][i]):
                require(np.array_equal(z, f),
                        f"{what} {name}: temporal and run_device replies differ")
            for b, steps in enumerate(vs):
                for z, o in zip(outs, oracles[i][b]):
                    require(np.array_equal(z[:steps, b : b + 1], o),
                            f"{what} {name}: reply {b} differs from run_graph_reference")
                    require(not z[steps:, b].any(), f"{what} {name}: padded steps fired")
        cpu = NetworkExecutable.build(net, rep, device="cpu")
        for (x, vs), outs in zip(batches, served[name]):
            for z, c in zip(outs, cpu.run(x, valid_steps=vs, temporal=True)):
                require(np.array_equal(z, c), f"{what} {name}: card and CPU differ")
            key = (MICRO_BATCH, x.shape[0])
            require(rep.temporal[key] == records[name][key],
                    f"{what} {name}: card record {records[name][key]} != CPU "
                    f"{rep.temporal[key]}")
        rec = records[name][(MICRO_BATCH, batches[0][0].shape[0])]
        print(f"{what}: {name:10s} {sum(len(vs) for _, vs in batches)} replies "
              f"bit-identical to run_device on the card, to the port on the CPU "
              f"and to run_graph_reference; forms {forms}, modes {rec.modes}, "
              f"passes per micro-batch {passes}, residual 0")


def exact_modes(clf, batches):
    """The gesture net at alpha 0 and alpha 1 under the classifier report:
    the exact reset modes (alpha0, count) on the card."""
    from repro_torch.core import SwitchingCompiler
    from repro_torch.core.runtime import network_executable
    from repro_torch.kernels import launch_counts, reset_launch_counts

    for alpha, want in ((0.0, "alpha0"), (1.0, "count")):
        net = gesture_net(alpha)
        reports = {"classifier": SwitchingCompiler("classifier", clf)
                   .compile_network(net)}
        exe = network_executable(net, reports["classifier"])
        fused = {"classifier": [[z.cpu().numpy() for z in
                                 exe.run_device(x, valid_steps=vs)]
                                for x, vs in batches]}
        reset_launch_counts()
        served, records = serve_temporal(net, reports, batches)
        counts = launch_counts()
        modes = records["classifier"][(MICRO_BATCH, batches[0][0].shape[0])].modes
        require(want in modes.values(), f"alpha {alpha}: modes {modes} lack {want}")
        hold_temporal(net, reports, batches, served, fused, records,
                      lane_oracles(net, batches), what=f"exact alpha={alpha}")
        print(f"exact alpha={alpha}: launches on the temporal path: {counts}")


HYBRID = (  # tests/test_temporal_equivalence.py "hybrid-loop"
    [("in", 14), ("h", 18), ("out", 9)],
    [("in", "h", 0.3, 2, 0.2), ("h", "h", 0.25, 2, 0.2), ("h", "out", 0.4, 2, 0.2)],
    ["serial", "parallel", "serial"],
    505,
)


def hybrid_block():
    """A self-loop graph through run_temporal on the card: the back-edge
    interval runs the step-serial loop on its sub-plan (K1, K2)."""
    from repro_torch.core import CompileReport, Population, SNNNetwork, SwitchingCompiler
    from repro_torch.core.layer import LIFParams, random_sparse_projection
    from repro_torch.core.runtime import (
        NetworkExecutable, network_executable, run_graph_reference,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts

    pop_spec, proj_spec, paradigms, seed = HYBRID
    pops = {n: Population(f"hybrid.{n}", s) for n, s in pop_spec}
    projs = []
    for i, (pre, post, density, dr, inhib) in enumerate(proj_spec):
        p = random_sparse_projection(pops[pre], pops[post], density, dr,
                                     seed=seed + i, inhibitory_fraction=inhib)
        p.lif = LIFParams(alpha=0.5, v_th=64.0)
        projs.append(p)
    net = SNNNetwork(populations=[pops[n] for n, _ in pop_spec],
                     projections=projs, name="hybrid-loop")
    rep = CompileReport(layers=[SwitchingCompiler(par).compile_layer(l)
                                for par, l in zip(paradigms, net.layers)])
    rng = np.random.default_rng(seed)
    x = (rng.random((10, 3, net.n_input)) < 0.3).astype(np.float32)
    exe = network_executable(net, rep)
    reset_launch_counts()
    got = [z.cpu().numpy() for z in exe.run_temporal(x)]
    counts = launch_counts()
    require(bool(exe.last_check), "hybrid: last_check is False")
    rec = dict(rep.temporal)[(3, 10)]
    require(rec.split[1] >= 1, f"hybrid: no step-serial block in {rec.split}")
    require(all(r == 0 for r in rec.residual.values()), "hybrid: residual")
    for name in ("lif_update", "spike_wdm_matmul", "lif_parallel_scan"):
        require(counts[name] > 0, f"hybrid: {name} not launched")
    fused = [z.cpu().numpy() for z in exe.run_device(x)]
    cpu = NetworkExecutable.build(net, rep, device="cpu").run(x, temporal=True)
    oracle = run_graph_reference(net, x)
    require(sum(float(z.sum()) for z in got) > 0, "hybrid: silent")
    for z, f, c, o in zip(got, fused, cpu, oracle):
        require(np.array_equal(z, f), "hybrid: temporal and run_device differ")
        require(np.array_equal(z, c), "hybrid: card and CPU differ")
        require(np.array_equal(z, o), "hybrid: differs from run_graph_reference")
    print(f"hybrid: split {rec.split}, modes {rec.modes}, passes "
          f"{rec.iterations}; launches {counts}; bit-identical to run_device, "
          f"the CPU and run_graph_reference")


def profiled_ms(launch):
    """Device time of one launch from torch.profiler: kernels and copies
    (rows with no host time of their own), total, count and the top rows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        launch()
        torch.cuda.synchronize()
    rows = sorted(
        (e for e in prof.key_averages()
         if e.self_cpu_time_total == 0 and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    total = sum(e.self_device_time_total for e in rows) / 1e3
    top = "; ".join(f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                    for e in rows[:6])
    return total, sum(e.count for e in rows), top


def host_ms(launch, reps=10):
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        launch()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def time_temporal(net, name, rep, batch, card):
    """run_temporal beside run_device on one micro-batch, same run: host
    time per launch (ends in a sync), device time from the profiler."""
    from repro_torch.core.runtime import network_executable

    exe = network_executable(net, rep)
    x, vs = batch
    xs = torch.as_tensor(x, device="cuda")
    vs_t = torch.as_tensor(vs, device="cuda")
    steps, req_steps = x.shape[0], int(vs.sum())

    def temporal():
        exe.run_temporal(xs, valid_steps=vs_t)

    def fused():
        exe.run_device(xs, valid_steps=vs_t)

    ht_a, hf_a = host_ms(temporal), host_ms(fused)   # in turns: t, f, f, t
    hf_b, ht_b = host_ms(fused), host_ms(temporal)
    ht, hf = (ht_a + ht_b) / 2, (hf_a + hf_b) / 2
    passes = rep.temporal[(len(vs), steps)].iterations
    n_pass = sum(passes.values())
    dt, nt, top = profiled_ms(temporal)
    df, nf, _ = profiled_ms(fused)
    print(f"temporal timing [{card}]: {name} micro-batch of {len(vs)} ({steps} "
          f"steps): run_temporal {ht:.3f} ms per launch ({ht_a:.3f}, {ht_b:.3f}), "
          f"{ht / steps * 1e3:.1f} us per step, {req_steps / ht * 1e3:,.0f} "
          f"request-steps/s, K4 passes {passes}, {ht / max(1, n_pass) * 1e3:.1f} "
          f"us host per pass, device {dt:.3f} ms in {nt} launches; run_device "
          f"{hf:.3f} ms per launch ({hf_a:.3f}, {hf_b:.3f}), {hf / steps * 1e3:.1f} "
          f"us per step, {req_steps / hf * 1e3:,.0f} request-steps/s, device "
          f"{df:.3f} ms in {nf} launches")
    print(f"temporal profile [{card}]: {name}: top: {top}")


def time_serving(net, name, rep, batch, card):
    """One served micro-batch: host time per launch (ends in a sync), the
    same launch's device time (captured once as a CUDA graph and replayed,
    so no host time is in it), and the device kernels that make it up."""
    from repro_torch.core.runtime import network_executable

    exe = network_executable(net, rep)
    x, vs = batch
    xs = torch.as_tensor(x, device="cuda")
    vs_t = torch.as_tensor(vs, device="cuda")

    def launch():
        exe.run_device(xs, valid_steps=vs_t)

    dt = host_ms(launch) / 1e3
    dev = device_ms(launch, iters=1, replays=10) / 1e3
    steps = x.shape[0]
    print(f"serve timing [{card}]: {name} micro-batch of {len(vs)} "
          f"({steps} steps): {dt * 1e3:.3f} ms per launch, "
          f"{dt / steps * 1e6:.1f} us per step, "
          f"{int(vs.sum()) / dt:,.0f} request-steps/s; device time "
          f"{dev * 1e3:.3f} ms per launch, busy share {dev / dt:.3f}")
    total, n, top = profiled_ms(launch)
    print(f"serve profile [{card}]: {name}: device {total:.3f} ms in {n} "
          f"launches; top: {top}")


# -- 7. serve mamba2-130m ----------------------------------------------------------
def lm_inputs():
    """The served request, as repro_torch.launch.serve draws it for seed 0."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-130m")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)))
    return cfg, tokens, LM_PROMPT + LM_STEPS + 1


def lm_run(params, cfg, tokens, cache_len, forced=None):
    """Prefill, then LM_STEPS greedy decode steps (fed ``forced``'s tokens
    when given).  Returns the logits of every step (host f32), the tokens
    fed back, the caches after the prefill and at the end (host), and the
    kernels' launch counts in the prefill and in the decode steps, each
    set to 0 just before and read just after."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as lm

    dev = params["tok_embed"].device
    with torch.inference_mode():
        reset_launch_counts()
        logits, caches = lm.prefill(params, cfg, {"tokens": tokens.to(dev)}, cache_len)
        counts = [launch_counts()]
        after_prefill = lm_host(caches)
        steps, fed = [logits.float().cpu()], []
        reset_launch_counts()
        for i in range(LM_STEPS):
            tok = (forced[:, i:i + 1] if forced is not None
                   else steps[-1][:, -1].argmax(-1)[:, None])
            fed.append(tok)
            logits, caches = lm.decode_step(params, cfg, tok.to(dev),
                                            LM_PROMPT + i, caches, cache_len)
            steps.append(logits.float().cpu())
        counts.append(launch_counts())
    return steps, torch.cat(fed, dim=1), after_prefill, lm_host(caches), counts


def lm_host(caches):
    return [[{k: v.float().cpu() for k, v in blk.items()} for blk in grp]
            for grp in caches]


def lm_close(got, want, what):
    """|got - want| <= 1e-4 |want| + 1e-4 max|want|, elementwise: rtol 1e-4
    and an atol of 1e-4 of the tensor's own scale (f32 sums in another
    order on each device).  Returns (max abs err, max abs err / scale)."""
    scale = float(want.abs().max())
    diff = (got.double() - want.double()).abs()
    ok = bool((diff <= 1e-4 * want.double().abs() + 1e-4 * scale).all())
    err = float(diff.max())
    require(ok and bool(torch.isfinite(got).all()),
            f"mamba2 f32: {what} differs: max |diff| {err} at scale {scale}")
    return err, err / max(scale, 1e-30)


def serve_mamba2_f32():
    """Phase 7 (a): the served request in float32 on the card, K5 counted,
    held against the port on the CPU on the same weights."""
    from repro_torch.models import init as minit

    torch.backends.cudnn.allow_tf32 = False      # it defaults to True
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    cfg, tokens, cache_len = lm_inputs()
    cfg = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    host = minit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = minit.tree_to(host, "cuda")
    print(f"mamba2: {cfg.param_count():,} parameters (seed 0) in "
          f"{time.perf_counter() - t0:.1f} s")

    steps, toks, cache_p, cache_e, (in_prefill, in_decode) = lm_run(
        params, cfg, tokens, cache_len)
    print(f"mamba2: launches in the prefill {in_prefill}; in the {LM_STEPS} "
          f"decode steps {in_decode}")
    require(in_prefill["ssd_chunk"] == cfg.n_layers,
            f"ssd_chunk launched {in_prefill['ssd_chunk']} times in the prefill")
    require(in_decode["ssd_chunk"] == 0, "ssd_chunk launched in decode")
    require(all(tuple(x.shape) == (LM_BATCH, 1, cfg.vocab) for x in steps),
            "mamba2: logits of the wrong shape")

    t0 = time.perf_counter()           # full depth: ~13 s on the card's host
    c_steps, _, c_cache_p, c_cache_e, _ = lm_run(host, cfg, tokens, cache_len,
                                                 forced=toks)
    t_cpu = time.perf_counter() - t0
    errs = {"logits": max(lm_close(a, b, f"logits of step {i}")
                          for i, (a, b) in enumerate(zip(steps, c_steps)))}
    for when, got, want in (("prefill", cache_p, c_cache_p), ("end", cache_e, c_cache_e)):
        for name in ("conv", "ssd"):
            errs[f"{name} cache ({when})"] = lm_close(
                got[0][0][name], want[0][0][name], f"{name} cache after the {when}")
    print(f"mamba2 f32: card vs the port on the CPU (all {cfg.n_layers} layers, "
          f"CPU run {t_cpu:.1f} s, decode teacher-forced with the card's tokens), "
          "tolerance |diff| <= 1e-4 |cpu| + 1e-4 max|cpu|: "
          + ", ".join(f"{k} max abs {a:.3e} rel {r:.3e}" for k, (a, r) in errs.items()))
    greedy = torch.cat([toks, steps[-1][:, -1].argmax(-1)[:, None]], 1)
    print(f"mamba2 f32: greedy tokens of request 0: {greedy[0, :12].tolist()}")
    return cfg, host, steps, greedy, in_prefill["ssd_chunk"]


def serve_mamba2_bf16(card, host32, steps32, greedy32):
    """Phase 7 (b): the same request in the published bfloat16, through the
    user's entry point, then timed; held against the float32 run."""
    from repro_torch.launch import serve
    from repro_torch.models import init as minit, model as lm

    cfg, tokens, cache_len = lm_inputs()
    require(cfg.dtype == "bfloat16", f"published dtype {cfg.dtype}")
    out = serve.main(["--arch", "mamba2-130m", "--batch", str(LM_BATCH),
                      "--prompt-len", str(LM_PROMPT), "--gen", str(LM_STEPS + 1)])
    free_agree = float((out["tokens"] == greedy32.numpy()).mean())

    # the init draws in f32 and casts, so these are serve.main's weights
    params = minit.tree_to(minit.tree_to(host32, "cuda"), torch.bfloat16)
    steps16 = lm_run(params, cfg, tokens, cache_len, forced=greedy32[:, :-1])[0]
    diff = max(float((a - b).abs().max()) for a, b in zip(steps16, steps32))
    agree = float(np.mean([bool(a[b, -1].argmax() == c[b, -1].argmax())
                           for a, c in zip(steps16, steps32) for b in range(LM_BATCH)]))

    batch = {"tokens": tokens.cuda()}
    with torch.inference_mode():
        def prefill():
            return lm.prefill(params, cfg, batch, cache_len)

        _, caches = prefill()
        tok = torch.zeros((LM_BATCH, 1), dtype=torch.int64, device="cuda")

        def decode():
            return lm.decode_step(params, cfg, tok, LM_PROMPT, caches, cache_len)

        pre_host, pre_dev = host_ms(prefill, reps=5), device_ms(prefill, 1, 5)
        dec_host, dec_dev = host_ms(decode, reps=LM_STEPS), device_ms(decode, 1, 20)
        top_p = profiled_ms(prefill)
        top_d = profiled_ms(decode)
    print(f"mamba2 bf16 [{card}]: serve.main prefill {out['prefill_s'] * 1e3:.3f} "
          f"ms (first call), decode {out['decode_tok_per_s']:.1f} tok/s; greedy "
          f"tokens equal the f32 run's on {free_agree:.4f} of {out['tokens'].size}")
    print(f"mamba2 bf16 [{card}]: prefill (batch {LM_BATCH} x {LM_PROMPT}) "
          f"{pre_host:.3f} ms, device {pre_dev:.3f} ms, busy share "
          f"{pre_dev / pre_host:.3f}; decode {dec_host:.3f} ms a step "
          f"({LM_BATCH * 1e3 / dec_host:.1f} tok/s), device {dec_dev:.3f} ms, busy "
          f"share {dec_dev / dec_host:.3f}; vs f32 (teacher-forced): max |logit "
          f"diff| {diff:.4f}, greedy tokens agree on {agree:.4f} of "
          f"{len(steps16) * LM_BATCH}")
    for what, (total, n, top) in (("prefill", top_p), ("decode step", top_d)):
        print(f"mamba2 profile [{card}]: {what}: device {total:.3f} ms in {n} "
              f"launches; top: {top}")


# -- kernel timings --------------------------------------------------------------
def kernel_rows(path, err, counts, card, temporal_gather, temporal_steps):
    """Times at the main path's largest shape of each kernel (the JSON
    rows), and at the reference benchmark's larger shapes and K3's
    temporal-path shape (printed only).

    ``ms``/``plain_ms``/``library_ms`` are device times from CUDA-graph
    replay; the eager per-call times (host enqueue included) are printed
    beside them."""
    from repro_torch.kernels.lif_parallel_scan import (
        lif_parallel_scan, lif_parallel_scan_ref,
    )
    from repro_torch.kernels.lif_update import lif_update, lif_update_ref
    from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
    from repro_torch.kernels.spike_wdm_matmul import (
        spike_wdm_matmul, spike_wdm_matmul_ref,
    )
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref

    def timed(kernel, plain, library, n_bytes, n_ops, ops_rate, plain_iters=100):
        b, by = bound_ms(n_bytes, n_ops, ops_rate)
        t = {"ms": device_ms(kernel),
             "plain_ms": device_ms(plain, iters=plain_iters),
             "library_ms": None if library is None else device_ms(library),
             "bound_ms": b, "bound_by": by}
        t["eager"] = (eager_ms(kernel), eager_ms(plain),
                      None if library is None else eager_ms(library))
        return t

    def lif_row(shape, seed):
        i, v, z = lif_inputs(shape, seed)
        n = i.numel()
        return timed(
            lambda: lif_update(i, v, z, alpha=0.9, v_th=1.0),
            lambda: lif_update_ref(i, v, z, alpha=0.9, v_th=1.0),
            None, 20 * n, 5 * n, F32_OPS_S,
        )

    def wdm_row(m, k, n, seed):
        a, x = wdm_inputs(m, k, n, seed)
        # torch._int_mm computes (M', K') @ (K', N') int8 -> int32 for
        # M' > 16 and K', N' multiples of 8: zero-pad (the product is
        # unchanged) to the nearest shape it accepts
        mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
        ap = torch.zeros((mp, kp), dtype=torch.int8, device="cuda")
        xp = torch.zeros((kp, np_), dtype=torch.int8, device="cuda")
        ap[:m, :k], xp[:k, :n] = a, x.T
        return timed(
            lambda: spike_wdm_matmul(a, x),
            lambda: spike_wdm_matmul_ref(a, x),
            lambda: torch._int_mm(ap, xp),
            m * k + n * k + 4 * m * n, 2 * m * k * n, INT8_OPS_S,
        )

    def gather_row(val, idx, x):
        r, lanes = val.shape
        s, bsz = x.shape
        # library yardstick: the same ELL as one CSR sparse x dense product,
        # on the spikes made contiguous (its best case)
        xc = x.contiguous()
        nz = val != 0
        rows_i = torch.arange(r, device="cuda")[:, None].expand(r, lanes)[nz]
        csr = torch.sparse_coo_tensor(
            torch.stack([rows_i, idx[nz].long()]), val[nz], (r, s)
        ).coalesce().to_sparse_csr()
        nnz = int(nz.sum())
        # each input read once: the ELL operands, and of the spike matrix
        # only the rows this ELL indexes (padding lanes index row 0); the
        # output written once; the flops this data needs: one multiply-add
        # a live lane
        rows_read = int(torch.unique(idx).numel())
        t = timed(
            lambda: sparse_gather(val, idx, x),
            lambda: sparse_gather_ref(val, idx, x),
            lambda: torch.sparse.mm(csr, xc),
            8 * r * lanes + 4 * rows_read * bsz + 4 * r * bsz, 2 * nnz * bsz,
            F32_OPS_S,
        )
        if not x.is_contiguous():
            print(f"kernel timing [{card}]: sparse_gather at R={r} L={lanes} S={s} "
                  f"B={bsz}, x strides {x.stride()}: device {t['ms']:.5f} ms; "
                  f"on x made contiguous {device_ms(lambda: sparse_gather(val, idx, xc)):.5f}"
                  f" ms; torch.sparse.mm on the strided x "
                  f"{device_ms(lambda: torch.sparse.mm(csr, x)):.5f} ms")
        return t

    def temporal_layouts(val, idx, s, steps):
        """run_temporal's call: (T, B, S) spikes as (S, T.B) columns, copied
        source-major then gathered, against the strided view gathered."""
        xtb = (torch.rand((steps, MICRO_BATCH, s), device="cuda") < 0.2).float()
        view = xtb.permute(2, 0, 1).reshape(s, steps * MICRO_BATCH)
        require(torch.equal(sparse_gather(val, idx, view),
                            sparse_gather(val, idx, view.contiguous())),
                "sparse_gather: the temporal view differs from its copy")
        copied = device_ms(lambda: sparse_gather(val, idx, view.contiguous()))
        strided = device_ms(lambda: sparse_gather(val, idx, view))
        print(f"kernel timing [{card}]: sparse_gather at the temporal shape "
              f"R={val.shape[0]} L={val.shape[1]} B={steps * MICRO_BATCH}: copy "
              f"to (S, T.B) then gather {copied:.5f} ms; gather from the strided "
              f"view {strided:.5f} ms")

    def scan_row(shape, seed):
        # one f32 read and one f32 write an element, a multiply and an add;
        # no single PyTorch call computes the scan at general alpha
        c = scan_inputs(shape, seed, "int")
        steps, feat = shape
        t = timed(
            lambda: lif_parallel_scan(c, alpha=0.5),
            lambda: lif_parallel_scan_ref(c, alpha=0.5),
            None, 8 * steps * feat, 2 * steps * feat, F32_OPS_S,
            # the plain version is 2T launches: keep its graph small
            plain_iters=max(2, 2000 // steps),
        )
        k1 = device_ms(lambda: lif_parallel_scan(c, alpha=1.0))
        cs = device_ms(lambda: torch.cumsum(c, dim=0))
        print(f"kernel timing [{card}]: lif_parallel_scan at {shape}, alpha 1: "
              f"device {k1:.5f} ms; torch.cumsum (the same function at alpha "
              f"1 only, a comparison, not the library row) {cs:.5f} ms")
        return t

    def ssd_row(shape, seed):
        # each operand read once (B and C once per group), y and the state
        # written once; the products this function needs: the scores C.B^T
        # once a group (they carry no decay, so the heads of a group share
        # them) and over j <= i only (the causal half is zero by
        # construction), the decayed scores times X a head, and the state's;
        # each runs as three TF32 products (3xTF32)
        g, q, h, p, n, hg = shape
        ops = ssd_inputs(shape, seed)
        pairs = q * (q + 1) // 2
        flops = g * hg * pairs * 2 * n + g * h * (pairs * 2 * p + 2 * q * n * p)
        per_head = g * h * (pairs * (2 * n + 2 * p) + 2 * q * n * p)
        n_bytes = 4 * (2 * g * q * h * p + 2 * g * q * hg * n + g * q * h + g * h * n * p)
        t = timed(
            lambda: ssd_chunk(*ops), lambda: ssd_chunk_ref(*ops), None,
            n_bytes, 3 * flops, TF32_OPS_S, plain_iters=5,
        )
        print(f"kernel timing [{card}]: ssd_chunk at {shape}: bound "
              f"{t['bound_ms']:.5f} ms by {t['bound_by']} (3xTF32: "
              f"{3 * flops / 1e9:.2f} GFLOP at 495 TFLOP/s "
              f"{3 * flops / TF32_OPS_S * 1e3:.5f} ms, or "
              f"{3 * per_head / TF32_OPS_S * 1e3:.5f} ms for {3 * per_head / 1e9:.2f} "
              f"GFLOP with the scores once a head; {n_bytes / 1e6:.1f} MB at 3.35 TB/s "
              f"{n_bytes / HBM_BYTES_S * 1e3:.5f} ms); f32 CUDA-core bound with "
              f"the scores once a head {per_head / F32_OPS_S * 1e3:.5f} ms "
              f"({per_head / 1e9:.2f} GFLOP); kernel at "
              f"{3 * flops / t['ms'] / 1e9:.1f} TFLOP/s of TF32 products")
        return t

    def fmt(x):
        return "n/a" if x is None else f"{x:.5f}"

    def show(name, where, t):
        ek, ep, el = t["eager"]
        print(f"kernel timing [{card}]: {name} at {where}: device "
              f"{t['ms']:.5f} ms (plain {t['plain_ms']:.5f}, library "
              f"{fmt(t['library_ms'])}; bound {t['bound_ms']:.6f} ms by "
              f"{t['bound_by']}); eager per call {ek:.5f} ms (plain "
              f"{ep:.5f}, library {fmt(el)})")

    extra = {
        "lif_update": [((1024, 128), 1)],
        "spike_wdm_matmul": [(512, 2048, 128, 1)],
        "sparse_gather": [tuple(ell_inputs(4096, 32, 2048, 8, 1)), temporal_gather],
        "lif_parallel_scan": [((512, 512), 1)],
        "ssd_chunk": [((1, 256, 24, 64, 128, 1), 1), ((16, 256, 24, 64, 128, 24), 1)],
    }
    fns = {"lif_update": lif_row, "spike_wdm_matmul": wdm_row,
           "sparse_gather": gather_row, "lif_parallel_scan": scan_row,
           "ssd_chunk": ssd_row}
    rows = []
    for name, fn in fns.items():
        t = fn(*path[name])
        show(name, "the path shape " + path_desc(name, path[name]), t)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": err[name],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        })
        for args in extra[name]:
            show(name, path_desc(name, args), fn(*args))
    val, idx, x = path["sparse_gather"]
    temporal_layouts(val, idx, x.shape[0], temporal_steps)
    return rows


def path_desc(name, args):
    if name == "sparse_gather":
        val, _, x = args
        return (f"R={val.shape[0]} L={val.shape[1]} S={x.shape[0]} B={x.shape[1]}"
                + ("" if x.is_contiguous() else f" (x strides {x.stride()})"))
    if name in ("lif_update", "lif_parallel_scan", "ssd_chunk"):
        return str(args[0])
    return str(tuple(args[:3]))


def path_shapes(net, reports, batch):
    """The kernels' shapes on the served path, from the executables."""
    from repro_torch.core.runtime import network_executable

    lif, wdm, ell = set(), set(), []
    for rep in reports.values():
        exe = network_executable(net, rep)
        forms = exe.serial_forms(batch)
        for i, (meta, form) in enumerate(zip(exe.metas, forms)):
            lif.add((batch, meta.n_target))
            if meta.paradigm == "parallel":
                wdm.add((meta.n_target, int(exe.params[i][0].shape[1]), batch))
            elif form == "sparse":
                val, idx = exe._sparse_param(i)
                ell.append((val, idx, meta.n_source))
    return sorted(lif), sorted(wdm), ell


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this test needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build_kernels, launch_counts, reset_launch_counts

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    build_kernels()
    print(f"build: {len(REPLACES)} kernels built or found in "
          f"{time.perf_counter() - t0:.1f} s")
    from repro_torch.kernels import _build
    for name in ("sparse_gather", "ssd_chunk"):
        report = _build.ptxas_report(name)
        require(bool(report), f"no ptxas report for {name}")
        for kernel, usage in report:
            print(f"ptxas: {name}: {kernel}: {usage}")
    fixed = {
        "lif_update": [(256, 128), (300, 36), (1, 1), (1000, 3), (1024, 128)],
        "spike_wdm_matmul": [(4, 16, 1), (128, 128, 128), (128, 512, 128),
                             (300, 700, 36), (1, 1, 1), (257, 1025, 129),
                             (512, 2048, 128)],
        # (R, L, S, B[, layout]): the reference's shapes, then both designs
        # (B <= 32, B > 32) on ragged rows with strided spikes
        "sparse_gather": [(4096, 32, 2048, 8), (3000, 17, 500, 3), (1, 1, 1, 1),
                          (40, 78, 2048, 8, "transposed"), (40, 1, 2048, 32, "sliced"),
                          (40, 78, 2048, 33, "transposed"), (40, 78, 2048, 600),
                          (40, 78, 2048, 600, "transposed"), (1000, 5, 300, 3, "sliced")],
        "lif_parallel_scan": [(75, 160), (75, 32), (300, 130), (512, 512), (1, 1)],
        # (G, Q, H, P, N[, Hg]): tests/test_kernels.py::TestSSDChunk's
        # shapes, mamba2-130m's prefill path (batch 4 x 4 chunks) per head
        # and with its one group of B and C, ragged edges per head and per
        # group
        "ssd_chunk": [(1, 256, 24, 64, 128), (1, 64, 3, 16, 32), (1, 16, 1, 8, 8),
                      (1, 128, 5, 32, 64), (16, 256, 24, 64, 128),
                      (3, 100, 2, 80, 130), (16, 256, 24, 64, 128, 1),
                      (1, 256, 24, 64, 128, 1), (3, 100, 6, 80, 130, 2),
                      (2, 64, 4, 16, 32, 2)],
    }
    err = check_kernels(fixed)
    print("build: kernels equal their plain versions at the reference's test "
          "and benchmark shapes (the scan bitwise at alpha in "
          f"{list(SCAN_ALPHAS)}; the SSD block within rtol = atol = 1e-4, "
          f"max |diff| {err['ssd_chunk']:.3e}, at most {err['ssd_chunk/tol']:.3f} of "
          "the tolerance)")

    # 2. compile
    net = gesture_net()
    reports, clf = compile_reports(net)
    reqs = make_requests()
    batches = [micro_batch(reqs[:MICRO_BATCH]), micro_batch(reqs[MICRO_BATCH:])]
    lif_s, wdm_s, ell_s = path_shapes(net, reports, MICRO_BATCH)
    # the temporal path scans (T, B*N) per population and gathers T*B columns
    scan_s = sorted({(x.shape[0], MICRO_BATCH * n)
                     for x, _ in batches for n in net.layer_sizes[1:]})
    print(f"compile: path shapes: lif {lif_s}, wdm {wdm_s}, ell "
          f"{[(tuple(v.shape), s) for v, _, s in ell_s]}, scan {scan_s}")
    path_err = check_kernels({
        "lif_update": lif_s, "spike_wdm_matmul": wdm_s,
        # the fused step hands its (B, S) spikes over as the view x_t.t()
        "sparse_gather": [(v.shape[0], v.shape[1], s, MICRO_BATCH, "transposed")
                          for v, _, s in ell_s],
        "lif_parallel_scan": scan_s,
        "ssd_chunk": [],
    })
    from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
    t_cols = max(x.shape[0] for x, _ in batches) * MICRO_BATCH
    for val, idx, s in ell_s:           # the compiled ELL operands themselves
        for cols in (MICRO_BATCH, t_cols):
            # the fused step's view of its (B, S) spikes; the temporal
            # path's source-major copy
            x = ((torch.rand((cols, s), device="cuda") < 0.2).float().t()
                 if cols == MICRO_BATCH else
                 (torch.rand((s, cols), device="cuda") < 0.2).float())
            out, ref = sparse_gather(val, idx, x), sparse_gather_ref(val, idx, x)
            require(torch.equal(out, ref),
                    "sparse_gather differs on the compiled operands")
            path_err["sparse_gather"] = max(path_err["sparse_gather"],
                                            max_abs_diff(out, ref))
    err = {k: max(err[k], path_err[k]) for k in err}

    # 3. serve, fused: the main path, with the launch counts read around it
    oracles = lane_oracles(net, batches)
    reset_launch_counts()
    served = serve_main_path(net, reports, batches)
    counts = launch_counts()
    print(f"serve: launches on the served path: {counts}")
    for name in ("lif_update", "spike_wdm_matmul", "sparse_gather"):
        require(counts[name] > 0, f"{name} was never launched on the served path")
    hold_replies(net, reports, batches, served, oracles)

    # 4. serve, temporal: the second path, counts read around it alone
    reset_launch_counts()
    t_served, t_records = serve_temporal(net, reports, batches)
    t_counts = launch_counts()
    print(f"temporal: launches on the temporal path: {t_counts}")
    for name in ("lif_parallel_scan", "sparse_gather"):
        require(t_counts[name] > 0, f"{name} was never launched on the temporal path")
    hold_temporal(net, reports, batches, t_served, served, t_records, oracles)

    # 5. the exact reset modes, 6. the step-serial block
    exact_modes(clf, batches)
    hybrid_block()

    # 7. serve mamba2-130m: f32 against the CPU (K5 counted around it), bf16 timed
    cfg32, host32, steps32, greedy32, ssd_launches = serve_mamba2_f32()

    for name, rep in reports.items():
        time_serving(net, name, rep, batches[0], card)
        time_temporal(net, name, rep, batches[1], card)
    serve_mamba2_bf16(card, host32, steps32, greedy32)

    gather_args = max(ell_s, key=lambda e: e[0].numel())
    ga_val, ga_idx, ga_s = gather_args
    path = {
        "lif_update": ((MICRO_BATCH, max(n for _, n in lif_s)), 0),
        "spike_wdm_matmul": (*max(wdm_s, key=lambda s: s[0] * s[1]), 0),
        # the fused step's spikes: the view x_t.t() of a (B, S) matrix
        "sparse_gather": (
            ga_val, ga_idx,
            (torch.rand((MICRO_BATCH, ga_s), device="cuda") < 0.2).float().t(),
        ),
        "lif_parallel_scan": (max(scan_s), 0),
    }
    temporal_gather = (
        ga_val, ga_idx, (torch.rand((ga_s, t_cols), device="cuda") < 0.2).float(),
    )
    launches = {k: counts[k] + t_counts[k] for k in counts}
    launches["ssd_chunk"] += ssd_launches
    ssm = cfg32.ssm
    path["ssd_chunk"] = ((LM_BATCH * -(-LM_PROMPT // ssm.chunk), ssm.chunk,
                          ssm.expand * cfg32.d_model // ssm.head_dim,
                          ssm.head_dim, ssm.d_state, ssm.n_groups), 0)
    rows = kernel_rows(path, err, launches, card, temporal_gather,
                       max(x.shape[0] for x, _ in batches))
    print(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
