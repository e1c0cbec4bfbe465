#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; exits non-zero, printing no result, without them.  Nine phases,
none of which is caught and swallowed:

1. **Build.**  Compile the five CUDA sources from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together), print the card's name
   and power limit, and hold each of the eight kernel entry points against
   its plain PyTorch version on the card: the LIF update bitwise on ``v``
   and ``z`` with ``alpha`` in {0.5, 0.9}; the population step
   (``lif_step``: ring delivery, sum, fire, int8 carry, spike row) bitwise
   on ``v``, ``z``, the spike row and every ring, for every in-edge kind
   (a parallel current; a serial ring with the sparse, dense and event
   updates) at ``alpha`` in {0.5, 0.9}, up to eight edges and at 80,000
   neurons; the int8 WDM matmul and the ELL
   gather exactly (the gather also with its spikes as strided views and at
   600 columns; both WDM entries also at a batch of 70,000), the parallel
   projection (the WDM matmul gathering its
   stacked rows from the spike ring) exactly for t past the ring depth,
   the affine membrane scan bitwise at ``alpha`` in {0, 0.5, 0.9, 1} on
   integer and normal currents, the fused fixed point of the iterative
   reset mode bitwise with equal pass counts and residuals at ``alpha`` in
   {0.5, 0.9} and caps 1 (or 2) and T+1 (staged in shared memory, above the
   staging limit, and at T = 60,000 with its spike words in device
   memory, against the plain version on a CPU copy), the SSD intra-chunk
   block within ``rtol = atol =
   1e-4`` (the reference's tolerance; B and C per head and per group of
   heads), at the paths' shapes and at the shapes of the reference
   package's kernel tests and kernel benchmark; and the fused wrappers'
   refusals.  ptxas's registers, shared memory and spills are printed for
   every source.
2. **Compile.**  Train AdaBoost on a reduced paradigm-dataset grid that
   holds the gesture regime, and compile the paper's gesture network
   (2048-20-4, density 0.0316, §IV-C) under ``classifier``, ``serial``
   and ``parallel``.
3. **Serve, fused.**  Sixteen seeded requests (25-75 steps, widths
   2048/1536/1024 zero-padded to 2048, rate 0.2) as two padded
   micro-batches of 8 through ``network_executable(...).run_device(...,
   valid_steps=...)`` and ``run_batched`` (which must give the same bits
   and record the same forms) for each report.  Every reply must equal,
   bit for bit, the request run alone at batch 1 on the card, the port on
   the CPU, and ``run_graph_reference``.  One parallel edge's step must be two
   device operations (the fused K2 and the ring write) and no host wait;
   a whole step must be its projections' operations (two a parallel edge,
   K3 a sparse serial edge) and one ``lif_step`` a population, counted
   from the profiler at two train lengths, with no host wait in a launch;
   ``run_batched`` must take the same device operations a step.
3b. **Serve, engine.**  ``repro_torch.serving.ServingEngine`` serves
   ``examples/serve_snn.py``'s traffic (64 Poisson requests at 500/s,
   25-75 steps, widths 2048/1536/1024, rate 0.2, ~30% to the all-parallel
   model ``parallel-all``, ~25% priority 2 with a 2 s deadline, seed 0)
   under continuous admission with the classifier-switched report as
   ``default``, then the same requests replayed to ``default`` in one
   drain.  Every reply must equal the request alone on the card, the port
   on the CPU and ``run_graph_reference``; after warmup nothing re-lowers
   and every launch is a bucket hit; both launch paths run (full buckets
   ``run_batched``, partial ``run_device``); the launch supervisor counts
   no fault; and ``lif_step``, ``spike_wdm_project`` and ``sparse_gather``
   launch exactly as often as the launches' steps imply.  Requests a
   second, p50/p95 latency and one supervised launch's host time beside
   ``run_device``'s (in turns) are printed.
4. **Serve, temporal.**  The same micro-batches through ``run_temporal``
   (whole-train projections, the fused K4 once per iterative population
   for its whole fixed point, K3 for the sparse projections over all T·B
   columns).  Every reply must equal the
   report's ``run_device`` reply on the card, the port's ``run_temporal``
   on the CPU and ``run_graph_reference``; every residual is 0 and the
   card's pass counts equal the CPU's.
5. **Exact modes.**  The gesture net with alpha 0 (``alpha0`` in both
   populations) and alpha 1 (``iterative``, then ``count``) through
   ``run_temporal`` under ``classifier``, held the same way.
6. **Step-serial block.**  A small recurrent graph (self-loop on the
   hidden population) through ``run_temporal``: its back-edge interval
   runs the step-serial loop (K1's ``lif_step``, K2) between whole-train
   populations; it and a graph with a self-loop and a feedback edge
   (``examples/recurrent_snn.py``) also run through ``run_device``, held
   against ``run_graph_reference``.
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

8. **The cerebellum scaffold** (``repro_torch.scaffold``) at 10,000 and
   100,000 neurons, ``build_cerebellum(n, seed=2024)`` and
   ``compile_scaffold``, not cut; its paradigms, forms and WDM and ELL
   shapes must be the JAX package's.  The spec-rate two-input stimulus (64
   steps, seed 7) through ``run_device`` at batch 1 (the event form) and 8,
   ``run_batched``, ``shard()`` then ``run_device``, ``run_device`` with
   ``valid_steps`` and ``run_temporal`` (refused at 10k, as by the
   reference); each path's kernel launches counted around it alone and
   held to what its steps and forms imply.  Every reply must equal the
   port on the CPU on every lane and ``run_graph_reference`` (at 100k over
   lanes 0 and 1 and the first 16 steps); ``run_temporal``'s passes and
   residuals the CPU's.  At 10k ``profile_run`` on the card must equal the
   CPU's; at 100k ``ServingEngine`` serves 16 two-input payloads (32-64
   steps), every reply equal to its solo ``run_device``, with no
   re-lowering, miss or supervisor fault.  Each path is timed (host and
   device ms a launch, busy share, host waits, device operations a step
   held to its projections' operations plus one ``lif_step`` a
   population), and every kernel is held to its plain version and timed at
   the scaffold's own operands beside its bound and a library call
   (``torch._int_mm`` for K2, ``torch.sparse.mm`` for K3).

Earlier lines print the kernels' launch counts on each served path, their
times (CUDA events) beside the plain versions' and a library call's, and
the served micro-batch's time per step on both paths, each beside the
route the fused kernels replaced (on ``run_device`` the population step's
eager glue around the standalone K1, on ``run_temporal`` the per-pass loop
with the standalone K4), timed in turns in the same run, with the host
waits of a launch counted; and the card's launch floor (an empty kernel,
graph-replayed) beside ``lif_step``.

The two lines before the card line are the ``scaffold`` and ``kernels`` JSON
objects; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
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
#: kernel entry point -> the TPU kernel it replaces
REPLACES = {
    "lif_update": "src/repro/kernels/lif_update/kernel.py:41",
    "lif_step": "src/repro/kernels/lif_update/kernel.py:41",
    "spike_wdm_matmul": "src/repro/kernels/spike_wdm_matmul/kernel.py:54",
    "spike_wdm_project": "src/repro/kernels/spike_wdm_matmul/kernel.py:54",
    "sparse_gather": "src/repro/kernels/sparse_gather/kernel.py:48",
    "lif_parallel_scan": "src/repro/kernels/lif_parallel_scan/kernel.py:70",
    "lif_fixed_point": "src/repro/kernels/lif_parallel_scan/kernel.py:70",
    "ssd_chunk": "src/repro/kernels/ssd_chunk/kernel.py:64",
}
#: entry points whose source under src/repro_torch/csrc has another name
SOURCE = {"spike_wdm_project": "spike_wdm_matmul",
          "lif_fixed_point": "lif_parallel_scan", "lif_step": "lif_update"}
#: the population step's in-edge kinds: a parallel current, and a serial ring
#: with its form's update layout (sparse: K3's (d*N, B) output viewed (d, B,
#: N); dense: contiguous; event: a (B, d, N) scatter viewed (d, B, N))
EDGE_KINDS = ("current", "sparse", "dense", "event")
#: the fused fixed point's caps ("T+1" lets every column converge) and alphas
FP_CAPS, FP_ALPHAS = ("1", "T+1"), (0.5, 0.9)
#: cycles of one step of the fixed point's dependent chain (an f32 multiply
#: and an add, about 4 cycles each on the H100)
CHAIN_CYCLES = 8
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


def sync_count(fn) -> int:
    """How many times ``fn`` makes the host wait for the card (CUDA's sync
    debug mode warns once per synchronising call)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return float(out[0]) * 1e6


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


def fixed_point_inputs(shape, seed):
    """(T, F) integer currents in [-40, 120): reset cascades that take the
    columns different numbers of passes to settle."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(-40, 120, shape), dtype=torch.float32).cuda()


def long_train(steps, feat, seed):
    """(T, F) currents that settle in at most 4 passes (tests/test_torch_cuda.py
    ``long_train``): integers far below the threshold of 64, rare pulses of
    100.  Returned on the host, where its plain version runs."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-12, 1, (steps, feat)).astype(np.float32)
    pulse = rng.random((steps, feat)) < 0.002
    return torch.from_numpy(np.where(pulse, np.float32(100.0), c))


def step_inputs(kinds, batch, n, d_slots, t, seed, alpha):
    """One population step's operands on the card: per in-edge kind a
    current or a ring with its form's update as the strided view the
    executor hands over (tests/test_torch_cuda.py ``lif_step_operands``),
    integer currents, a real-valued membrane near ``v_th``, int8 spikes.
    Returns ``(edges, v, z, out, v_th)``."""
    from repro_torch.kernels.lif_update import CurrentEdge, RingEdge

    rng = np.random.default_rng(seed)
    v_th, scale = (64.0, 40) if alpha == 0.5 else (1.0, 1)

    def ints(shape):
        return torch.tensor(rng.integers(-3, 4, shape) * scale,
                            dtype=torch.float32).cuda()

    edges = []
    for kind in kinds:
        if kind == "current":
            edges.append(CurrentEdge(ints((batch, n))))
            continue
        ring = ints((d_slots, batch, n))
        if kind == "sparse":
            upd = ints((d_slots * n, batch)).view(d_slots, n, batch).permute(0, 2, 1)
        elif kind == "dense":
            upd = ints((d_slots, batch, n))
        else:
            upd = ints((batch, d_slots, n)).transpose(0, 1)
        edges.append(RingEdge(ring, upd, 0 if kind == "event" else t))
    v = torch.tensor(rng.normal(size=(batch, n)) * v_th, dtype=torch.float32).cuda()
    z = torch.tensor(rng.integers(0, 2, (batch, n)), dtype=torch.int8).cuda()
    return edges, v, z, torch.full((batch, n), -1.0, device="cuda"), v_th


def clone_step(ops):
    """A deep copy of :func:`step_inputs`' operands (rings and carry are
    updated in place), the updates keeping their strides."""
    from repro_torch.kernels.lif_update import CurrentEdge, RingEdge

    def keep(x):                     # same strides, own memory
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device=x.device).copy_(x)

    edges, v, z, out, v_th = ops
    copy = [RingEdge(keep(e.ring), keep(e.upd), e.shift)
            if isinstance(e, RingEdge) else CurrentEdge(keep(e.i)) for e in edges]
    return copy, keep(v), keep(z), keep(out), v_th


def step_diff(a, b) -> float:
    """max |diff| of two population steps over v, z, the spike row and the
    rings; inf unless every one of them is bitwise equal."""
    from repro_torch.kernels.lif_update import RingEdge

    pairs = [(a[1], b[1]), (a[3], b[3])] + [
        (x.ring, y.ring) for x, y in zip(a[0], b[0]) if isinstance(x, RingEdge)]
    same = torch.equal(a[2], b[2]) and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in pairs)
    return max(max_abs_diff(x, y) for x, y in pairs) if same else float("inf")


def project_inputs(m, k, batch, depth, n_source, seed):
    """wdm (M, K), the merging table (K,) x 2 and a (B, d, S) int8 ring."""
    rng = np.random.default_rng(seed)
    ops = (rng.integers(-128, 128, (m, k)), rng.integers(0, n_source, k),
           rng.integers(1, depth + 1, k), rng.random((batch, depth, n_source)) < 0.3)
    return [torch.tensor(a, dtype=dt).cuda()
            for a, dt in zip(ops, (torch.int8, torch.int32, torch.int32, torch.int8))]


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
        lif_fixed_point, lif_fixed_point_ref, lif_parallel_scan,
        lif_parallel_scan_ref, shared_words_limit, staged_steps_limit,
    )
    from repro_torch.kernels.lif_update import (
        lif_step, lif_step_ref, lif_update, lif_update_ref,
    )
    from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
    from repro_torch.kernels.spike_wdm_matmul import (
        spike_wdm_matmul, spike_wdm_matmul_ref, spike_wdm_project,
        spike_wdm_project_ref,
    )
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref

    err = {name: 0.0 for name in REPLACES}
    for seed, (kinds, batch, n, d_slots) in enumerate(shapes["lif_step"]):
        for alpha in (0.5, 0.9):
            for t in (0, 2 * d_slots + 1):
                got = step_inputs(kinds, batch, n, d_slots, t, seed, alpha)
                want = clone_step(got)
                lif_step(*got[:4], t, alpha=alpha, v_th=got[4])
                lif_step_ref(*want[:4], t, alpha=alpha, v_th=want[4])
                torch.cuda.synchronize()
                diff = step_diff(got, want)
                require(diff < float("inf"), f"lif_step not bitwise with edges "
                        f"{kinds} at {(batch, n)}, d {d_slots}, t {t}, alpha {alpha}")
                err["lif_step"] = max(err["lif_step"], diff)
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
    for seed, (steps, feat) in enumerate(shapes["lif_fixed_point"]):
        # None: a train longer than the shared-memory staging limit; "long":
        # T = 60,000, past the spike words' limit, its plain version run on
        # a CPU copy (the per-step loop on the card would take minutes)
        long = steps == "long"
        if long:
            steps, host = 60_000, long_train(60_000, feat, feat)
            require(steps > shared_words_limit(torch.device("cuda")),
                    "T = 60,000 fits the spike words' shared-memory limit")
            i = host.cuda()
        else:
            steps = steps or staged_steps_limit(torch.device("cuda")) + 48
            i = fixed_point_inputs((steps, feat), seed)
            host = i
        for alpha in FP_ALPHAS:
            for cap in FP_CAPS:
                cap = (2 if long else 1) if cap == "1" else steps + 1
                z, iters, resid = lif_fixed_point(i, alpha=alpha, v_th=64.0, cap=cap)
                zr, iters_r, resid_r = lif_fixed_point_ref(host, alpha=alpha,
                                                          v_th=64.0, cap=cap)
                z = z.to(zr.device)
                require(torch.equal(z, zr) and (iters, resid) == (iters_r, resid_r),
                        f"lif_fixed_point differs at {(steps, feat)}, alpha "
                        f"{alpha}, cap {cap}: passes {iters} vs {iters_r}, "
                        f"residual {resid} vs {resid_r}")
                # one pass from silence flips every spike it fires
                require(long or resid == (int(z.sum()) if cap == 1 else 0),
                        f"lif_fixed_point residual {resid} at cap {cap}")
                require(not long or iters <= 4,
                        f"lif_fixed_point: {iters} passes on the long train")
                err["lif_fixed_point"] = max(err["lif_fixed_point"],
                                             max_abs_diff(z, zr),
                                             abs(iters - iters_r), abs(resid - resid_r))
    for shape in ((0, 160), (75, 0)):
        z, iters, resid = lif_fixed_point(torch.zeros(shape, device="cuda"),
                                          alpha=0.5, v_th=64.0, cap=3)
        require(z.shape == shape and (iters, resid) == (1, 0), f"empty {shape}")
    for seed, (m, k, b, depth, s) in enumerate(shapes["spike_wdm_project"]):
        ops = project_inputs(m, k, b, depth, s, seed)
        for t in range(3 * depth + 1):      # wraps around the ring
            out, ref = spike_wdm_project(*ops, t), spike_wdm_project_ref(*ops, t)
            require(out.dtype == torch.float32 and torch.equal(out, ref),
                    f"spike_wdm_project differs at {(m, k, b, depth, s)}, t={t}")
            err["spike_wdm_project"] = max(err["spike_wdm_project"],
                                           max_abs_diff(out, ref))
    for offset in (1, 2, 3):        # a WDM view off a 4-byte boundary
        wdm, src, dly, ring = project_inputs(20, 965, 8, 4, 2048, offset)
        view = torch.zeros(wdm.numel() + 8, dtype=torch.int8, device="cuda")[
            offset:offset + wdm.numel()].view(wdm.shape)
        view.copy_(wdm)
        stacked = ring[:, 0, :965].contiguous()
        require(view.data_ptr() % 4 == offset
                and torch.equal(spike_wdm_project(view, src, dly, ring, 3),
                                spike_wdm_project_ref(view, src, dly, ring, 3))
                and torch.equal(spike_wdm_matmul(view, stacked),
                                spike_wdm_matmul_ref(view, stacked)),
                f"the WDM kernels differ on a WDM at byte offset {offset}")
    f32 = torch.zeros((6, 4), device="cuda")
    w8, i8 = (torch.zeros(shape, dtype=torch.int8, device="cuda")
              for shape in ((3, 4), (2, 2, 4)))
    i32 = torch.zeros(4, dtype=torch.int32, device="cuda")
    for what, call, exc in (
        ("f64", lambda: lif_fixed_point(f32.double(), alpha=0.5, v_th=1.0, cap=2), TypeError),
        ("strided", lambda: lif_fixed_point(f32.T, alpha=0.5, v_th=1.0, cap=2), ValueError),
        ("i64 table", lambda: spike_wdm_project(w8, i32.long(), i32, i8, 0),
         TypeError),
        ("f32 ring", lambda: spike_wdm_project(w8, i32, i32, i8.float(), 0),
         TypeError),
        ("strided ring", lambda: spike_wdm_project(w8, i32, i32,
                                                   i8.transpose(0, 1), 0), ValueError),
    ):
        try:
            call()
        except exc:
            continue
        raise SmokeFailure(f"a fused wrapper took a {what} operand")
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
    card, and through run_batched (the engine's path for full buckets),
    which must give the same bits, for each report.  Returns the replies
    as host arrays."""
    from repro_torch.core.runtime import network_executable

    served = {}
    for name, rep in reports.items():
        exe = network_executable(net, rep)
        served[name] = []
        for x, vs in batches:
            outs = exe.run_device(x, valid_steps=vs)
            require(bool(exe.last_check), f"{name}: last_check is False")
            batched = exe.run_batched(x, valid_steps=vs)
            require(bool(exe.last_check), f"{name}: batched last_check is False")
            require(same_replies(outs, batched),
                    f"{name}: run_batched differs from run_device")
            served[name].append([z.cpu().numpy() for z in outs])
        require(rep.serial_forms[("vmap", MICRO_BATCH)]
                == rep.serial_forms[("fused", MICRO_BATCH)],
                f"{name}: run_batched chose other forms than run_device")
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


# -- 3b. serve through the engine ------------------------------------------------
#: examples/serve_snn.py's second tenant: the all-parallel compilation
ALT_MODEL = "parallel-all"
#: serve_snn.py's traffic: requests, base steps (mix 0.5x-1.5x), input
#: spike rate, Poisson arrivals a second, seed
ENGINE_TRAFFIC = dict(n_requests=64, base_steps=50, rate=0.2, arrival_hz=500.0)


def poisson_traffic(rng, n_requests, base_steps, rate, arrival_hz):
    """examples/serve_snn.py's Poisson arrivals: steps in [base/2,
    3*base/2], one of three widths, ~30% to the second model, ~25%
    interactive (priority 2, 2 s deadline), the rest bulk (priority 0)."""
    lo = max(2, base_steps // 2)
    hi = max(lo, base_steps + base_steps // 2)
    width_mix = [N_INPUT, 3 * N_INPUT // 4, N_INPUT // 2]
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_hz, n_requests))
    traffic = []
    for t_arr in arrivals:
        steps = int(rng.integers(lo, hi + 1))
        n_in = int(rng.choice(width_mix))
        spikes = (rng.random((steps, n_in)) < rate).astype(np.float32)
        model = ALT_MODEL if rng.random() < 0.3 else "default"
        interactive = rng.random() < 0.25
        traffic.append((float(t_arr), spikes, model, 2 if interactive else 0,
                        2000.0 if interactive else None))
    return (lo, hi), traffic


def engine_ready(net, reports):
    """serve_snn.py's engine: the classifier-switched report as "default",
    the all-parallel one as ALT_MODEL, every bucket of the traffic warmed.
    Every pool launch is recorded as (model, bucket steps)."""
    from repro_torch.serving import ServingEngine

    (lo, hi), traffic = poisson_traffic(np.random.default_rng(0),
                                        **ENGINE_TRAFFIC)
    engine = ServingEngine(net, reports["classifier"], micro_batch=MICRO_BATCH,
                           min_bucket_steps=8)
    warmed = engine.warmup(list(range(lo, hi + 1)))
    engine.register_model(net, reports["parallel"], ALT_MODEL,
                          warm_steps=list(range(lo, hi + 1)))
    launched = []
    run = engine.pool.run_microbatch

    def recorded(mb, name=None, **kw):
        launched.append((name or mb.model, mb.key.steps))
        return run(mb, name, **kw)

    engine.pool.run_microbatch = recorded
    print(f"engine: 2 models, {warmed} bucket shapes warmed for steps {lo}..{hi}, "
          f"{len({sp.shape for _, sp, *_ in traffic})} distinct request shapes "
          "inbound")
    return engine, traffic, launched


def serve_engine(engine, traffic):
    """The SNN user's path, as examples/serve_snn.py drives it: Poisson
    arrivals under continuous admission (one bucket a step_continuous),
    then the same requests replayed to "default" in one drain (full
    buckets: run_batched).  Returns the request ids of both passes, the
    stats after the Poisson pass and its requests a second."""
    rids = []
    idx, t0 = 0, time.perf_counter()
    while idx < len(traffic) or not engine.queue.empty() \
            or engine.scheduler.has_open():
        now = time.perf_counter() - t0
        while idx < len(traffic) and traffic[idx][0] <= now:
            _, spikes, model, prio, deadline = traffic[idx]
            rids.append(engine.submit(spikes, model=model, priority=prio,
                                      deadline_ms=deadline))
            idx += 1
        if engine.queue.empty() and not engine.scheduler.has_open():
            time.sleep(0.001)           # idle until the next arrival is due
            continue
        engine.step_continuous()        # admit arrivals, launch ONE bucket
    wall = time.perf_counter() - t0
    stats = engine.stats()
    replay = [engine.submit(spikes) for _, spikes, *_ in traffic]
    engine.drain()
    return rids, replay, stats, stats["requests"] / wall


def hold_engine(net, reports, engine, traffic, rids, replay, launched, counts):
    """Every reply of both passes against the request alone on the card,
    the port on the CPU and run_graph_reference; the steady state (no
    re-lowering, no miss, no fault); both launch paths taken; and the
    kernels launched exactly as the launches and their steps imply."""
    from repro_torch.core.runtime import (
        NetworkExecutable, network_executable, run_graph_reference,
    )
    from repro_torch.serving import FailedReply, ShedReply

    st = engine.stats()
    sup = st["supervisor"]
    by = st["by_model"]
    require(st["relowerings"] == 0 and st["bucket_misses"] == 0,
            f"engine: {st['relowerings']} re-lowerings, {st['bucket_misses']} "
            "bucket misses after warmup")
    for k in ("retries", "degraded_launches", "validation_failures",
              "quarantined", "watchdog_stalls", "bisections"):
        require(sup[k] == 0, f"engine: supervisor counted {sup[k]} {k}")
    require(st["failed"] == 0, f"engine: {st['failed']} FailedReplies")
    for k in ("batched_launches", "fused_launches"):
        require(sum(c[k] for c in by.values()) > 0, f"engine: no {k}")
    model_rep = {"default": reports["classifier"], ALT_MODEL: reports["parallel"]}
    solo = {m: network_executable(net, r) for m, r in model_rep.items()}
    cpu = {m: NetworkExecutable.build(net, r, device="cpu")
           for m, r in model_rep.items()}
    oracle, n_held, n_shed = {}, 0, 0
    passes = [(rid, i, model) for i, (rid, (_, _, model, _, _)) in
              enumerate(zip(rids, traffic))]
    passes += [(rid, i, "default") for i, rid in enumerate(replay)]
    for rid, i, model in passes:
        reply = engine.results[rid]
        if isinstance(reply, ShedReply):
            n_shed += 1
            continue
        require(not isinstance(reply, FailedReply), f"engine: request {rid} failed")
        spikes = traffic[i][1]
        x = np.zeros((spikes.shape[0], 1, N_INPUT), np.float32)
        x[:, 0, : spikes.shape[1]] = spikes
        if i not in oracle:
            oracle[i] = run_graph_reference(net, x)
        for z, a, c, o in zip(reply, solo[model].run(x), cpu[model].run(x),
                              oracle[i]):
            require(np.array_equal(z, a[:, 0]),
                    f"engine: reply {rid} differs from its solo run on the card")
            require(np.array_equal(z, c[:, 0]),
                    f"engine: reply {rid} differs from the port on the CPU")
            require(np.array_equal(z, o[:, 0]),
                    f"engine: reply {rid} differs from run_graph_reference")
        n_held += 1
    want = {"lif_step": 0, "spike_wdm_project": 0, "sparse_gather": 0}
    for model, steps in launched:
        forms = solo[model].serial_forms(MICRO_BATCH)
        want["lif_step"] += steps * (len(net.layer_sizes) - 1)
        want["spike_wdm_project"] += steps * forms.count("-")
        want["sparse_gather"] += steps * forms.count("sparse")
    for k, n in want.items():
        require(counts[k] == n and n > 0,
                f"engine: {counts[k]} {k} launches, the {len(launched)} launches "
                f"imply {n}")
    require(counts["lif_update"] == counts["spike_wdm_matmul"] == 0,
            f"engine: standalone kernels launched: {counts}")
    print(f"engine: {n_held} replies ({len(rids)} Poisson, {len(replay)} replayed; "
          f"{n_shed} shed) bit-identical to the request alone on the card, the "
          f"port on the CPU and run_graph_reference; {len(launched)} launches "
          f"(batched {sum(c['batched_launches'] for c in by.values())}, fused "
          f"{sum(c['fused_launches'] for c in by.values())}), hits "
          f"{st['bucket_hits']}, misses {st['bucket_misses']}, re-lowerings "
          f"{st['relowerings']}, supervisor faults 0; kernel launches {want} as "
          "the launches' steps imply")


def time_engine(net, reports, engine, traffic, stats, rps, card):
    """The engine's numbers on the card: requests a second and latency of
    the Poisson pass; and one full micro-batch's launch through the
    supervisor (run_batched, the wait for the card, the flag read and the
    host copies) beside run_device alone on it with a sync, in turns."""
    from repro_torch.core.runtime import network_executable
    from repro_torch.serving import BucketKey, SNNRequest, pad_microbatch

    reqs = [SNNRequest(i, sp, 0.0) for i, (_, sp, m, _, _) in enumerate(traffic)
            if 32 < sp.shape[0] <= 64][:MICRO_BATCH]
    mb = pad_microbatch(BucketKey(steps=64, n_in=N_INPUT, batch=MICRO_BATCH),
                        reqs, "default")
    exe = network_executable(net, reports["classifier"])

    def launch_engine():
        return engine.supervisor.run(mb)

    def launch_device():
        outs = exe.run_device(mb.spikes, valid_steps=mb.valid_steps)
        torch.cuda.synchronize()
        return outs

    replies = launch_engine()
    outs = launch_device()
    for b, req in enumerate(reqs):
        for z, o in zip(replies[req.request_id], outs):
            require(np.array_equal(z, o[: req.steps, b].cpu().numpy()),
                    "engine: the supervised launch differs from run_device")
    ht, (ht_a, ht_b), hd, (hd_a, hd_b) = in_turns(launch_engine, launch_device)
    waits = sync_count(launch_engine)
    waits_d = sync_count(launch_device)
    dev, n_dev, _ = profiled_ms(launch_engine)
    lat = stats["latency_by_priority"]
    print(f"engine timing [{card}]: Poisson pass of {stats['requests']} requests "
          f"({ENGINE_TRAFFIC['arrival_hz']:.0f}/s offered): {rps:.1f} requests/s, "
          f"latency p50 {stats['p50_ms']:.3f} ms p95 {stats['p95_ms']:.3f} ms "
          f"(priority 2: p50 {lat.get(2, {}).get('p50_ms', float('nan')):.3f}, p95 "
          f"{lat.get(2, {}).get('p95_ms', float('nan')):.3f}; priority 0: p50 "
          f"{lat.get(0, {}).get('p50_ms', float('nan')):.3f}, p95 "
          f"{lat.get(0, {}).get('p95_ms', float('nan')):.3f}), mean queue wait "
          f"{stats['mean_queue_wait_ms']:.3f} ms, mean occupancy "
          f"{stats['mean_batch_occupancy']:.3f}, {stats['batches']} launches, "
          f"{stats['throughput_request_steps_per_s']:,.0f} request-steps/s, "
          f"{stats['shed']} shed")
    print(f"engine timing [{card}]: one full micro-batch of {MICRO_BATCH} (64 steps) "
          f"through the supervisor {ht:.3f} ms per launch ({ht_a:.3f}, {ht_b:.3f}), "
          f"host waits {waits}, device {dev:.3f} ms in {n_dev} launches (profiler), "
          f"busy share {dev / ht:.3f}; run_device + sync {hd:.3f} ms ({hd_a:.3f}, "
          f"{hd_b:.3f}), host waits {waits_d}; the engine adds {ht - hd:+.3f} ms "
          f"({100 * (ht / hd - 1):+.1f}%)")


def parallel_edge_ops(operands, ring):
    """One parallel edge's step on the card is the fused K2 and the ring
    write: two device operations and no host wait."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.runtime.parallel_runtime import parallel_project

    wdm, src, dly, _, n_source = operands
    x_t = (torch.rand((ring.shape[0], n_source), device="cuda") < 0.2).float()
    parallel_project(wdm, src, dly, ring, x_t, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        parallel_project(wdm, src, dly, ring, x_t, 1)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.self_cpu_time_total == 0 and e.self_device_time_total > 0]
    waits = sync_count(lambda: parallel_project(wdm, src, dly, ring, x_t, 2))
    require(sum(e.count for e in rows) == 2 and waits == 0,
            f"parallel_project: device operations "
            f"{[(e.key, e.count) for e in rows]}, {waits} host waits")
    print(f"serve: one parallel_project on the card: "
          f"{[(e.key[:40], e.count) for e in rows]}, no host wait")


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
    for name in ("lif_step", "spike_wdm_project", "lif_fixed_point"):
        require(counts[name] > 0, f"hybrid: {name} not launched")
    reset_launch_counts()
    fused = [z.cpu().numpy() for z in exe.run_device(x)]
    steps = launch_counts()["lif_step"]
    require(steps == 10 * 2, f"hybrid: {steps} lif_step launches in run_device")
    cpu = NetworkExecutable.build(net, rep, device="cpu").run(x, temporal=True)
    oracle = run_graph_reference(net, x)
    require(sum(float(z.sum()) for z in got) > 0, "hybrid: silent")
    for z, f, c, o in zip(got, fused, cpu, oracle):
        require(np.array_equal(f, o), "hybrid: run_device differs from run_graph_reference")
        require(np.array_equal(z, f), "hybrid: temporal and run_device differ")
        require(np.array_equal(z, c), "hybrid: card and CPU differ")
        require(np.array_equal(z, o), "hybrid: differs from run_graph_reference")
    print(f"hybrid: split {rec.split}, modes {rec.modes}, passes "
          f"{rec.iterations}; launches {counts}; bit-identical to run_device "
          f"({steps} lif_step launches), the CPU and run_graph_reference")


RECURRENT = (  # tests/test_torch_executor.py "recurrent" (examples/recurrent_snn.py)
    [("in", 24), ("hid", 32), ("out", 10)],
    [("in", "hid", 0.4, 2), ("hid", "hid", 0.25, 3),
     ("hid", "out", 0.5, 2), ("out", "hid", 0.3, 1)],
    ["serial", "parallel", "serial", "parallel"],
    202,
)


def recurrent_device():
    """A self-loop and a feedback edge (out -> hid) through run_device on
    the card: back-edges read their source's previous output row; held
    against run_graph_reference and the port on the CPU, masked too."""
    from repro_torch.core import CompileReport, Population, SNNNetwork, SwitchingCompiler
    from repro_torch.core.layer import LIFParams, random_projection
    from repro_torch.core.runtime import (
        NetworkExecutable, network_executable, run_graph_reference,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts

    pop_spec, proj_spec, paradigms, seed = RECURRENT
    rng = np.random.default_rng(seed)
    pops = {n: Population(n, s) for n, s in pop_spec}
    projs = []
    for pre, post, density, delay_range in proj_spec:
        p = random_projection(pops[pre], pops[post], density, delay_range,
                              seed=int(rng.integers(0, 2**31)),
                              delay_granularity=str(rng.choice(["source", "synapse"])))
        p.lif = LIFParams(alpha=0.5, v_th=64.0)
        projs.append(p)
    net = SNNNetwork(populations=list(pops.values()), projections=projs,
                     name="recurrent")
    rep = CompileReport(layers=[SwitchingCompiler(par).compile_layer(l)
                                for par, l in zip(paradigms, net.layers)])
    x = (np.random.default_rng(1).random((40, 4, net.n_input)) < 0.3).astype(np.float32)
    valid = np.array([40, 7, 23, 1], np.int32)
    exe = network_executable(net, rep)
    reset_launch_counts()
    got = [z.cpu().numpy() for z in exe.run_device(x)]
    counts = launch_counts()
    require(counts["lif_step"] == 40 * 2,
            f"recurrent: {counts['lif_step']} lif_step launches for 40 steps of 2")
    masked = [z.cpu().numpy() for z in exe.run_device(x, valid_steps=valid)]
    cpu = NetworkExecutable.build(net, rep, device="cpu")
    oracle = run_graph_reference(net, x)
    require(sum(float(z.sum()) for z in got) > 0, "recurrent: silent")
    for z, o, c in zip(got, oracle, cpu.run(x)):
        require(np.array_equal(z, o), "recurrent: run_device differs from run_graph_reference")
        require(np.array_equal(z, c), "recurrent: card and CPU differ")
    for z, c in zip(masked, cpu.run(x, valid_steps=valid)):
        require(np.array_equal(z, c), "recurrent: masked card and CPU differ")
    print(f"recurrent: back-edges {sorted(net.back_edges)} through run_device on "
          f"the card: bit-identical to run_graph_reference and to the CPU (masked "
          f"too); launches {counts}")


# -- the routes the fused entry points replaced, timed beside them ------------------
def old_fixed_point(i_flat, *, alpha, v_th, cap):
    """The per-pass loop the fused K4 replaced: the standalone scan K4 once a
    pass, about ten eager ops and one host read of the flip count a pass."""
    from repro_torch.kernels.lif_parallel_scan import lif_parallel_scan

    vth = float(v_th)
    z = torch.zeros_like(i_flat)
    iters, diff = 0, 1
    while diff > 0 and iters < cap:
        zprev = torch.cat([torch.zeros_like(z[:1]), z[:-1]])
        v = lif_parallel_scan(i_flat - zprev * vth, alpha=alpha)
        z_new = (v >= vth).to(torch.float32)
        diff = int((z_new != z).sum())
        iters, z = iters + 1, z_new
    return z, iters, diff


def old_project(wdm, col_source, col_delay, x_hist, t):
    """The gather the fused K2 replaced: slot arithmetic, an index_select
    copy of the stacked rows, the standalone K2, the cast."""
    from repro_torch.kernels.spike_wdm_matmul import spike_wdm_matmul

    batch, d, n_source = x_hist.shape
    slot = (t - col_delay.long()) % d
    stacked = x_hist.view(batch, d * n_source).index_select(
        1, slot * n_source + col_source)
    return spike_wdm_matmul(wdm, stacked).to(torch.float32)


def old_scan_network(plan, metas, forms, params, states, spikes,
                     valid_steps=None):
    """The loop the population step replaced (the executor's before it):
    each serial edge's whole projection (update, roll into the ring, copy
    out and zero the current slot), the currents summed with torch adds,
    the int8 carry cast to f32, the standalone K1, the casts back, the copy
    into the output train, and an int8 feedback ring written each step."""
    from repro_torch.core.runtime import executor
    from repro_torch.core.runtime.parallel_runtime import parallel_project
    from repro_torch.core.runtime.serial_runtime import (
        serial_project, serial_project_dense, serial_project_sparse,
    )
    from repro_torch.kernels.lif_update import lif_update

    project = {"event": serial_project, "sparse": serial_project_sparse,
               "dense": serial_project_dense}
    T, batch = spikes.shape[0], spikes.shape[1]
    live = executor._live_mask(spikes, valid_steps)
    if live is not None:
        spikes = spikes * live
    proj_states, pop_v, pop_z = states
    feedback = [torch.zeros((batch, plan.pop_sizes[s]), dtype=torch.int8,
                            device=spikes.device) for s in plan.back_sources]
    vz_slot = {p: k for k, p in enumerate(plan.update_order)}
    fb_slot = {s: k for k, s in enumerate(plan.back_sources)}
    outs = [torch.empty((T, batch, plan.pop_sizes[p]), dtype=torch.float32,
                        device=spikes.device) for p in plan.update_order]
    full_input = tuple(plan.input_slices) == ((0, spikes.shape[2]),)
    for t in range(T):
        x_t = spikes[t]
        pop_out = [None] * len(plan.pop_sizes)
        for p, (a, b) in zip(plan.input_pops, plan.input_slices):
            pop_out[p] = x_t if full_input else x_t[:, a:b]
        for p in plan.update_order:
            k = vz_slot[p]
            i_nb = None
            for ei in plan.in_edges[p]:
                meta = metas[ei]
                x = (feedback[fb_slot[plan.proj_src[ei]]].to(torch.float32)
                     if plan.proj_back[ei] else pop_out[plan.proj_src[ei]])
                if meta.paradigm == "serial":
                    _, i_e = project[forms[ei]](
                        *params[ei], proj_states[ei], x, t,
                        delay_range=meta.delay_range, n_target=meta.n_target)
                else:
                    _, i_e = parallel_project(*params[ei], proj_states[ei], x, t)
                i_nb = i_e if i_nb is None else i_nb + i_e
            v_new, z_new = lif_update(i_nb, pop_v[k], pop_z[k].to(torch.float32),
                                      alpha=plan.pop_alpha[p], v_th=plan.pop_vth[p])
            pop_v[k], pop_z[k] = v_new, z_new.to(torch.int8)
            outs[k][t] = z_new
            pop_out[p] = z_new
        for j, s in enumerate(plan.back_sources):
            feedback[j] = pop_out[s].to(torch.int8)
    if live is not None:
        outs = [z * live for z in outs]
    return outs


@contextlib.contextmanager
def old_population_route():
    """run_device runs the population route lif_step replaced while inside."""
    from repro_torch.core.runtime import executor

    saved = executor._scan_network
    executor._scan_network = old_scan_network
    try:
        yield
    finally:
        executor._scan_network = saved


@contextlib.contextmanager
def old_fixed_point_route():
    """run_temporal runs the per-pass loop the fused K4 replaced while inside."""
    from repro_torch.core.runtime import temporal_runtime

    saved = temporal_runtime.lif_fixed_point
    temporal_runtime.lif_fixed_point = old_fixed_point
    try:
        yield
    finally:
        temporal_runtime.lif_fixed_point = saved


def column_passes(i_flat, *, alpha, v_th, cap):
    """Each column's own pass count under the fused K4's stopping rule (its
    first pass with no flips, at most ``cap``), from the plain scan."""
    from repro_torch.kernels.lif_parallel_scan import lif_parallel_scan_ref

    z = torch.zeros_like(i_flat)
    passes = torch.zeros(i_flat.shape[1], dtype=torch.int64, device=i_flat.device)
    active = torch.ones_like(passes, dtype=torch.bool)
    for _ in range(cap):
        zprev = torch.cat([torch.zeros_like(z[:1]), z[:-1]])
        v = lif_parallel_scan_ref(i_flat - zprev * float(v_th), alpha=alpha)
        z_new = (v >= float(v_th)).to(torch.float32)
        passes += active
        active &= (z_new != z).any(0)
        z = z_new
        if not bool(active.any()):
            break
    return passes


def path_fixed_points(exe, x, vs):
    """The (T, F) current trains and arguments run_temporal hands the fused
    K4 on one micro-batch, one per iterative population."""
    from repro_torch.core.runtime import temporal_runtime

    seen, real = [], temporal_runtime.lif_fixed_point

    def record(i_flat, **kw):
        seen.append((i_flat.clone(), kw))
        return real(i_flat, **kw)

    temporal_runtime.lif_fixed_point = record
    try:
        exe.run_temporal(x, valid_steps=vs)
    finally:
        temporal_runtime.lif_fixed_point = real
    return seen


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


def in_turns(new, old, reps=10):
    """Host ms per launch of two routes, timed new, old, old, new."""
    n_a, o_a = host_ms(new, reps), host_ms(old, reps)
    o_b, n_b = host_ms(old, reps), host_ms(new, reps)
    return (n_a + n_b) / 2, (n_a, n_b), (o_a + o_b) / 2, (o_a, o_b)


def same_replies(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def time_temporal(net, name, rep, batch, card):
    """run_temporal through the fused K4 beside the per-pass loop it
    replaced, in the same run: host time per launch (ends in a sync), host
    waits, K4 launches, device time from the profiler; and run_device's
    host time per launch beside them."""
    from repro_torch.core.runtime import network_executable
    from repro_torch.kernels import launch_counts, reset_launch_counts

    exe = network_executable(net, rep)
    x, vs = batch
    xs = torch.as_tensor(x, device="cuda")
    vs_t = torch.as_tensor(vs, device="cuda")
    steps, req_steps = x.shape[0], int(vs.sum())

    def temporal():
        return exe.run_temporal(xs, valid_steps=vs_t)

    def temporal_old():
        with old_fixed_point_route():
            return exe.run_temporal(xs, valid_steps=vs_t)

    require(same_replies(temporal(), temporal_old()),
            f"temporal {name}: the fused and the old route differ")
    n_iter = list(rep.temporal[(len(vs), steps)].modes.values()).count("iterative")
    launches, waits = {}, {}
    for route, fn in (("fused", temporal), ("old", temporal_old)):
        reset_launch_counts()
        waits[route] = sync_count(fn)
        c = launch_counts()
        launches[route] = c["lif_fixed_point"] + c["lif_parallel_scan"]
    require(launches["fused"] == n_iter and waits["fused"] <= n_iter,
            f"temporal {name}: {launches['fused']} fused K4 launches and "
            f"{waits['fused']} host waits for {n_iter} iterative populations")
    ht, (ht_a, ht_b), ho, (ho_a, ho_b) = in_turns(temporal, temporal_old)
    hf = host_ms(lambda: exe.run_device(xs, valid_steps=vs_t))
    passes = rep.temporal[(len(vs), steps)].iterations
    dt, nt, top = profiled_ms(temporal)
    do, no, _ = profiled_ms(temporal_old)
    print(f"temporal timing [{card}]: {name} micro-batch of {len(vs)} ({steps} "
          f"steps), K4 passes {passes}: fused route {ht:.3f} ms per launch "
          f"({ht_a:.3f}, {ht_b:.3f}), {ht / steps * 1e3:.1f} us per step, "
          f"{req_steps / ht * 1e3:,.0f} request-steps/s, K4 launches "
          f"{launches['fused']}, host waits {waits['fused']}, device {dt:.3f} ms "
          f"in {nt} launches; old route (per-pass loop) {ho:.3f} ms ({ho_a:.3f}, "
          f"{ho_b:.3f}), K4 launches {launches['old']}, host waits {waits['old']}, "
          f"device {do:.3f} ms in {no} launches; host time {100 * (ht / ho - 1):+.1f}%;"
          f" run_device {hf:.3f} ms per launch")
    print(f"temporal profile [{card}]: {name}: top: {top}")


def launch_pair(net, rep, batch, steps=None):
    """run_device of one micro-batch (cut to its first ``steps`` steps when
    given) through the population step, through the route it replaced, and
    run_batched of the same micro-batch."""
    from repro_torch.core.runtime import network_executable

    exe = network_executable(net, rep)
    x, vs = batch
    xs = torch.as_tensor(x[:steps], device="cuda")
    vs_t = torch.as_tensor(np.minimum(vs, xs.shape[0]), device="cuda")

    def launch():
        return exe.run_device(xs, valid_steps=vs_t)

    def launch_old():
        with old_population_route():
            return exe.run_device(xs, valid_steps=vs_t)

    def launch_batched():
        return exe.run_batched(xs, valid_steps=vs_t)

    return launch, launch_old, launch_batched


def step_ops(net, name, rep, batch):
    """Device operations a step of run_device, from the profiler at two
    train lengths (their difference over the steps between them, so the
    launch's constant part drops out), for the population-step route and
    the one it replaced.  The profiler can drop activity records but never
    adds any, so each count is the largest of three profiles.  A step must
    be its projections' operations (the fused K2 and the ring copy a
    parallel edge, K3 a sparse serial edge) and one lif_step a population;
    a launch waits for the card nowhere.  run_batched must cost the same
    device operations a step as run_device."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    steps = batch[0].shape[0]
    half = steps // 2
    n_pops = len(net.layer_sizes) - 1
    want = n_pops + sum(2 if l.paradigm == "parallel" else 1 for l in rep.layers)
    launches, ops = {}, {}
    for route in (0, 1, 2):
        full = launch_pair(net, rep, batch)[route]
        short = launch_pair(net, rep, batch, half)[route]
        n_full, n_short = (max(profiled_ms(fn)[1] for _ in range(3))
                           for fn in (full, short))
        ops[route] = (n_full - n_short) / (steps - half)
        launches[route] = n_full
    launch = launch_pair(net, rep, batch)[0]
    reset_launch_counts()
    launch()
    counts = launch_counts()
    waits = sync_count(launch)
    require(counts["lif_step"] == steps * n_pops and counts["lif_update"] == 0,
            f"serve {name}: {counts['lif_step']} lif_step launches for {steps} "
            f"steps of {n_pops} populations")
    require(ops[0] == want, f"serve {name}: {ops[0]} device operations a step, "
            f"want {want}")
    require(ops[2] == want, f"serve {name}: run_batched takes {ops[2]} device "
            f"operations a step, want {want}")
    require(waits == 0, f"serve {name}: run_device waits for the card {waits} times")
    require(launches[0] < launches[1],
            f"serve {name}: {launches[0]} device launches a launch, old route "
            f"{launches[1]}")
    print(f"serve: {name:10s} device operations a step {ops[0]:g} (projections "
          f"{want - n_pops}, lif_step {n_pops}), run_batched {ops[2]:g}, old "
          f"route {ops[1]:g}; device "
          f"launches a run_device launch of {steps} steps {launches[0]} (constant "
          f"{launches[0] - ops[0] * steps:g}), old route {launches[1]}; lif_step "
          f"launches {counts['lif_step']}, "
          f"lif_update {counts['lif_update']}, host waits {waits}")


def time_serving(net, name, rep, batch, card):
    """One served micro-batch through run_device with the population step
    beside the route it replaced, in the same run: host time per launch
    (ends in a sync; in turns new, old, old, new), the same launch's device
    time (captured once as a CUDA graph and replayed, so no host time is in
    it), and the device kernels that make it up."""
    launch, launch_old, _ = launch_pair(net, rep, batch)
    x, vs = batch
    require(same_replies(launch(), launch_old()),
            f"serve {name}: the population step and the old route differ")
    dt, (dt_a, dt_b), do, (do_a, do_b) = in_turns(launch, launch_old)
    # device time in turns too, new, old, old, new
    devs = [device_ms(fn, iters=1, replays=20)
            for fn in (launch, launch_old, launch_old, launch)]
    dev, dev_old = (devs[0] + devs[3]) / 2, (devs[1] + devs[2]) / 2
    steps = x.shape[0]
    print(f"serve timing [{card}]: {name} micro-batch of {len(vs)} "
          f"({steps} steps): population step {dt:.3f} ms per launch ({dt_a:.3f}, "
          f"{dt_b:.3f}), {dt / steps * 1e3:.1f} us per step, "
          f"{int(vs.sum()) / dt * 1e3:,.0f} request-steps/s, device "
          f"{dev:.3f} ms ({devs[0]:.3f}, {devs[3]:.3f}), busy share {dev / dt:.3f}; "
          f"old route {do:.3f} ms ({do_a:.3f}, {do_b:.3f}), {do / steps * 1e3:.1f} "
          f"us per step, device {dev_old:.3f} ms ({devs[1]:.3f}, {devs[2]:.3f}), "
          f"busy share {dev_old / do:.3f}; host time "
          f"{100 * (dt / do - 1):+.1f}%")
    total, n, top = profiled_ms(launch)
    total_o, n_o, _ = profiled_ms(launch_old)
    print(f"serve profile [{card}]: {name}: device {total:.3f} ms in {n} "
          f"launches (old route {total_o:.3f} ms in {n_o}); top: {top}")


# -- 8. the cerebellum scaffold ------------------------------------------------------
#: benchmarks/bench_scaffold.py's full sizes and seed, not cut; the traffic:
#: 64 steps at the spec's rates (mossy 0.08, climbing 0.02), seed 7
SCAFFOLD_SIZES, SCAFFOLD_SEED = (10_000, 100_000), 2024
SCAFFOLD_STEPS, SCAFFOLD_STIM_SEED = 64, 7
#: a micro-batch of 8 with full, cut and empty lanes
SCAFFOLD_VALID = (64, 40, 0, 64, 17, 64, 64, 1)
#: run_graph_reference holds whole trains up to 10k neurons; above, lanes 0
#: and 1 over their first 16 steps (the whole micro-batch would take minutes
#: of host time)
ORACLE_WHOLE, ORACLE_LANES, ORACLE_STEPS = 10_000, 2, 16
#: the compile the JAX package gives at seed 2024: each parallel edge's WDM
#: (M, K) and each serial edge's ELL (R, L) at batch 8 (every serial edge
#: runs the sparse form at batch 8 and the event form at batch 1)
SCAFFOLD_SHAPES = {
    10_000: {
        "wdm": {"mossy->granule": (8000, 650), "granule->golgi": (200, 7404),
                "golgi->granule": (8000, 200), "granule->purkinje": (250, 7911),
                "granule->basket_stellate": (800, 8000)},
        "ell": {"mossy->golgi": (600, 22), "basket_stellate->purkinje": (750, 20),
                "climbing->purkinje": (500, 5)},
    },
    100_000: {
        "wdm": {"mossy->golgi": (2000, 6489), "climbing->purkinje": (2500, 917)},
        "ell": {"mossy->granule": (240_000, 11), "granule->golgi": (8000, 57),
                "golgi->granule": (240_000, 10), "granule->purkinje": (12_500, 62),
                "granule->basket_stellate": (32_000, 62),
                "basket_stellate->purkinje": (7500, 25)},
    },
}
#: the engine's traffic at 100k: 16 requests of 32-64 steps, micro-batch 8
SCAFFOLD_ENGINE = dict(n_requests=16, lo=32, hi=64, seed=11)
CARD = "cuda"


def timed_compile(sc):
    """compile_scaffold and its seconds (run in a worker process)."""
    from repro_torch.scaffold import compile_scaffold

    t0 = time.perf_counter()
    return compile_scaffold(sc), time.perf_counter() - t0


def scaffold_compile(n, sc, t_build, compiled):
    """The report ``compiled`` brings (compile_scaffold in a worker); the
    card's executable; the paradigms, forms and operand shapes held to the
    JAX package's compile."""
    from repro_torch.core.runtime import network_executable

    rep, t_compile = compiled.result()
    net = sc.network
    exe = network_executable(net, rep, device=CARD)
    f1, f8 = exe.serial_forms(1), exe.serial_forms(MICRO_BATCH)
    names = [e.name for e in net.projections]
    wdm = {names[i]: tuple(exe.params[i][0].shape)
           for i, m in enumerate(exe.metas) if m.paradigm == "parallel"}
    ell = {names[i]: tuple(exe._sparse_param(i)[0].shape)
           for i, f in enumerate(f8) if f == "sparse"}
    serial = [m.paradigm == "serial" for m in exe.metas]
    require(wdm == SCAFFOLD_SHAPES[n]["wdm"] and ell == SCAFFOLD_SHAPES[n]["ell"],
            f"scaffold {n}: WDM {wdm}, ELL {ell}; the reference's compile gives "
            f"{SCAFFOLD_SHAPES[n]}")
    require(all((f == "event") == s for f, s in zip(f1, serial))
            and all((f == "sparse") == s for f, s in zip(f8, serial)),
            f"scaffold {n}: forms {f1} at batch 1, {f8} at batch 8")
    print(f"scaffold {n}: {sc.total_neurons} neurons {sc.sizes}, "
          f"{sc.total_synapses} synapses; build {t_build:.1f} s, compile "
          f"{t_compile:.1f} s on the host (in a worker); paradigms "
          f"{dict(zip(names, (l.paradigm for l in rep.layers)))}; forms at batch "
          f"1 {f1}, at batch 8 {f8}; WDM (M, K) {wdm}; ELL (R, L) {ell}")
    return rep, exe, {"build_s": t_build, "compile_s": t_compile,
                          "synapses": sc.total_synapses,
                          "paradigms": [l.paradigm for l in rep.layers],
                          "forms_b1": list(f1), "forms_b8": list(f8)}


def scaffold_want(exe, forms, steps, temporal=False):
    """Kernel launches a launch implies: per step one lif_step a population,
    the fused K2 a parallel edge, K3 a sparse edge; on the temporal path the
    step-serial block's alone per step, plus one K3 a whole-train sparse
    projection and one fused K4 an iterative population."""
    want = {k: 0 for k in REPLACES}
    plan = exe.plan
    pops = plan.update_order
    if temporal:
        tp = exe._temporal_structure()
        pops = tp.block
        want["lif_fixed_point"] = list(tp.modes.values()).count("iterative")
        want["sparse_gather"] = forms.count("temporal_sparse")
    block = set(pops)
    edges = [f for i, f in enumerate(forms) if plan.proj_tgt[i] in block]
    want["lif_step"] = steps * len(pops)
    want["spike_wdm_project"] = steps * edges.count("-")
    want["sparse_gather"] += steps * edges.count("sparse")
    return want


def temporal_refused(exe):
    """The parallel projections onto whole-train populations whose dense
    (d_slots, S, T) operand passes the element cap: the reference's
    run_temporal refuses the graph when there is one."""
    tp = exe._temporal_structure()
    block = set(tp.block)
    return {i: (m.delay_range + 1) * m.n_source * m.n_target
            for i, m in enumerate(exe.metas)
            if m.paradigm == "parallel" and exe.plan.proj_tgt[i] not in block
            and not exe.cost_model.dense_fits(m.n_source, m.n_target,
                                              m.delay_range)}


def scaffold_serve(n, sc, rep, exe, x1, x8, vs):
    """Every path on the card, its kernel launches counted around it alone
    and held to what the launch implies: run_device at batch 1 (the event
    form) and 8, run_batched, shard() then run_device, run_device with
    valid_steps, and run_temporal (refused at 10k, as by the reference: a
    whole-train parallel operand there passes the dense cap).  Returns the
    replies as host arrays and the launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    paths = {
        "run_device_b1": (lambda: exe.run_device(x1), 1, False),
        "run_device": (lambda: exe.run_device(x8), MICRO_BATCH, False),
        "run_batched": (lambda: exe.run_batched(x8), MICRO_BATCH, False),
        "shard_run_device": (lambda: exe.shard().run_device(x8), MICRO_BATCH, False),
        "valid_steps": (lambda: exe.run_device(x8, valid_steps=vs), MICRO_BATCH,
                        False),
        "run_temporal": (lambda: exe.run_temporal(x8), MICRO_BATCH, True),
    }
    served, counts = {}, {}
    for name, (launch, batch, temporal) in paths.items():
        if temporal:
            try:
                forms = exe.temporal_forms(batch, SCAFFOLD_STEPS)
            except ValueError as err:
                too_large = temporal_refused(exe)
                require(bool(too_large) and "dense operand" in str(err),
                        f"scaffold {n}: run_temporal refused: {err}")
                print(f"scaffold {n}: run_temporal refused as the reference "
                      f"refuses it ({err}): whole-train parallel operands "
                      f"{too_large} pass the {exe.cost_model.dense_element_cap}-"
                      "element cap")
                continue
        else:
            forms = exe.serial_forms(batch)
        reset_launch_counts()
        outs = launch()
        c = launch_counts()
        require(bool(exe.last_check), f"scaffold {n} {name}: last_check is False")
        want = scaffold_want(exe, forms, SCAFFOLD_STEPS, temporal)
        got = {k: c[k] for k in want}
        require(got == want, f"scaffold {n} {name}: launches {got}, the launch "
                f"implies {want}")
        served[name] = [z.cpu().numpy() for z in outs]
        counts[name] = got
        if temporal:
            served["temporal_record"] = rep.temporal[(batch, SCAFFOLD_STEPS)]
    ref = served["run_device"]
    for name in ("run_batched", "shard_run_device", "run_temporal"):
        if name in served:
            require(all(np.array_equal(a, b) for a, b in zip(served[name], ref)),
                    f"scaffold {n}: {name} differs from run_device")
    for z, r in zip(served["valid_steps"], ref):
        for b, v in enumerate(vs):
            require(np.array_equal(z[:v, b], r[:v, b]) and not z[v:, b].any(),
                    f"scaffold {n}: valid_steps lane {b} is not run_device's "
                    f"first {v} steps and zeros")
    require(sum(float(z.sum()) for z in ref) > 0, f"scaffold {n}: silent")
    print(f"scaffold {n}: launches by path {counts}, each as its steps and "
          "forms imply; run_batched, shard() + run_device and run_temporal "
          "bitwise equal to run_device, valid_steps lanes its prefixes and zeros")
    return served, counts


def scaffold_hold_cpu(n, net, rep, x1, x8, vs, served):
    """Every path's replies against the port on the CPU (the kernels' plain
    versions), every lane; run_temporal's passes and residuals too."""
    from repro_torch.core.runtime import NetworkExecutable

    t0 = time.perf_counter()
    cpu = NetworkExecutable.build(net, rep, device="cpu")
    runs = {"run_device_b1": lambda: cpu.run(x1),
            "run_device": lambda: cpu.run(x8),
            "run_batched": lambda: cpu.run(x8, batched=True),
            "shard_run_device": lambda: cpu.shard().run(x8),
            "valid_steps": lambda: cpu.run(x8, valid_steps=vs),
            "run_temporal": lambda: cpu.run(x8, temporal=True)}
    for name, run in runs.items():
        if name not in served:
            continue
        for z, c in zip(served[name], run()):
            require(np.array_equal(z, c), f"scaffold {n} {name}: card and CPU differ")
    rec = served.get("temporal_record")
    if rec is not None:
        cpu_rec = rep.temporal[(MICRO_BATCH, SCAFFOLD_STEPS)]
        require(rec == cpu_rec and all(r == 0 for r in rec.residual.values()),
                f"scaffold {n}: temporal record {rec}, CPU {cpu_rec}")
    secs = time.perf_counter() - t0
    print(f"scaffold {n}: every path bit-identical to the port on the CPU, every "
          f"lane ({secs:.1f} s of CPU)"
          + (f"; run_temporal split {rec.split}, modes {rec.modes}, passes "
             f"{rec.iterations}, residual {rec.residual}, equal to the CPU's"
             if rec is not None else ""))
    return secs


def timed_oracle(net, x):
    """run_graph_reference and its seconds (run in the oracle's worker)."""
    from repro_torch.core.runtime import run_graph_reference

    t0 = time.perf_counter()
    return run_graph_reference(net, x), time.perf_counter() - t0


def scaffold_oracle(pool, n, net, x1, x8):
    """Start run_graph_reference in a worker process: whole trains up to
    10k neurons; above, lanes 0 and 1 over their first 16 steps.  One call
    takes the batch-8 lanes and the batch-1 train as one more lane: the
    oracle's cost is its dense weights (~25 GB at 100k), whatever the
    batch.  Returns the future and the (lanes, steps) it covers."""
    lanes, steps = ((MICRO_BATCH, SCAFFOLD_STEPS) if n <= ORACLE_WHOLE
                    else (ORACLE_LANES, ORACLE_STEPS))
    x = np.concatenate([x8[:steps, :lanes], x1[:steps]], axis=1)
    return pool.submit(timed_oracle, net, x), (lanes, steps)


def scaffold_hold_oracle(n, oracle, vs, served):
    """Every path against run_graph_reference over the oracle's lanes and
    steps (the batch-1 train is its last lane); valid_steps lanes against
    its prefixes and zeros."""
    future, (lanes, steps) = oracle
    both, secs = future.result()
    want8, want1 = [o[:, :lanes] for o in both], [o[:, lanes:] for o in both]
    for name, outs in served.items():
        if name == "temporal_record":
            continue
        want = want1 if name == "run_device_b1" else want8
        for z, o in zip(outs, want):
            z = z[:steps, :lanes]
            if name == "valid_steps":
                live = np.asarray(vs[:lanes])[None, :, None] > np.arange(steps)[:, None, None]
                o = o * live
            require(np.array_equal(z, o),
                    f"scaffold {n} {name}: differs from run_graph_reference")
    print(f"scaffold {n}: every path bit-identical to run_graph_reference over "
          f"lanes 0..{lanes - 1} and steps 0..{steps - 1} (the oracle took "
          f"{secs:.1f} s of host time in a worker process, beside the card's "
          "work)")
    return secs, (lanes, steps)


def scaffold_profile(n, sc, rep, x8):
    """profile_run on the card against profile_run on the CPU, same train;
    the rates beside BENCH_network.json's (the JAX package on the CPU, 10
    steps at batch 1)."""
    from repro_torch.core.runtime import profile_run

    _, on_cpu = profile_run(sc.network, rep, x8, device="cpu")
    outs, prof = profile_run(sc.network, rep, x8, device=CARD)
    require(rep.activity is prof, "profile_run did not attach its profile")
    require(prof.as_dict() == on_cpu.as_dict(),
            f"scaffold {n}: the card's profile {prof.as_dict()} differs from "
            f"the CPU's {on_cpu.as_dict()}")
    rates = prof.rates()
    bench = json.loads((SRC.parent / "BENCH_network.json").read_text())
    jax_cpu = bench["scaffold_scale"]["sizes"].get(str(n), {})
    t, c = prof.peak("granule")
    print(f"scaffold {n}: profile_run on the card equals the CPU's; rates "
          f"{ {k: round(v, 5) for k, v in rates.items()} }, granule peak "
          f"{c} spikes at t {t} (batch 8, 64 steps); the JAX package on the CPU "
          f"(BENCH_network.json, batch 1, 10 steps): rates "
          f"{jax_cpu.get('rates')}, granule peak {jax_cpu.get('peak_granule')}")
    return {"rates": rates, "peak_granule": {"t": t, "count": c},
            "jax_cpu_rates": jax_cpu.get("rates")}


#: device operations of one event-form update (serial_runtime.serial_update):
#: the index cast, the gather, the product, the slot's add and floor-mod,
#: the segment's product and add, the batch-offset arange and its product
#: and add, the zero fill and index_add_
EVENT_OPS = 12
#: device operations of a projection's step by form: the fused K2 and the
#: ring write a parallel edge, K3 a sparse edge, PyTorch's own operations an
#: event-form update
FORM_OPS = {"-": 2, "sparse": 1, "event": EVENT_OPS}


def profiled_counts(launch):
    """Device operations of one launch by kernel name, each the largest of
    three profiles (the profiler can drop activity records, never add)."""
    from torch.profiler import ProfilerActivity, profile

    best = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            launch()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.self_cpu_time_total == 0 and e.self_device_time_total > 0:
                best[e.key] = max(best.get(e.key, 0), e.count)
    return best


def ops_a_step(launch, steps, half):
    """Device operations a step: each kernel's count at ``steps`` less its
    count at ``half`` steps, over the steps between.  A kernel that runs
    every step differs by at least that many; one that differs by fewer
    runs once a launch a number of times that depends on the train's size
    (a large reduction's extra pass in the output check), so it is no
    step's and is returned apart, with its difference."""
    full, short = profiled_counts(lambda: launch(steps)), profiled_counts(
        lambda: launch(half))
    per_step, varying = 0.0, {}
    for key in set(full) | set(short):
        diff = full.get(key, 0) - short.get(key, 0)
        if abs(diff) >= steps - half:
            per_step += diff / (steps - half)
        elif diff:
            varying[key[:60]] = diff
    return per_step, varying


def scaffold_time(n, exe, x1, x8, vs, card):
    """For each path: host ms a launch (ends in a sync), device ms a launch
    (graph replay; the profiler for run_temporal, whose launch reads the
    passes back), µs a step, busy share and host waits; for run_device and
    run_batched the device operations a step from the profiler at two train
    lengths (each the largest of three profiles), held to the projections'
    operations plus one lif_step a population, with no host wait."""
    xs1, xs8 = (torch.as_tensor(x, device=CARD) for x in (x1, x8))
    vs_t = torch.as_tensor(vs, device=CARD)
    steps, half = SCAFFOLD_STEPS, SCAFFOLD_STEPS // 2
    paths = {
        "run_device_b1": (xs1, lambda k=steps: exe.run_device(xs1[:k])),
        "run_device": (xs8, lambda k=steps: exe.run_device(xs8[:k])),
        "run_batched": (xs8, lambda k=steps: exe.run_batched(xs8[:k])),
        "valid_steps": (xs8, lambda k=steps: exe.run_device(xs8, valid_steps=vs_t)),
    }
    if not temporal_refused(exe):
        paths["run_temporal"] = (xs8, lambda k=steps: exe.run_temporal(xs8))
    n_pops = len(exe.plan.update_order)
    rows = {}
    for name, (xs, launch) in paths.items():
        host = host_ms(launch, reps=5)
        waits = sync_count(launch)
        if name == "run_temporal":
            dev, n_dev, top = profiled_ms(launch)
        else:
            dev = device_ms(launch, iters=1, replays=5)
            _, n_dev, top = profiled_ms(launch)
        row = {"host_ms": host, "device_ms": dev, "us_per_step": host / steps * 1e3,
               "busy": dev / host, "host_waits": waits, "device_launches": n_dev}
        extra = ""
        if name in ("run_device_b1", "run_device", "run_batched"):
            ops, varying = ops_a_step(launch, steps, half)
            by_edge = [FORM_OPS[f] for f in exe.serial_forms(xs.shape[1])]
            want = sum(by_edge) + n_pops
            require(ops == want and waits == 0,
                    f"scaffold {n} {name}: {ops} device operations a step and "
                    f"{waits} host waits; want {want} (edges {by_edge}, lif_step "
                    f"{n_pops}) and none")
            row.update(ops_per_step=ops, ops_by_edge=by_edge,
                       launch_ops_varying=varying)
            extra = (f", device operations a step {ops:g} (edges {by_edge}, "
                     f"lif_step {n_pops})"
                     + (f"; per-launch operations that vary with the train's "
                        f"length: {varying}" if varying else ""))
        rows[name] = row
        print(f"scaffold timing [{card}]: {n} {name}: host {host:.3f} ms a launch "
              f"({row['us_per_step']:.1f} us a step), device {dev:.3f} ms, busy "
              f"share {row['busy']:.3f}, host waits {waits}, device launches "
              f"{n_dev}{extra}; top: {top}")
    return rows


def kernel_time(kernel, plain, library, n_bytes, n_ops, ops_rate, iters=100,
                plain_reads_host=False):
    """Device ms a call (graph replay) of a kernel, its plain version and a
    library call, beside the bound; a plain version that reads the host is
    timed eagerly, its host waits included."""
    b, by = bound_ms(n_bytes, n_ops, ops_rate)
    return {"ms": device_ms(kernel, iters=iters),
            "plain_ms": (eager_ms(plain, iters=3, warmup=1) if plain_reads_host
                         else device_ms(plain, iters=max(1, iters // 5))),
            "library_ms": None if library is None else device_ms(library, iters=iters),
            "bound_ms": b, "bound_by": by}


def scaffold_kernels(n, exe, x8, card):
    """Every kernel at the shapes this size's paths give it, held to its
    plain version and timed beside its bound and a library call: the fused
    K2 a parallel edge (compiled operands, ring at batch 8; library
    torch._int_mm on the same product, zero-padded), K3 a sparse edge
    (compiled ELL, batch 8 through the step's transposed view; library
    torch.sparse.mm), K1's population step each population at batch 8,
    the fused K4 at run_temporal's (T, B.N) trains, and the event form's
    update and its index_add_ at batch 1."""
    from repro_torch.core.runtime.serial_runtime import serial_update
    from repro_torch.kernels.lif_parallel_scan import (
        lif_fixed_point, lif_fixed_point_launch, lif_fixed_point_ref,
    )
    from repro_torch.kernels.lif_update import lif_step, lif_step_ref
    from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
    from repro_torch.kernels.spike_wdm_matmul import (
        spike_wdm_project, spike_wdm_project_ref,
    )

    plan, rows = exe.plan, []
    gen = torch.Generator(device=CARD).manual_seed(n)

    def spikes(shape, p=0.1):
        return (torch.rand(shape, generator=gen, device=CARD) < p)

    def gather_time(val, idx, x, **kw):
        # library: the same ELL as one CSR sparse x dense product on the
        # spikes made contiguous (its best case); bytes: the ELL read once,
        # of x only the rows the ELL indexes, the output written once
        r, lanes = val.shape
        nz = val != 0
        rows_i = torch.arange(r, device=CARD)[:, None].expand(r, lanes)[nz]
        csr = torch.sparse_coo_tensor(
            torch.stack([rows_i, idx[nz].long()]), val[nz], (r, x.shape[0])
        ).coalesce().to_sparse_csr()
        xc, cols = x.contiguous(), x.shape[1]
        n_bytes = (8 * r * lanes + 4 * int(torch.unique(idx).numel()) * cols
                   + 4 * r * cols)
        return kernel_time(lambda: sparse_gather(val, idx, x),
                           lambda: sparse_gather_ref(val, idx, x),
                           lambda: torch.sparse.mm(csr, xc),
                           n_bytes, 2 * int(nz.sum()) * cols, F32_OPS_S, **kw)

    def row(kernel, edge, shape, t, err):
        t.update(name=kernel, size=n, edge=edge, shape=shape, max_abs_err=err)
        rows.append(t)
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.5f}"
        print(f"scaffold kernel [{card}]: {n} {kernel} {edge} {shape}: "
              f"{t['ms']:.5f} ms (plain {t['plain_ms']:.5f}, library {lib}; "
              f"bound {t['bound_ms']:.6f} ms by {t['bound_by']}, kernel at "
              f"{t['bound_ms'] / t['ms']:.3f} of it), max |diff| {err}")

    forms = exe.serial_forms(MICRO_BATCH)
    for i, (meta, form) in enumerate(zip(exe.metas, forms)):
        edge = exe.report.layers[i].layer_name
        if form == "-":
            wdm, src, dly = exe.params[i]
            m, k = wdm.shape
            depth = meta.ring_depth
            ring = spikes((MICRO_BATCH, depth, meta.n_source)).to(torch.int8)
            err = 0.0
            for t in range(2 * depth + 1):
                out = spike_wdm_project(wdm, src, dly, ring, t)
                ref = spike_wdm_project_ref(wdm, src, dly, ring, t)
                require(torch.equal(out, ref), f"scaffold {n}: spike_wdm_project "
                        f"differs on {edge}")
                err = max(err, max_abs_diff(out, ref))
            t_step = depth + 1
            addr = ((t_step - dly.long()) % depth) * meta.n_source + src.long()
            stacked = ring.reshape(MICRO_BATCH, -1)[:, addr]          # (B, K)
            mp, kp = max(m, 17), -(-k // 8) * 8
            ap = torch.zeros((mp, kp), dtype=torch.int8, device=CARD)
            xp = torch.zeros((kp, 8), dtype=torch.int8, device=CARD)
            ap[:m, :k], xp[:k, :MICRO_BATCH] = wdm, stacked.T
            n_bytes = (m * k + 8 * k + MICRO_BATCH * int(torch.unique(addr).numel())
                       + 4 * MICRO_BATCH * m)
            t = kernel_time(
                lambda: spike_wdm_project(wdm, src, dly, ring, t_step),
                lambda: spike_wdm_project_ref(wdm, src, dly, ring, t_step),
                lambda: torch._int_mm(ap, xp),
                n_bytes, 2 * m * k * MICRO_BATCH, INT8_OPS_S,
            )
            row("spike_wdm_project", edge, [m, k, MICRO_BATCH, depth], t, err)
        elif form == "sparse":
            val, idx = exe._sparse_param(i)
            r, lanes = val.shape
            x = spikes((MICRO_BATCH, meta.n_source)).float().t()
            out, ref = sparse_gather(val, idx, x), sparse_gather_ref(val, idx, x)
            require(torch.equal(out, ref), f"scaffold {n}: sparse_gather differs "
                    f"on {edge}")
            t = gather_time(val, idx, x)
            row("sparse_gather", edge, [r, lanes, meta.n_source, MICRO_BATCH], t,
                max_abs_diff(out, ref))
    for p in plan.update_order:
        edges = plan.in_edges[p]
        kinds = tuple("current" if forms[i] == "-" else forms[i] for i in edges)
        d_slots = max([exe.metas[i].delay_range + 1 for i in edges
                       if forms[i] != "-"], default=2)
        size = plan.pop_sizes[p]
        ops = step_inputs(kinds, MICRO_BATCH, size, d_slots, 5, p, 0.5)
        want = clone_step(ops)
        lif_step(*ops[:4], 5, alpha=0.5, v_th=ops[4])
        lif_step_ref(*want[:4], 5, alpha=0.5, v_th=want[4])
        err = step_diff(ops, want)
        require(err == 0.0, f"scaffold {n}: lif_step differs at population {p}")
        plain = clone_step(ops)
        rings = [e.ring.shape[0] for e in ops[0] if hasattr(e, "ring")]
        per = 4 * (len(kinds) - len(rings)) + 12 * sum(rings) + 14
        flops = sum(rings) + len(kinds) - 1 + 5
        t = kernel_time(lambda: lif_step(*ops[:4], 5, alpha=0.5, v_th=ops[4]),
                        lambda: lif_step_ref(*plain[:4], 5, alpha=0.5, v_th=ops[4]),
                        None, per * MICRO_BATCH * size, flops * MICRO_BATCH * size,
                        F32_OPS_S)
        row("lif_step", f"population {p}", [list(kinds), MICRO_BATCH, size, d_slots],
            t, err)
    if not temporal_refused(exe):
        for i_flat, kw in path_fixed_points(exe, x8, None):
            z, iters, res = lif_fixed_point(i_flat, **kw)
            zr, iters_r, res_r = lif_fixed_point_ref(i_flat, **kw)
            require(torch.equal(z, zr) and (iters, res) == (iters_r, res_r),
                    f"scaffold {n}: lif_fixed_point differs at {tuple(i_flat.shape)}")
            steps, feat = i_flat.shape
            passes = int(column_passes(i_flat, **kw).sum())
            t = kernel_time(lambda: lif_fixed_point_launch(i_flat, **kw),
                            lambda: lif_fixed_point_ref(i_flat, **kw), None,
                            8 * steps * feat, 4 * steps * passes, F32_OPS_S, iters=10,
                            plain_reads_host=True)
            row("lif_fixed_point", f"{iters} passes", [steps, feat], t, 0.0)
        # K3 over run_temporal's T.B columns, read through the strided view
        # of the (T, B, S) train, beside a source-major copy then the gather
        cols = SCAFFOLD_STEPS * MICRO_BATCH
        for i, form in enumerate(exe.temporal_forms(MICRO_BATCH, SCAFFOLD_STEPS)):
            if form != "temporal_sparse":
                continue
            val, idx = exe._sparse_param(i)
            n_src = exe.metas[i].n_source
            view = spikes((SCAFFOLD_STEPS, MICRO_BATCH, n_src)).float().permute(
                2, 0, 1).reshape(n_src, cols)
            out, ref = sparse_gather(val, idx, view), sparse_gather_ref(val, idx, view)
            require(torch.equal(out, ref), f"scaffold {n}: sparse_gather differs "
                    f"over the temporal columns")
            err = max_abs_diff(out, ref)
            del ref                      # the plain version's (R, L, T.B) gather
            t = gather_time(val, idx, view, iters=10, plain_reads_host=True)
            t["copy_then_gather_ms"] = device_ms(
                lambda: sparse_gather(val, idx, view.contiguous()), iters=10)
            row("sparse_gather", exe.report.layers[i].layer_name + " (temporal)",
                [*val.shape, n_src, cols], t, err)
            print(f"scaffold kernel [{card}]: {n} sparse_gather over the temporal "
                  f"columns: a source-major copy then the gather "
                  f"{t['copy_then_gather_ms']:.5f} ms against {t['ms']:.5f} ms "
                  "from the strided view")
    event = []
    for i, form in enumerate(exe.serial_forms(1)):
        if form != "event":
            continue
        meta = exe.metas[i]
        x_t = spikes((1, meta.n_source)).float()
        w, d, s, tg = exe.params[i]
        upd = functools.partial(serial_update, w, d, s, tg, x_t, 3,
                                delay_range=meta.delay_range, n_target=meta.n_target)
        seg = (((d + 3) % (meta.delay_range + 1)) * meta.n_target + tg).long()
        contrib = x_t[:, s.long()].reshape(-1) * w
        buf = torch.zeros((meta.delay_range + 1) * meta.n_target, device=CARD)
        ms_upd = device_ms(upd)
        ms_add = device_ms(functools.partial(buf.index_add_, 0, seg, contrib))
        edge = exe.report.layers[i].layer_name
        event.append({"size": n, "edge": edge, "rows": int(w.numel()),
                      "update_ms": ms_upd, "index_add_ms": ms_add})
        print(f"scaffold kernel [{card}]: {n} event form {edge} at batch 1 "
              f"({int(w.numel())} synapse rows): update {ms_upd:.5f} ms, its "
              f"index_add_ {ms_add:.5f} ms")
    return rows, event


def scaffold_engine(sc, rep, exe, card):
    """ServingEngine over the 100k report: 16 concatenated two-input
    payloads of 32-64 steps from the spec-rate stimulus, micro-batch 8,
    warmed before they come in.  Every reply must equal the request's solo
    run_device on the card; no re-lowering, miss or supervisor fault; the
    kernels launched as the launches' steps imply; a payload of the wrong
    width refused."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import FailedReply, ServingEngine

    cfg = SCAFFOLD_ENGINE
    net = sc.network
    rng = np.random.default_rng(cfg["seed"])
    lengths = rng.integers(cfg["lo"], cfg["hi"] + 1, cfg["n_requests"])
    pool = sc.stimulus(cfg["hi"], cfg["n_requests"], seed=cfg["seed"])
    reqs = [np.ascontiguousarray(pool[:k, i]) for i, k in enumerate(lengths)]
    t0 = time.perf_counter()
    engine = ServingEngine(net, rep, micro_batch=MICRO_BATCH, min_bucket_steps=8)
    warmed = engine.warmup(list(range(cfg["lo"], cfg["hi"] + 1)))
    t_warm = time.perf_counter() - t0
    launched = []
    run = engine.pool.run_microbatch

    def recorded(mb, name=None, **kw):
        launched.append(mb.key.steps)
        return run(mb, name, **kw)

    engine.pool.run_microbatch = recorded
    reset_launch_counts()
    t0 = time.perf_counter()
    rids = [engine.submit(r) for r in reqs]
    replies = engine.drain()
    t_serve = time.perf_counter() - t0
    counts = launch_counts()
    st = engine.stats()
    sup = st["supervisor"]
    require(st["relowerings"] == 0 and st["bucket_misses"] == 0,
            f"scaffold engine: {st['relowerings']} re-lowerings, "
            f"{st['bucket_misses']} misses after warmup")
    for k in ("retries", "degraded_launches", "validation_failures",
              "quarantined", "watchdog_stalls", "bisections"):
        require(sup[k] == 0, f"scaffold engine: supervisor counted {sup[k]} {k}")
    require(st["failed"] == 0 and st["shed"] == 0,
            f"scaffold engine: {st['failed']} failed, {st['shed']} shed")
    forms = exe.serial_forms(MICRO_BATCH)
    want = {"lif_step": 0, "spike_wdm_project": 0, "sparse_gather": 0}
    for steps in launched:
        want["lif_step"] += steps * len(exe.plan.update_order)
        want["spike_wdm_project"] += steps * forms.count("-")
        want["sparse_gather"] += steps * forms.count("sparse")
    require({k: counts[k] for k in want} == want,
            f"scaffold engine: launches {counts}, the {len(launched)} launches "
            f"imply {want}")
    for rid, r in zip(rids, reqs):
        reply = replies[rid]
        require(not isinstance(reply, FailedReply), f"scaffold engine: {rid} failed")
        solo = exe.run(r[:, None, :])
        for z, s in zip(reply, solo):
            require(np.array_equal(z, s[:, 0]),
                    f"scaffold engine: reply {rid} differs from its solo run")
    try:
        engine.submit(np.zeros((4, net.n_input + 3), np.float32))
    except ValueError:
        pass
    else:
        raise SmokeFailure("scaffold engine: a payload of the wrong width was taken")
    by = st["by_model"]
    out = {"requests": len(reqs), "launches": len(launched),
           "batched": sum(c["batched_launches"] for c in by.values()),
           "fused": sum(c["fused_launches"] for c in by.values()),
           "hits": st["bucket_hits"], "misses": st["bucket_misses"],
           "relowerings": st["relowerings"], "faults": 0,
           "warmup_s": t_warm, "serve_s": t_serve, "kernel_launches": want}
    print(f"scaffold engine [{card}]: {len(reqs)} two-input payloads (steps "
          f"{sorted(int(k) for k in lengths)}, width {net.n_input}) served in "
          f"{t_serve:.3f} s by {len(launched)} launches (batched {out['batched']}, "
          f"fused {out['fused']}) after {warmed} bucket shapes warmed in "
          f"{t_warm:.1f} s; every reply bit-identical to its solo run_device on "
          f"the card; hits {st['bucket_hits']}, misses {st['bucket_misses']}, "
          f"re-lowerings {st['relowerings']}, supervisor faults 0; kernel "
          f"launches {want} as the launches' steps imply; a payload of width "
          f"{net.n_input + 3} refused")
    return out, counts


def scaffold_phase(card):
    """Phase 8: the cerebellum scaffold at 10k and 100k neurons through
    every path, the profiler (10k) and the engine (100k), held to the port
    on the CPU and to run_graph_reference; then timed.  Returns the launch
    counts of its paths and the ``scaffold`` JSON object."""
    from repro_torch.scaffold import build_cerebellum

    t_phase = time.perf_counter()
    total = {k: 0 for k in REPLACES}
    out = {"card": card, "sizes": {}, "kernels": [], "event": []}
    built = {}
    for n in SCAFFOLD_SIZES:
        t0 = time.perf_counter()
        sc = build_cerebellum(n, seed=SCAFFOLD_SEED)
        built[n] = (sc, time.perf_counter() - t0,
                    sc.stimulus(SCAFFOLD_STEPS, 1, seed=SCAFFOLD_STIM_SEED),
                    sc.stimulus(SCAFFOLD_STEPS, MICRO_BATCH, seed=SCAFFOLD_STIM_SEED))
    # the compiles and the oracles (minutes of host time at 100k) run in
    # worker processes beside the card's work
    with ProcessPoolExecutor(3, mp_context=get_context("spawn")) as pool:
        compiles = {n: pool.submit(timed_compile, built[n][0])
                    for n in SCAFFOLD_SIZES}
        oracles = {n: scaffold_oracle(pool, n, b[0].network, b[2], b[3])
                   for n, b in built.items()}
        for n in SCAFFOLD_SIZES:
            scaffold_size(n, built.pop(n), compiles.pop(n), oracles.pop(n),
                          card, total, out)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"scaffold: phase took {out['seconds']:.1f} s")
    return total, out


def scaffold_size(n, built, compiled, oracle, card, total, out):
    """One size of phase 8; its launch counts add into ``total`` and its
    numbers into ``out``."""
    from repro_torch.core.runtime import release_network_executable

    t_size = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sc, t_build, x1, x8 = built
    rep, exe, info = scaffold_compile(n, sc, t_build, compiled)
    vs = np.asarray(SCAFFOLD_VALID, np.int32)
    served, counts = scaffold_serve(n, sc, rep, exe, x1, x8, vs)
    for c in counts.values():
        for k, v in c.items():
            total[k] += v
    info["launches"] = counts
    info["paths"] = scaffold_time(n, exe, x1, x8, vs, card)
    rows, event = scaffold_kernels(n, exe, x8, card)
    out["kernels"] += rows
    out["event"] += event
    info["cpu_s"] = scaffold_hold_cpu(n, sc.network, rep, x1, x8, vs, served)
    info["oracle_s"], info["oracle_lanes_steps"] = scaffold_hold_oracle(
        n, oracle, vs, served)
    if n == min(SCAFFOLD_SIZES):
        info["profile"] = scaffold_profile(n, sc, rep, x8)
    if n == max(SCAFFOLD_SIZES):
        out["engine"], e_counts = scaffold_engine(sc, rep, exe, card)
        for k in ("lif_step", "spike_wdm_project", "sparse_gather"):
            total[k] += e_counts[k]
    info["max_memory_bytes"] = torch.cuda.max_memory_allocated()
    info["seconds"] = time.perf_counter() - t_size
    print(f"scaffold {n}: peak device memory "
          f"{info['max_memory_bytes'] / 2**20:.1f} MiB; {info['seconds']:.1f} s "
          "after the build")
    out["sizes"][str(n)] = info
    release_network_executable(rep)
    torch.cuda.empty_cache()


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
def kernel_rows(path, err, counts, card, temporal_gather, temporal_steps,
                extra_fixed_points):
    """Times at the main path's largest shape of each kernel (the JSON
    rows), and at the reference benchmark's larger shapes and K3's
    temporal-path shape (printed only).

    ``ms``/``plain_ms``/``library_ms`` are device times from CUDA-graph
    replay; the eager per-call times (host enqueue included) are printed
    beside them."""
    from repro_torch.kernels.lif_parallel_scan import (
        lif_fixed_point, lif_fixed_point_launch, lif_fixed_point_ref,
        lif_parallel_scan, lif_parallel_scan_ref,
    )
    from repro_torch.kernels.lif_update import (
        RingEdge, empty_launch, lif_step, lif_step_ref, lif_update, lif_update_ref,
    )
    from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
    from repro_torch.kernels.spike_wdm_matmul import (
        spike_wdm_matmul, spike_wdm_matmul_ref, spike_wdm_project,
        spike_wdm_project_ref,
    )
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref

    # the card's floor for any launch: a kernel that does nothing, replayed
    # from a CUDA graph like every time below
    floor = device_ms(empty_launch)
    print(f"kernel timing [{card}]: launch floor (an empty kernel, "
          f"graph-replayed) {floor:.5f} ms")

    def timed(kernel, plain, library, n_bytes, n_ops, ops_rate, plain_iters=100,
              plain_reads_host=False):
        # a plain version that reads the host cannot be captured in a graph:
        # its time is then the eager time of a few calls, host waits included
        b, by = bound_ms(n_bytes, n_ops, ops_rate)
        t = {"ms": device_ms(kernel),
             "plain_ms": (eager_ms(plain, iters=3, warmup=1) if plain_reads_host
                          else device_ms(plain, iters=plain_iters)),
             "library_ms": None if library is None else device_ms(library),
             "bound_ms": b, "bound_by": by}
        t["eager"] = (eager_ms(kernel),
                      t["plain_ms"] if plain_reads_host else eager_ms(plain),
                      None if library is None else eager_ms(library))
        return t

    def fixed_point_row(i_flat, kw):
        # bytes: the currents read once, the spikes written once; operations:
        # the reset current and the membrane step (4 flops) for every step of
        # every pass each column runs on this data
        steps, feat = i_flat.shape
        passes = column_passes(i_flat, **kw)
        t = timed(
            lambda: lif_fixed_point_launch(i_flat, **kw),
            lambda: lif_fixed_point_ref(i_flat, **kw),
            None, 8 * steps * feat, 4 * steps * int(passes.sum()), F32_OPS_S,
            plain_reads_host=True,
        )
        chain = int(passes.max()) * steps * CHAIN_CYCLES / sm_clock_hz() * 1e3
        with_read = eager_ms(lambda: lif_fixed_point(i_flat, **kw), iters=50)
        old = eager_ms(lambda: old_fixed_point(i_flat, **kw), iters=5, warmup=1)
        print(f"kernel timing [{card}]: lif_fixed_point at {(steps, feat)}, cap "
              f"{kw['cap']}, column passes {int(passes.min())}-{int(passes.max())} "
              f"(sum {int(passes.sum())}): device {t['ms']:.5f} ms; floor of the "
              f"dependent chain {int(passes.max())} x {steps} x {CHAIN_CYCLES} "
              f"cycles = {chain:.5f} ms, roofline bound {t['bound_ms']:.6f} ms "
              f"by {t['bound_by']} (8.T.F bytes "
              f"{8 * steps * feat / HBM_BYTES_S * 1e3:.6f} ms): the "
              f"{'chain' if chain >= t['bound_ms'] else 'roofline'} sets it; "
              f"kernel at {chain / t['ms']:.3f} of the chain floor; eager with "
              f"the host read {with_read:.5f} ms; the old per-pass loop "
              f"(standalone K4) {old:.5f} ms per call")
        return t

    def project_row(wdm, col_source, col_delay, ring, t_step):
        # bytes: the WDM and the merging table read once, of the ring only
        # the bytes this step's columns address, the f32 current written once
        m, k = wdm.shape
        batch, depth, n_source = ring.shape
        addr = ((t_step - col_delay.long()) % depth) * n_source + col_source
        ring_bytes = batch * int(torch.unique(addr).numel())
        t = timed(
            lambda: spike_wdm_project(wdm, col_source, col_delay, ring, t_step),
            lambda: spike_wdm_project_ref(wdm, col_source, col_delay, ring, t_step),
            None, m * k + 8 * k + ring_bytes + 4 * batch * m, 2 * m * k * batch,
            INT8_OPS_S,
        )
        args = (wdm, col_source, col_delay, ring, t_step)
        old = device_ms(lambda: old_project(*args))
        old_eager = eager_ms(lambda: old_project(*args))
        print(f"kernel timing [{card}]: spike_wdm_project at M={m} K={k} B={batch} "
              f"d={depth} S={n_source}: device {t['ms']:.5f} ms, eager "
              f"{t['eager'][0]:.5f} ms; the old route (index_select, standalone "
              f"K2, cast) device {old:.5f} ms, eager {old_eager:.5f} ms")
        return t

    def lif_row(shape, seed):
        i, v, z = lif_inputs(shape, seed)
        n = i.numel()
        return timed(
            lambda: lif_update(i, v, z, alpha=0.9, v_th=1.0),
            lambda: lif_update_ref(i, v, z, alpha=0.9, v_th=1.0),
            None, 20 * n, 5 * n, F32_OPS_S,
        )

    def step_row(kinds, batch, n, d_slots, seed):
        # bytes a (b, n) element: 4 a current edge; a ring edge reads one
        # update a slot and reads and writes each slot once, the current
        # one written as 0 (12 d_slots); v read and written (8), z (2), the
        # spike row written (4).  Operations: the ring adds, the sum and the
        # fire's 5
        ops = step_inputs(kinds, batch, n, d_slots, 5, seed, 0.5)
        edges, v, z, out, v_th = ops
        plain = clone_step(ops)
        rings = [e.ring.shape[0] for e in edges if isinstance(e, RingEdge)]
        per = 4 * (len(edges) - len(rings)) + 12 * sum(rings) + 14
        flops = sum(rings) + len(edges) - 1 + 5
        t = timed(
            lambda: lif_step(edges, v, z, out, 5, alpha=0.5, v_th=v_th),
            lambda: lif_step_ref(*plain[:4], 5, alpha=0.5, v_th=v_th),
            None, per * batch * n, flops * batch * n, F32_OPS_S,
        )
        t["launch_floor_ms"] = floor
        print(f"kernel timing [{card}]: lif_step with edges {kinds} at (B, N) "
              f"{(batch, n)}, d_slots {d_slots}: device {t['ms']:.5f} ms, "
              f"{t['ms'] / floor:.2f}x the launch floor {floor:.5f} ms; bound "
              f"{t['bound_ms']:.7f} ms ({per} bytes an element)")
        return t

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
        # the classifier report's hidden population (a parallel current),
        # the output population (a sparse ring), the scaffold's widest
        # population with the Purkinje in-degree
        "lif_step": [(("current",), MICRO_BATCH, 20, 2, 1),
                     (("sparse",), MICRO_BATCH, 4, 2, 2),
                     (("current", "sparse", "event"), 64, 80_000, 2, 3)],
        "spike_wdm_matmul": [(512, 2048, 128, 1)],
        "spike_wdm_project": [(*project_inputs(20, 965, 8, 4, 2048, 1), 6)],
        "sparse_gather": [tuple(ell_inputs(4096, 32, 2048, 8, 1)), temporal_gather],
        "lif_parallel_scan": [((512, 512), 1)],
        "lif_fixed_point": [*extra_fixed_points,
                            (fixed_point_inputs((512, 64), 1), dict(
                                alpha=0.5, v_th=64.0, cap=513))],
        "ssd_chunk": [((1, 256, 24, 64, 128, 1), 1), ((16, 256, 24, 64, 128, 24), 1)],
    }
    fns = {"lif_update": lif_row, "lif_step": step_row, "spike_wdm_matmul": wdm_row,
           "spike_wdm_project": project_row, "sparse_gather": gather_row,
           "lif_parallel_scan": scan_row, "lif_fixed_point": fixed_point_row,
           "ssd_chunk": ssd_row}
    rows = []
    for name, fn in fns.items():
        t = fn(*path[name])
        show(name, "the path shape " + path_desc(name, path[name]), t)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCE.get(name, name)}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": err[name],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "launch_floor_ms") if k in t},
        })
        for args in extra[name]:
            show(name, path_desc(name, args), fn(*args))
    val, idx, x = path["sparse_gather"]
    temporal_layouts(val, idx, x.shape[0], temporal_steps)
    # the fixed point past the spike words' shared-memory limit
    long = long_train(60_000, 40, 40).cuda()
    kw = dict(alpha=0.9, v_th=64.0, cap=60_001)
    passes = lif_fixed_point(long, **kw)[1]
    ms = device_ms(lambda: lif_fixed_point_launch(long, **kw), iters=3, replays=3)
    chain = passes * 60_000 * CHAIN_CYCLES / sm_clock_hz() * 1e3
    print(f"kernel timing [{card}]: lif_fixed_point at (60000, 40), alpha 0.9, "
          f"spike words in device memory, {passes} passes: device {ms:.5f} ms; "
          f"chain floor {passes} x 60000 x {CHAIN_CYCLES} cycles = {chain:.5f} ms")
    return rows


def path_desc(name, args):
    if name == "lif_step":
        return f"edges {args[0]}, (B, N) {args[1:3]}, d_slots {args[3]}"
    if name == "lif_fixed_point":
        return f"{tuple(args[0].shape)}, cap {args[1]['cap']}"
    if name == "spike_wdm_project":
        wdm, _, _, ring, t = args
        return f"M={wdm.shape[0]} K={wdm.shape[1]} (B, d, S)={tuple(ring.shape)} t={t}"
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

    lif, wdm, ell, par, step = set(), set(), [], [], set()
    kind = {"-": "current", "sparse": "sparse", "dense": "dense", "event": "event"}
    for rep in reports.values():
        exe = network_executable(net, rep)
        forms = exe.serial_forms(batch)
        for p in exe.plan.update_order:     # each population's step
            edges = exe.plan.in_edges[p]
            step.add((tuple(kind[forms[i]] for i in edges), batch,
                      exe.plan.pop_sizes[p],
                      max([exe.metas[i].delay_range + 1 for i in edges
                           if forms[i] != "-"], default=2)))
        for i, (meta, form) in enumerate(zip(exe.metas, forms)):
            lif.add((batch, meta.n_target))
            if meta.paradigm == "parallel":
                wdm.add((meta.n_target, int(exe.params[i][0].shape[1]), batch))
                # the WDM, its merging table, and the ring's (d, S)
                par.append((*exe.params[i], max(1, meta.delay_range),
                            meta.n_source))
            elif form == "sparse":
                val, idx = exe._sparse_param(i)
                ell.append((val, idx, meta.n_source))
    return sorted(lif), sorted(wdm), ell, par, sorted(step)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this test needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import (
        KERNEL_OPS, build_kernels, launch_counts, reset_launch_counts,
    )
    from repro_torch.kernels.lif_parallel_scan import (
        lif_fixed_point, shared_words_limit, staged_steps_limit,
    )
    from repro_torch.kernels.lif_update import MAX_EDGES

    t_start = time.perf_counter()
    laps = [("1. build and kernel checks", t_start)]

    def lap(name):
        """Print the seconds since the previous phase began."""
        print(f"seconds: {laps[-1][0]} took {time.perf_counter() - laps[-1][1]:.1f} s")
        laps.append((name, time.perf_counter()))
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    require(len(sys.argv) == 1, f"unknown arguments {sys.argv[1:]}")

    # 1. build
    t0 = time.perf_counter()
    build_kernels()
    print(f"build: {len(KERNEL_OPS)} kernel sources ({len(REPLACES)} entry points) "
          f"built or found in {time.perf_counter() - t0:.1f} s")
    from repro_torch.kernels import _build
    for name in KERNEL_OPS:
        report = _build.ptxas_report(name)
        require(bool(report), f"no ptxas report for {name}")
        for kernel, usage in report:
            print(f"ptxas: {name}: {kernel}: {usage}")
    fixed = {
        "lif_update": [(256, 128), (300, 36), (1, 1), (1000, 3), (1024, 128)],
        # (in-edge kinds, B, N, d_slots): each kind alone at the path's
        # widths and batches (1 and 8), eight edges (one launch), nine
        # rings and 17 edges (launches chained), the scaffold's widest
        # population with the Purkinje in-degree, the smallest
        "lif_step": [(("current",), 8, 20, 2), (("sparse",), 8, 20, 2),
                     (("dense",), 8, 4, 3), (("event",), 1, 20, 2),
                     (("sparse", "event", "dense", "current", "sparse", "current",
                       "event", "dense"), 8, 20, 3),
                     (("sparse",) * 9, 8, 20, 3),
                     (("event", "current", "dense", "sparse") * 4 + ("current",),
                      8, 20, 3),
                     (("sparse", "event"), 8, 20, 20),      # past 16 slots
                     (("current", "sparse", "event"), 64, 80_000, 2),
                     (("current", "sparse"), 1, 1, 1)],
        # (M, K, N): the reference's shapes, the benchmark's, and a batch
        # past 65,535 lanes
        "spike_wdm_matmul": [(4, 16, 1), (128, 128, 128), (128, 512, 128),
                             (300, 700, 36), (1, 1, 1), (257, 1025, 129),
                             (512, 2048, 128), (5, 40, 70_000)],
        # (R, L, S, B[, layout]): the reference's shapes, then both designs
        # (B <= 32, B > 32) on ragged rows with strided spikes
        "sparse_gather": [(4096, 32, 2048, 8), (3000, 17, 500, 3), (1, 1, 1, 1),
                          (40, 78, 2048, 8, "transposed"), (40, 1, 2048, 32, "sliced"),
                          (40, 78, 2048, 33, "transposed"), (40, 78, 2048, 600),
                          (40, 78, 2048, 600, "transposed"), (1000, 5, 300, 3, "sliced")],
        "lif_parallel_scan": [(75, 160), (75, 32), (300, 130), (512, 512), (1, 1)],
        # (T, F): the gesture path's two populations, a longer train,
        # (None) one longer than the shared-memory staging limit, and
        # ("long") T = 60,000, past the spike words' shared-memory limit
        "lif_fixed_point": [(75, 160), (75, 32), (512, 64), (None, 40), (1, 1),
                            ("long", 32), ("long", 40)],
        # (M, K, B, d, S): the gesture path's parallel edge (d 1), rings of
        # depth 4 and 3, a K above the kernel's 1 KB staging tile, a batch
        # past 65,535 lanes
        "spike_wdm_project": [(20, 965, 8, 1, 2048), (20, 965, 8, 4, 2048),
                              (33, 9000, 5, 4, 3000), (300, 700, 36, 3, 500),
                              (1, 1, 1, 1, 1), (5, 40, 70_000, 2, 30)],
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
          f"{list(SCAN_ALPHAS)}; the fused fixed point bitwise, passes and "
          f"residual equal, at alpha in {list(FP_ALPHAS)} with caps "
          f"{list(FP_CAPS)}, staged up to T = "
          f"{staged_steps_limit(torch.device('cuda'))}, spike words in shared "
          f"memory up to T = {shared_words_limit(torch.device('cuda'))} and in "
          "device memory at T = 60,000 (passes <= 4, against the plain version "
          "on a CPU copy); lif_step bitwise on v, z, the spike row and every "
          f"ring for edge kinds {list(EDGE_KINDS)} and up to 17 in-edges (chained "
          f"launches past {MAX_EDGES}) at alpha 0.5 and 0.9, max "
          f"|diff| {err['lif_step']}; both WDM entries exact at a batch of "
          "70,000; the projection with its "
          "ring gather bitwise over t past the ring depth; the SSD block within rtol = atol = 1e-4, "
          f"max |diff| {err['ssd_chunk']:.3e}, at most {err['ssd_chunk/tol']:.3f} of "
          "the tolerance)")

    lap("2. compile and path-shape checks")
    # 2. compile
    net = gesture_net()
    reports, clf = compile_reports(net)
    reqs = make_requests()
    batches = [micro_batch(reqs[:MICRO_BATCH]), micro_batch(reqs[MICRO_BATCH:])]
    lif_s, wdm_s, ell_s, par_s, step_s = path_shapes(net, reports, MICRO_BATCH)
    # the temporal path scans (T, B*N) per population and gathers T*B columns
    scan_s = sorted({(x.shape[0], MICRO_BATCH * n)
                     for x, _ in batches for n in net.layer_sizes[1:]})
    print(f"compile: path shapes: lif_step {step_s}, lif {lif_s}, wdm {wdm_s}, ell "
          f"{[(tuple(v.shape), s) for v, _, s in ell_s]}, scan {scan_s}")
    path_err = check_kernels({
        "lif_update": lif_s, "lif_step": step_s, "spike_wdm_matmul": wdm_s,
        # the fused step hands its (B, S) spikes over as the view x_t.t()
        "sparse_gather": [(v.shape[0], v.shape[1], s, MICRO_BATCH, "transposed")
                          for v, _, s in ell_s],
        "lif_parallel_scan": scan_s,
        "lif_fixed_point": scan_s,
        "spike_wdm_project": [],
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
    from repro_torch.kernels.spike_wdm_matmul import (
        spike_wdm_project, spike_wdm_project_ref,
    )
    rings = []
    for wdm, src, dly, depth, n_source in par_s:   # the compiled WDM operands
        ring = (torch.rand((MICRO_BATCH, depth, n_source), device="cuda") < 0.2
                ).to(torch.int8)
        rings.append(ring)
        for t in range(3 * depth + 1):
            out = spike_wdm_project(wdm, src, dly, ring, t)
            ref = spike_wdm_project_ref(wdm, src, dly, ring, t)
            require(torch.equal(out, ref),
                    "spike_wdm_project differs on the compiled operands")
            path_err["spike_wdm_project"] = max(path_err["spike_wdm_project"],
                                                max_abs_diff(out, ref))
    err = {k: max(err[k], path_err[k]) for k in err}

    lap("3. serve, fused")
    # 3. serve, fused: the main path, with the launch counts read around it
    oracles = lane_oracles(net, batches)
    reset_launch_counts()
    served = serve_main_path(net, reports, batches)
    counts = launch_counts()
    print(f"serve: launches on the served path: {counts}")
    for name in ("lif_step", "spike_wdm_project", "sparse_gather"):
        require(counts[name] > 0, f"{name} was never launched on the served path")
    hold_replies(net, reports, batches, served, oracles)
    parallel_edge_ops(par_s[0], rings[0])
    for name, rep in reports.items():
        step_ops(net, name, rep, batches[0])

    lap("3b. serve, engine")
    # 3b. serve through the engine: the SNN user's path, counts read around it
    engine, traffic, launched = engine_ready(net, reports)
    reset_launch_counts()
    rids, replay, e_stats, e_rps = serve_engine(engine, traffic)
    e_counts = launch_counts()
    print(f"engine: launches on the engine's path: {e_counts}")
    hold_engine(net, reports, engine, traffic, rids, replay, launched, e_counts)

    lap("4. serve, temporal")
    # 4. serve, temporal: the second path, counts read around it alone
    reset_launch_counts()
    t_served, t_records = serve_temporal(net, reports, batches)
    t_counts = launch_counts()
    print(f"temporal: launches on the temporal path: {t_counts}")
    for name in ("lif_fixed_point", "sparse_gather"):
        require(t_counts[name] > 0, f"{name} was never launched on the temporal path")
    # one fused K4 launch per iterative population and run_temporal launch
    n_iter = sum(list(next(iter(rec.values())).modes.values()).count("iterative")
                 for rec in t_records.values()) * len(batches)
    require(t_counts["lif_fixed_point"] == n_iter
            and t_counts["lif_parallel_scan"] == 0,
            f"temporal: {t_counts['lif_fixed_point']} fused K4 launches for "
            f"{n_iter} iterative populations")
    hold_temporal(net, reports, batches, t_served, served, t_records, oracles)

    lap("5-6. exact modes, step-serial block")
    # 5. the exact reset modes, 6. the step-serial block
    exact_modes(clf, batches)
    hybrid_block()
    recurrent_device()

    lap("7. mamba2, and the timings of phases 3-7")
    # 7. serve mamba2-130m: f32 against the CPU (K5 counted around it), bf16 timed
    cfg32, host32, steps32, greedy32, ssd_launches = serve_mamba2_f32()

    for name, rep in reports.items():
        time_serving(net, name, rep, batches[0], card)
        time_temporal(net, name, rep, batches[1], card)
    time_engine(net, reports, engine, traffic, e_stats, e_rps, card)
    serve_mamba2_bf16(card, host32, steps32, greedy32)

    lap("8. the cerebellum scaffold")
    # 8. the cerebellum scaffold at 10k and 100k neurons, its paths' counts
    # read around each path alone
    s_counts, s_json = scaffold_phase(card)

    gather_args = max(ell_s, key=lambda e: e[0].numel())
    ga_val, ga_idx, ga_s = gather_args
    path = {
        "lif_update": ((MICRO_BATCH, max(n for _, n in lif_s)), 0),
        # the serial report's hidden population: one sparse ring edge
        "lif_step": (("sparse",), MICRO_BATCH, max(n for _, n in lif_s), 2, 0),
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
    from repro_torch.core.runtime import network_executable
    fps = path_fixed_points(network_executable(net, reports["classifier"]),
                            *batches[1])
    # the JSON row: the train that takes the most passes (the output
    # population's at alpha 0.5); the other is printed
    fps.sort(key=lambda a: -lif_fixed_point(a[0], **a[1])[1])
    path["lif_fixed_point"] = fps[0]
    wdm, src, dly, _, _ = par_s[0]
    path["spike_wdm_project"] = (wdm, src, dly, rings[0], 5)
    launches = {k: counts[k] + t_counts[k] + e_counts[k] + s_counts[k]
                for k in counts}
    launches["ssd_chunk"] += ssd_launches
    ssm = cfg32.ssm
    path["ssd_chunk"] = ((LM_BATCH * -(-LM_PROMPT // ssm.chunk), ssm.chunk,
                          ssm.expand * cfg32.d_model // ssm.head_dim,
                          ssm.head_dim, ssm.d_state, ssm.n_groups), 0)
    rows = kernel_rows(path, err, launches, card, temporal_gather,
                       max(x.shape[0] for x, _ in batches), fps[1:])
    lap("end")
    print(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"scaffold": s_json}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
