#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; exits non-zero, printing no result, without them.  Seven phases,
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
   valid_steps=...)`` for each report.  Every reply must equal, bit for
   bit, the request run alone at batch 1 on the card, the port on the CPU,
   and ``run_graph_reference``.  One parallel edge's step must be two
   device operations (the fused K2 and the ring write) and no host wait;
   a whole step must be its projections' operations (two a parallel edge,
   K3 a sparse serial edge) and one ``lif_step`` a population, counted
   from the profiler at two train lengths, with no host wait in a launch.
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

Earlier lines print the kernels' launch counts on each served path, their
times (CUDA events) beside the plain versions' and a library call's, and
the served micro-batch's time per step on both paths, each beside the
route the fused kernels replaced (on ``run_device`` the population step's
eager glue around the standalone K1, on ``run_temporal`` the per-pass loop
with the standalone K4), timed in turns in the same run, with the host
waits of a launch counted; and the card's launch floor (an empty kernel,
graph-replayed) beside ``lif_step``.

The line before the card line is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
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
    given) through the population step, and through the route it replaced."""
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

    return launch, launch_old


def step_ops(net, name, rep, batch):
    """Device operations a step of run_device, from the profiler at two
    train lengths (their difference over the steps between them, so the
    launch's constant part drops out), for the population-step route and
    the one it replaced.  The profiler can drop activity records but never
    adds any, so each count is the largest of three profiles.  A step must
    be its projections' operations (the fused K2 and the ring copy a
    parallel edge, K3 a sparse serial edge) and one lif_step a population;
    a launch waits for the card nowhere."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    steps = batch[0].shape[0]
    half = steps // 2
    n_pops = len(net.layer_sizes) - 1
    want = n_pops + sum(2 if l.paradigm == "parallel" else 1 for l in rep.layers)
    launches, ops = {}, {}
    for route in (0, 1):
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
    require(waits == 0, f"serve {name}: run_device waits for the card {waits} times")
    require(launches[0] < launches[1],
            f"serve {name}: {launches[0]} device launches a launch, old route "
            f"{launches[1]}")
    print(f"serve: {name:10s} device operations a step {ops[0]:g} (projections "
          f"{want - n_pops}, lif_step {n_pops}), old route {ops[1]:g}; device "
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
    launch, launch_old = launch_pair(net, rep, batch)
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

    # 5. the exact reset modes, 6. the step-serial block
    exact_modes(clf, batches)
    hybrid_block()
    recurrent_device()

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
    launches = {k: counts[k] + t_counts[k] for k in counts}
    launches["ssd_chunk"] += ssd_launches
    ssm = cfg32.ssm
    path["ssd_chunk"] = ((LM_BATCH * -(-LM_PROMPT // ssm.chunk), ssm.chunk,
                          ssm.expand * cfg32.d_model // ssm.head_dim,
                          ssm.head_dim, ssm.d_state, ssm.n_groups), 0)
    rows = kernel_rows(path, err, launches, card, temporal_gather,
                       max(x.shape[0] for x, _ in batches), fps[1:])
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
