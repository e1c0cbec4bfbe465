#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; exits non-zero, printing no result, without them.  Fifteen
phases, none of which is caught and swallowed:

1. **Build.**  Compile the six CUDA sources from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together), print the card's name
   and power limit, and hold each of the first eight kernel entry points against
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
   launch exactly as often as the launches' steps imply.  The pool
   captures each warmed shape as one CUDA graph, and every launch must
   replay one.  Requests a second, p50/p95 latency, one supervised
   launch's host time beside ``run_device``'s, and the pool's launch of a
   full micro-batch by graph replay beside the eager step loop (bitwise
   equal; us a step, in turns) are printed.
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
9. **Serve the attention, recurrent and MoE archs** (no kernel of ours
   runs on their path: the reference computes these blocks outside any
   Pallas kernel).  (a) Every arch's smoke config in float32 (the
   reference's smoke settings: b 2, s 12, cache 16, MoE capacity 8.0) and
   recurrentgemma's at s 40, past its window of 32 (where the reference's
   ring offset shows): prefill and 3 greedy decode steps on the card
   against the port on the CPU, same weights; logits and every cache within
   ``lm_close``, greedy tokens equal.  (b) recurrentgemma-2b at full width
   and depth (26 layers, d 2560, 3.31B parameters) in float32: batch 2 x 64
   tokens and 8 decode steps, the CPU teacher-forced with the card's
   tokens, within ``lm_close``.  (c) The same arch in the published
   bfloat16 through ``repro_torch.launch.serve.main`` (batch 4 x 1024 + 32
   greedy steps), then prefill and decode timed on the same weights (host
   ms, device ms and busy share by the profiler, top device ops, peak
   memory); logits finite.  (d) olmoe-1b-7b at full width with its depth
   cut to 4 of 16 layers: float32 batch 2 x 32 + 4 steps, card against the
   CPU with no routed pair's expert differing; sort and onehot dispatch
   agree on the card at capacity 8.0; then bfloat16 at batch 4 x 1024 + 32
   greedy steps, timed as in (c).
10. **Train mamba2-130m** (``repro_torch.launch.train``: K5 in the forward
   pass and its recompute, its gradient ``SSDChunk``'s plain backward,
   AdamW, checkpoint/restart).  (a) K5's gradient at the train shape (G 32,
   Q 256, H 24, P 64, N 128, one group) and the smoke shape, the card
   against autograd through the plain version on the card, within
   ``lm_close``, one launch a forward; the forward kernel, plain forward
   and plain backward timed.  (b) Every arch's smoke config in float32
   (batch 2 x 40, MoE capacity 8.0): one train step on the card against
   the CPU, same weights and batch: the loss, grad norm and every gradient
   leaf within ``lm_close``, no routed pair's expert differing.  (c)
   mamba2-130m at full width and depth in float32, batch 2 x 256: the same,
   then one AdamW update of the card's gradients on the card and on a CPU
   copy.  (d) The published bfloat16 through ``train.main`` (30 steps of
   8 x 1024 tokens, checkpoints every 10 steps, a failure at step 15): it
   must restore step 10, its loss must fall, and K5 must launch 48 times a
   step (24 layers, forward and recompute); then a step is timed (host ms
   to a sync, tokens/s, device ms, launches and busy share, peak memory)
   and profiled, K5's forward kernels and its plain backward apart.
11. **The dry run** (``repro_torch.launch.dryrun``).  (a) Every (arch x
   shape) cell through ``run_cell`` at ``--mesh single`` (one rank of a
   fake world of 256) and ``--mesh multi`` (512), traced on the meta
   device in four processes of their own started before phase 1 (the card
   hidden from them), the records written to ``build/dryrun.jsonl``: 0
   errors, and exactly the reference's skips at each mesh (long_500k for
   the eight archs that are not sub-quadratic).  (b) The cells phases 7, 9 and 10 measured (mamba2-130m
   train at 8 x 1024; recurrentgemma-2b, olmoe-1b-7b at 4 layers and
   mamba2-130m bf16 prefill at 4 x 1024) counted through ``count_cell``:
   each roofline bound must not exceed the measured device ms; the
   predicted peak is printed beside the measured one (the step's
   arguments and what it allocates), and flagged when more than 25% off.
12. **The SNN over a mesh of ranks** (``shard(mesh=)`` and
   ``shard(assignment=)`` over ``torch.distributed``, one process a rank).
   (a) A world of one NCCL rank: phase 8's 100k scaffold at batch 8 under
   ``shard(mesh=make_host_mesh())`` (1 x 1) through ``run_device``,
   ``run_batched`` and ``run_temporal``, bitwise equal to phase 8's
   unsharded replies, with no collective on the size-1 groups, and timed
   in turns with the unsharded launch.  (b) Four gloo ranks in spawned
   processes, every one on the one card (NCCL refuses two ranks on one
   card), each collective through a host buffer: the 10k scaffold at batch
   8 over meshes 4 x 1 and 2 x 2 through ``run_device``, ``run_batched``
   and ``run_device`` with every serial edge in the event form (each rank
   walks its slab of rows with the event-driven kernel; its
   ``run_temporal`` is refused, as on one card), the
   gesture network's ``run_temporal`` over the same meshes (its passes and
   residuals the one-card run's), and ``tests/test_tiling.py``'s
   ``skip-and-loop`` fixture placed round-robin over four devices through
   ``shard(assignment=)`` (9 tiles, 36 projections, 28 halo edges): every
   rank's trains bitwise equal to the one-card run, the halo elements sent
   the plan's rows, each rank's K1-K4 launches, collectives and elements
   printed, and every split K2/K3 and event-form operand slab held
   bitwise against its plain version.
13. **The language models over a mesh of ranks** (DTensor trees under the
   reference's sharding rules, ``launch/steps.py``).  (a) A world of one
   NCCL rank, the 1 x 1 mesh, full width: mamba2-130m's f32 train step
   (batch 2 x 256) through ``shard_tree`` and ``sharding_ctx`` against the
   unsharded step on the card (loss, every gradient leaf, the updated
   parameters and moments within ``lm_close``, as many K5 launches); its
   bf16 step (8 x 1024) timed in turns with the unsharded one;
   recurrentgemma-2b's bf16 prefill (4 x 1024) and 8 decode steps the
   same way.  (b) Four ranks in spawned processes on the one card, every
   collective through host buffers (``distributed/staged.py``):
   mamba2-130m at full width in f32 over 2 x 2, 4 x 1 and 1 x 4 (a train
   step of 8 x 256, a prefill of 8 x 256 and 4 decode steps), the smoke
   configs of olmoe-1b-7b (sort and local dispatch), recurrentgemma-2b and
   qwen3-8b over 2 x 2, and ``make_train_step_compressed`` over (pod 2,
   data 1, model 2): every rank's gathered outputs within ``lm_close`` of
   the unsharded step on the card (the compressed step's m within one int8
   quantum), each rank's K5 launches and collectives printed.

14. **The event form's kernel** (``event_scatter``, the ninth entry
   point).  The microcircuit's largest event-form projection, L2/3E ->
   L2/3E at full scale (20,683 x 20,683, p 0.1009: 43.2 M synapses, drawn as
   ``build_microcircuit(1.0, seed=0)`` draws it), compiled serial and lowered
   on the card; its rows indexed by source (``source_major_index``) and the
   kernel held bitwise against the sweep it replaced (the plain version) at
   B 1 and t across the ring's wrap, at L2/3E's served rate (0.324 Hz) and
   at 8 Hz; both timed (graph replay) beside their bound, 12 B a synaptic
   event of the spikes given.  Phase 8 also times each event-form edge of
   the scaffold driven and swept.  Alone: ``python3 -c "import chip_smoke as
   c; print(c.event_phase(c.card_line()))"`` (~40 s).
15. **K2's two designs** (``spike_wdm_project``: the latency design, a
   warp a row and lane, and the streamed design, the map read once a call
   for every lane).  The full-scale microcircuit's 11 parallel projections
   (the maps within the dense cap, each drawn alone as
   ``build_microcircuit(1.0, seed=0)`` draws it), compiled parallel and
   lowered on the card: both designs bitwise the plain version at B 1 and
   t 0..9; one step's 11 calls timed as one graph in each design, in turns,
   beside the benchmark's counted bound, and each streamed call's device
   time in that step.  The scaffold's K2 maps at B 8, before (latency) and
   after (the routed design), and the threshold's sweep of both designs
   from 19 KB to 8 MB at B 1 and 8.  Alone: ``python3 -c "import
   chip_smoke as c; print(c.wdm_phase(c.card_line()))"``.

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
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))
from repro_torch.launch.hardware import H100  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W), the port's
# own set: device memory bytes/s, int8 and TF32 tensor-core ops/s, f32
# (non-tensor-core) flop/s.
HBM_BYTES_S = H100.hbm_bandwidth
INT8_OPS_S = H100.peak_ops_int8
TF32_OPS_S = H100.peak_flops_tf32
F32_OPS_S = H100.peak_flops_f32

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
    "event_scatter": "none (the event form is XLA's segment_sum, "
                     "src/repro/core/runtime/serial_runtime.py)",
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
#: mamba2-130m served in phase 7, and recurrentgemma-2b and olmoe-1b-7b timed
#: in phase 9: batch, prompt tokens, greedy decode steps
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 1024, 32
#: phase 9 (b): recurrentgemma-2b in f32, card against the CPU: batch,
#: prompt tokens, decode steps
RG_F32 = (2, 64, 8)
#: phase 9 (d): olmoe-1b-7b's layers of 16 kept (the CPU init and host
#: memory), and its f32 request: batch, prompt tokens, decode steps (a small
#: batch: a near-tie in top_k may flip between devices on large ones)
OLMOE_LAYERS, OLMOE_F32 = 4, (2, 32, 4)


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


def other_bytes(args) -> int:
    """What is allocated on the card besides the step's arguments ``args``
    (earlier phases' tensors).  The peak since the last reset less this is
    the step's peak as the dry run counts it: its arguments and what it
    allocates."""
    from repro_torch.launch.roofline import storage_bytes

    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() - storage_bytes(args)


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
    captures = sum(c["graph_captures"] for c in by.values())
    replays = sum(c["graph_replays"] for c in by.values())
    require(captures == sum(c["warm_shapes"] for c in by.values()),
            f"engine: {captures} CUDA graphs captured for the warmed shapes "
            f"{ {m: c['warm_shapes'] for m, c in by.items()} }")
    require(replays == len(launched),
            f"engine: {replays} of the {len(launched)} launches replayed a CUDA graph")
    require(counts["lif_update"] == counts["spike_wdm_matmul"] == 0,
            f"engine: standalone kernels launched: {counts}")
    print(f"engine: {n_held} replies ({len(rids)} Poisson, {len(replay)} replayed; "
          f"{n_shed} shed) bit-identical to the request alone on the card, the "
          f"port on the CPU and run_graph_reference; {len(launched)} launches "
          f"(batched {sum(c['batched_launches'] for c in by.values())}, fused "
          f"{sum(c['fused_launches'] for c in by.values())}), CUDA graphs "
          f"captured {captures}, replayed {replays}, hits "
          f"{st['bucket_hits']}, misses {st['bucket_misses']}, re-lowerings "
          f"{st['relowerings']}, supervisor faults 0; kernel launches {want} as "
          "the launches' steps imply")


@contextlib.contextmanager
def eager_loop(exe):
    """Launches of ``exe`` run the eager step loop while inside, as before
    its warmed shapes were captured as CUDA graphs."""
    saved = exe._graphs
    exe._graphs = {}
    try:
        yield
    finally:
        exe._graphs = saved


def time_engine(net, reports, engine, traffic, stats, rps, card):
    """The engine's numbers on the card: requests a second and latency of
    the Poisson pass; one full micro-batch's launch through the
    supervisor (run_batched, the wait for the card, the flag read and the
    host copies) beside run_device alone on it with a sync, in turns; and
    the pool's launch of it by CUDA-graph replay beside the eager step
    loop, bitwise equal, in turns."""
    from repro_torch.core.runtime import network_executable
    from repro_torch.serving import BucketKey, SNNRequest, pad_microbatch
    from repro_torch.serving.pool import host_arrays as pool_host_arrays

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

    def launch_pool():
        return engine.pool.run_microbatch(mb)

    def launch_pool_eager():
        with eager_loop(exe):
            return engine.pool.run_microbatch(mb)

    def copied(outs):
        # a launch's trains are views of the host buffer the next one fills
        return [torch.from_numpy(a) for a in pool_host_arrays(outs)]

    require(same_replies(copied(launch_pool()), copied(launch_pool_eager())),
            "engine: the pool's replayed launch differs from the eager loop")
    before = engine.pool.counters_by_model()["default"]["graph_replays"]
    pr, (pr_a, pr_b), pe, (pe_a, pe_b) = in_turns(launch_pool, launch_pool_eager)
    replays = engine.pool.counters_by_model()["default"]["graph_replays"] - before
    require(replays == 26, f"engine: {replays} of the 26 replay-route launches "
            "replayed a CUDA graph")
    steps = mb.key.steps
    print(f"engine timing [{card}]: the pool's launch of {len(reqs)} requests "
          f"({steps} steps, {MICRO_BATCH} lanes) by CUDA-graph replay "
          f"{pr / steps * 1e3:.2f} us a step ({pr:.3f} ms a launch: {pr_a:.3f}, "
          f"{pr_b:.3f}; {replays} launches replayed), eager step loop "
          f"{pe / steps * 1e3:.2f} us a step ({pe:.3f} ms: {pe_a:.3f}, {pe_b:.3f}); "
          f"replay {100 * (pr / pe - 1):+.1f}%")


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
    given) and run_batched of the same micro-batch."""
    from repro_torch.core.runtime import network_executable

    exe = network_executable(net, rep)
    x, vs = batch
    xs = torch.as_tensor(x[:steps], device="cuda")
    vs_t = torch.as_tensor(np.minimum(vs, xs.shape[0]), device="cuda")

    def launch():
        return exe.run_device(xs, valid_steps=vs_t)

    def launch_batched():
        return exe.run_batched(xs, valid_steps=vs_t)

    return launch, launch_batched


def step_ops(net, name, rep, batch):
    """Device operations a step of run_device and run_batched, from the
    profiler at two train lengths (their difference over the steps between
    them, so the launch's constant part drops out).  The profiler can drop activity records but never
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
    require(ops[1] == want, f"serve {name}: run_batched takes {ops[1]} device "
            f"operations a step, want {want}")
    require(waits == 0, f"serve {name}: run_device waits for the card {waits} times")
    print(f"serve: {name:10s} device operations a step {ops[0]:g} (projections "
          f"{want - n_pops}, lif_step {n_pops}), run_batched {ops[1]:g}; device "
          f"launches a run_device launch of {steps} steps {launches[0]} (constant "
          f"{launches[0] - ops[0] * steps:g}); lif_step "
          f"launches {counts['lif_step']}, "
          f"lif_update {counts['lif_update']}, host waits {waits}")


def time_serving(net, name, rep, batch, card):
    """One served micro-batch through run_device: host time per launch (ends
    in a sync), the same launch's device time (captured once as a CUDA graph
    and replayed, so no host time is in it), and the device kernels that
    make it up; run_batched's replies held bitwise to run_device's."""
    launch, launch_batched = launch_pair(net, rep, batch)
    x, vs = batch
    require(same_replies(launch(), launch_batched()),
            f"serve {name}: run_device and run_batched differ")
    dt = host_ms(launch)
    dev = device_ms(launch, iters=1, replays=20)
    steps = x.shape[0]
    print(f"serve timing [{card}]: {name} micro-batch of {len(vs)} "
          f"({steps} steps): population step {dt:.3f} ms per launch, "
          f"{dt / steps * 1e3:.1f} us per step, "
          f"{int(vs.sum()) / dt * 1e3:,.0f} request-steps/s, device "
          f"{dev:.3f} ms, busy share {dev / dt:.3f}")
    total, n, top = profiled_ms(launch)
    print(f"serve profile [{card}]: {name}: device {total:.3f} ms in {n} "
          f"launches; top: {top}")


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
    ell = {names[i]: tuple(exe._form_operands(i, "sparse")[0].shape)
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
    the fused K2 a parallel edge, K3 a sparse edge, the event-driven scatter
    an event-form edge on the card (swept, with no launch, on the CPU); on
    the temporal path the step-serial block's alone
    per step, plus one K3 a whole-train sparse projection and one fused K4
    an iterative population."""
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
    want["event_scatter"] = (steps * edges.count("event")
                             if exe.device.type == "cuda" else 0)
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


#: device operations of a projection's step by form: the fused K2 and the
#: ring write a parallel edge, K3 a sparse edge, the zero fill and the
#: event-driven scatter an event-form update
FORM_OPS = {"-": 2, "sparse": 1, "event": 2}


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
    update at batch 1, driven and swept."""
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
            val, idx = exe._form_operands(i, "sparse")
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
            val, idx = exe._form_operands(i, "sparse")
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
        w, d, s, tg, row_ptr = exe._form_operands(i, "event")
        kw = dict(delay_range=meta.delay_range, n_target=meta.n_target)
        driven = functools.partial(serial_update, w, d, s, tg, row_ptr, x_t, 3,
                                   **kw)
        swept = functools.partial(serial_update, w, d, s, tg, None, x_t, 3, **kw)
        require(torch.equal(driven()[0], swept()[0]),
                f"scaffold {n}: the event-driven scatter differs from the sweep")
        events = float(x_t[0] @ torch.diff(row_ptr).float())
        edge = exe.report.layers[i].layer_name
        event.append({"size": n, "edge": edge, "rows": int(w.numel()),
                      "events": events, "update_ms": device_ms(driven),
                      "sweep_ms": device_ms(swept, iters=20),
                      "bound_ms": bound_ms(12 * events, 0, 1)[0]})
        print(f"scaffold kernel [{card}]: {n} event form {edge} at batch 1 "
              f"({int(w.numel())} synapse rows, {events:g} events): driven "
              f"{event[-1]['update_ms']:.5f} ms, the sweep "
              f"{event[-1]['sweep_ms']:.5f} ms, bound "
              f"{event[-1]['bound_ms']:.6f} ms (12 B an event)")
    return rows, event


#: phase 14: spike probabilities a step of L2/3E at B 1: its mean rate in
#: the served microcircuit (0.324 Hz at 1 ms, tools/microcircuit_rates.py),
#: and the external sources' 8 Hz
EVENT_RATES = {"L2/3E 0.324 Hz": 0.000324, "8 Hz": 0.008}


def l23e_projection():
    """The microcircuit's largest projection, L2/3E -> L2/3E at full scale
    (20,683 x 20,683, p 0.1009: 43.2 M synapses), drawn as
    ``build_microcircuit(1.0, seed=0)`` draws it (its projection 0)."""
    from repro_torch.scaffold.microcircuit import microcircuit_projection

    return microcircuit_projection(0)


def event_phase(card):
    """Phase 14: the event form's update on the microcircuit's largest
    event-form projection (L2/3E -> L2/3E, compiled serial and lowered as
    the benchmark's tenant lowers it) at B 1: the event-driven kernel
    against the sweep it replaced (the plain version), bitwise at t across
    the ring's wrap, then each timed (graph replay) beside its bound, 12 B
    a synaptic event of the spikes given, at each of EVENT_RATES.  Returns
    the ``kernels`` row of event_scatter."""
    from repro_torch.core.runtime.serial_runtime import lower_serial, source_major_index
    from repro_torch.core.serial_compiler import compile_serial
    from repro_torch.kernels.event_scatter import event_scatter, event_scatter_ref

    t0 = time.perf_counter()
    exe = lower_serial(compile_serial(l23e_projection()), device=CARD)
    swept = (exe.row_weight, exe.row_delay, exe.row_src, exe.row_tgt)
    rows = tuple(a.clone() for a in swept)          # the rows the kernel reads
    t_index = time.perf_counter()
    row_ptr = source_major_index(*rows, n_source=exe.n_source)
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t_index
    n_rows, d_slots = int(exe.row_weight.numel()), exe.delay_range + 1
    kw = dict(d_slots=d_slots, n_target=exe.n_target)
    print(f"event [{card}]: L2/3E -> L2/3E lowered, {n_rows} rows in cell order, "
          f"in {time.perf_counter() - t0:.1f} s; its source index in {t_index:.3f} s")
    gen = torch.Generator(device=CARD).manual_seed(14)
    out_degree = torch.diff(row_ptr).float()
    row = None
    for what, p in EVENT_RATES.items():
        x = (torch.rand((1, exe.n_source), generator=gen, device=CARD) < p).float()
        for t in range(2 * d_slots + 1):
            require(torch.equal(event_scatter(*rows, row_ptr, x, t, **kw),
                                event_scatter_ref(*swept, x, t, **kw)),
                    f"event: the kernel differs from the sweep at {what}, t {t}")
        events = float(x[0] @ out_degree)
        t = kernel_time(lambda: event_scatter(*rows, row_ptr, x, 3, **kw),
                        lambda: event_scatter_ref(*swept, x, 3, **kw), None,
                        12 * events, 0, 1, iters=100)
        print(f"event timing [{card}]: L2/3E -> L2/3E at B 1, {what} "
              f"({int(x.sum())} sources fired, {events:g} events): kernel "
              f"{t['ms']:.5f} ms, the sweep {t['plain_ms']:.5f} ms, bound "
              f"{t['bound_ms']:.6f} ms (12 B an event); {t['plain_ms'] / t['ms']:.1f}x; "
              f"bitwise equal at t 0..{2 * d_slots}")
        if row is None:
            row = {"name": "event_scatter", "route": "cuda",
                   "source": "src/repro_torch/csrc/event_scatter.cu",
                   "replaces": REPLACES["event_scatter"], "max_abs_err": 0.0,
                   "shape": f"R {n_rows}, S {exe.n_source}, B 1, {what}",
                   **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")}}
    del exe, swept, rows
    torch.cuda.empty_cache()
    return row


#: phase 15: the (M, K) maps of K2's threshold sweep, 19 KB to 8 MB:
#: gesture's map, then rows of 1,024 and of 8,192 columns (tall and wide)
WDM_SWEEP = [(20, 965), (64, 1024), (128, 1024), (256, 1024), (512, 1024),
             (1024, 1024), (2048, 1024), (4096, 1024), (8192, 1024),
             (16, 8192), (32, 8192), (64, 8192), (128, 8192), (256, 8192),
             (512, 8192), (1024, 8192)]


def wdm_bound_ms(m, k, batch):
    """K2's least time as the benchmark counts it: the map once, its two
    int32 column tables, a ring byte a column and lane, the f32 current."""
    n_bytes = m * k + 8 * k + batch * k + 4 * batch * m
    return bound_ms(n_bytes, 2 * m * k * batch, INT8_OPS_S)[0]


def microcircuit_maps():
    """The full-scale microcircuit's parallel projections (the 11 within
    the dense cap: the benchmark's classifier tenant compiles them
    parallel), each drawn alone as ``build_microcircuit(1.0, seed=0)``
    draws it, compiled parallel and lowered on the card."""
    from repro_torch.core.layer import DENSE_ELEMENT_CAP
    from repro_torch.core.parallel_compiler import compile_parallel
    from repro_torch.core.runtime.parallel_runtime import lower_parallel
    from repro_torch.scaffold.microcircuit import (
        MICROCIRCUIT, microcircuit_edges, microcircuit_projection,
    )

    sizes = dict(zip(MICROCIRCUIT.populations, MICROCIRCUIT.sizes))
    sizes["ext"] = sum(MICROCIRCUIT.sizes)
    maps = []
    for k, (pre, post, _) in enumerate(microcircuit_edges()):
        if sizes[pre] * sizes[post] <= DENSE_ELEMENT_CAP:
            proj = microcircuit_projection(k)
            maps.append((proj.name, lower_parallel(compile_parallel(proj),
                                                   device=CARD)))
    return maps


def wdm_phase(card):
    """Phase 15: K2's two designs.  (a) The microcircuit's 11 parallel maps
    as lowered, at B 1 (a ring of depth 4 at 8 Hz): both designs bitwise
    the plain version at t 0..9; one step's 11 calls replayed as one CUDA
    graph in each design, in turns, beside the step's counted bound, and
    each streamed call's device time in that sequence (the profiler), so
    that no map is read warm from the L2 of its own last call.  (b) The
    scaffold's K2 maps at B 8: both designs bitwise, timed alone (warm)
    before (latency) and after (the design the threshold routes them to).
    (c) The threshold sweep: both designs over WDM_SWEEP at B 1 and 8,
    alone.  Returns the ``kernels`` rows of the streamed design."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.spike_wdm_matmul import (
        spike_wdm_project_ref, wdm_design,
    )
    from repro_torch.kernels.spike_wdm_matmul.ops import STREAM_MIN_BYTES, _project

    t0 = time.perf_counter()
    maps = microcircuit_maps()
    require(len(maps) == 11, f"wdm: {len(maps)} microcircuit maps within the cap")
    gen = torch.Generator(device=CARD).manual_seed(15)
    calls = []
    for name, exe in maps:
        m, k = exe.wdm_stack.shape
        depth = max(1, exe.delay_range)
        ring = (torch.rand((1, depth, exe.n_source), generator=gen, device=CARD)
                < 0.008).to(torch.int8)
        ops = (exe.wdm_stack, exe.col_source, exe.col_delay, ring)
        require(wdm_design(m, k, 1) == "streamed",
                f"wdm: {name} ({m}, {k}) is not routed to the streamed design")
        for t in range(10):
            ref = spike_wdm_project_ref(*ops, t)
            for design in ("latency", "streamed"):
                require(torch.equal(_project(design, *ops, t), ref),
                        f"wdm: the {design} design differs on {name} at t {t}")
        calls.append((name, m, k, ops))
    print(f"wdm [{card}]: the microcircuit's parallel maps, lowered in "
          f"{time.perf_counter() - t0:.1f} s, both designs bitwise the plain "
          f"version at t 0..9: {[(n, m, k) for n, m, k, _ in calls]}")

    def step(design):
        return lambda: [_project(design, *ops, 5) for _, _, _, ops in calls]

    bound = sum(wdm_bound_ms(m, k, 1) for _, m, k, _ in calls)
    turns = [(d, device_ms(step(d), iters=5, replays=20))
             for d in ("latency", "streamed", "streamed", "latency")]
    ms = {d: min(t for e, t in turns if e == d) for d in ("latency", "streamed")}
    print(f"wdm timing [{card}]: the microcircuit's 11 K2 calls of a step at B 1 "
          f"(one graph, in turns {[(d, round(t, 5)) for d, t in turns]}): latency "
          f"{ms['latency']:.5f} ms, streamed {ms['streamed']:.5f} ms, bound "
          f"{bound:.5f} ms (bytes): {100 * bound / ms['streamed']:.1f} % of it "
          f"streamed, {100 * bound / ms['latency']:.1f} % latency; "
          f"{ms['latency'] / ms['streamed']:.2f}x")
    graph = torch.cuda.CUDAGraph()
    fn = step("streamed")
    fn()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    # each call's device time in the step, from the profiler (which can
    # drop activity records: a replay's calls are read only when it kept
    # them all)
    replays = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if "wdm_kernel<true" in e.name
                      and str(e.device_type).upper().endswith("CUDA")),
                     key=lambda e: e.time_range.start)
    require(all("streamed::" in e.name for e in kernels),
            "wdm: a microcircuit map ran the latency design in the step")
    rows = [{"name": "spike_wdm_project", "design": "streamed", "route": "cuda",
             "source": "src/repro_torch/csrc/spike_wdm_matmul.cu",
             "replaces": REPLACES["spike_wdm_project"], "max_abs_err": 0.0,
             "edge": "the microcircuit's 11 parallel maps, a step",
             "shape": [[m, k] for _, m, k, _ in calls], "ms": ms["streamed"],
             "latency_design_ms": ms["latency"], "bound_ms": bound,
             "bound_by": "bytes"}]
    if len(kernels) != replays * len(calls):
        print(f"wdm timing [{card}]: the profiler kept {len(kernels)} of "
              f"{replays * len(calls)} calls; no time a call")
    for i, (name, m, k, ops) in enumerate(calls):
        if len(kernels) != replays * len(calls):
            break
        us = [kernels[j].time_range.elapsed_us() for j in range(i, len(kernels),
                                                                len(calls))]
        t_ms, b = float(np.median(us)) / 1e3, wdm_bound_ms(m, k, 1)
        print(f"wdm timing [{card}]: {name} ({m}, {k}) B 1 streamed in the step: "
              f"{t_ms:.5f} ms, bound {b:.6f} ms (bytes), {100 * b / t_ms:.1f} %, "
              f"{m * k / t_ms / 1e9:.3f} TB/s of map")
        rows.append({**rows[0], "edge": name, "shape": [m, k, 1, 4], "ms": t_ms,
                     "bound_ms": b})
        del rows[-1]["latency_design_ms"]
    del calls, maps, graph
    torch.cuda.empty_cache()

    def both(m, k, batch, seed):
        ops = project_inputs(m, k, batch, 4, max(k, 1), seed)
        for t in range(9):
            ref = spike_wdm_project_ref(*ops, t)
            for design in ("latency", "streamed"):
                require(torch.equal(_project(design, *ops, t), ref),
                        f"wdm: the {design} design differs at ({m}, {k}, {batch}), t {t}")
        turns = [(d, device_ms(lambda d=d: _project(d, *ops, 5)))
                 for d in ("latency", "streamed", "streamed", "latency")]
        return {d: min(t for e, t in turns if e == d) for d in ("latency", "streamed")}

    for n, shapes in SCAFFOLD_SHAPES.items():
        for edge, (m, k) in shapes["wdm"].items():
            t = both(m, k, MICRO_BATCH, m + k)
            routed = wdm_design(m, k, MICRO_BATCH)
            print(f"wdm timing [{card}]: scaffold {n} {edge} ({m}, {k}) B "
                  f"{MICRO_BATCH} alone: before (latency) {t['latency']:.5f} ms, "
                  f"after ({routed}) {t[routed]:.5f} ms, bound "
                  f"{wdm_bound_ms(m, k, MICRO_BATCH):.6f} ms; the routed design no "
                  f"slower: {t[routed] <= t['latency']}")
    faster = {}
    for batch in (1, MICRO_BATCH):
        for m, k in WDM_SWEEP:
            t = both(m, k, batch, m * k + batch)
            faster[(m * k, batch)] = faster.get((m * k, batch), True) and (
                t["streamed"] < t["latency"])
            print(f"wdm sweep [{card}]: ({m}, {k}) {m * k} B at B {batch}: latency "
                  f"{t['latency']:.5f} ms, streamed {t['streamed']:.5f} ms, routed "
                  f"{wdm_design(m, k, batch)}")
    wins = sorted(b for (b, _), f in faster.items()
                  if all(faster[(c, bb)] for (c, bb) in faster if c >= b))
    print(f"wdm sweep [{card}]: the streamed design is faster at every swept map "
          f"from {wins[0] if wins else None} B at B 1 and 8; the threshold is "
          f"{STREAM_MIN_BYTES} B")
    return rows


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
    counts of its paths, the ``scaffold`` JSON object, and per size the
    network, report, batch-8 stimulus and replies that phase 12 reruns."""
    from repro_torch.scaffold import build_cerebellum

    t_phase = time.perf_counter()
    total = {k: 0 for k in REPLACES}
    out = {"card": card, "sizes": {}, "kernels": [], "event": []}
    built, kept = {}, {}
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
            kept[n] = scaffold_size(n, built.pop(n), compiles.pop(n),
                                    oracles.pop(n), card, total, out)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"scaffold: phase took {out['seconds']:.1f} s")
    return total, out, kept


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
    return sc.network, rep, x8, {k: served[k] for k in (
        "run_device", "run_batched", "run_temporal") if k in served}


# -- 7. serve mamba2-130m ----------------------------------------------------------
def lm_inputs():
    """The served request, as repro_torch.launch.serve draws it for seed 0."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-130m")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)))
    return cfg, tokens, LM_PROMPT + LM_STEPS + 1


def lm_run(params, cfg, batch, cache_len, forced=None, steps=LM_STEPS):
    """Prefill ``batch`` (host tensors), then ``steps`` greedy decode steps
    (fed ``forced``'s tokens when given).  Returns the logits of every step
    (host f32), the tokens fed back, the caches after the prefill and at the
    end (host), and the kernels' launch counts in the prefill and in the
    decode steps, each set to 0 just before and read just after."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import model as lm

    dev = params["tok_embed"].device
    pos = batch["embeds" if "embeds" in batch else "tokens"].shape[1] \
        + cfg.n_frontend_tokens
    with torch.inference_mode():
        reset_launch_counts()
        logits, caches = lm.prefill(params, cfg,
                                    {k: v.to(dev) for k, v in batch.items()},
                                    cache_len)
        counts = [launch_counts()]
        after_prefill = lm_host(caches)
        outs, fed = [logits.float().cpu()], []
        reset_launch_counts()
        for i in range(steps):
            tok = (forced[:, i:i + 1] if forced is not None
                   else outs[-1][:, -1].argmax(-1)[:, None])
            fed.append(tok)
            logits, caches = lm.decode_step(params, cfg, tok.to(dev), pos + i,
                                            caches, cache_len)
            outs.append(logits.float().cpu())
        counts.append(launch_counts())
    return outs, torch.cat(fed, dim=1), after_prefill, lm_host(caches), counts


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
            f"f32 card vs CPU: {what} differs: max |diff| {err} at scale {scale}")
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
        params, cfg, {"tokens": tokens}, cache_len)
    print(f"mamba2: launches in the prefill {in_prefill}; in the {LM_STEPS} "
          f"decode steps {in_decode}")
    require(in_prefill["ssd_chunk"] == cfg.n_layers,
            f"ssd_chunk launched {in_prefill['ssd_chunk']} times in the prefill")
    require(in_decode["ssd_chunk"] == 0, "ssd_chunk launched in decode")
    require(all(tuple(x.shape) == (LM_BATCH, 1, cfg.vocab) for x in steps),
            "mamba2: logits of the wrong shape")

    t0 = time.perf_counter()           # full depth: ~13 s on the card's host
    c_steps, _, c_cache_p, c_cache_e, _ = lm_run(host, cfg, {"tokens": tokens},
                                                 cache_len, forced=toks)
    t_cpu = time.perf_counter() - t0
    errs = {"logits": max(lm_close(a, b, f"mamba2 logits of step {i}")
                          for i, (a, b) in enumerate(zip(steps, c_steps)))}
    for when, got, want in (("prefill", cache_p, c_cache_p), ("end", cache_e, c_cache_e)):
        for name in ("conv", "ssd"):
            errs[f"{name} cache ({when})"] = lm_close(
                got[0][0][name], want[0][0][name],
                f"mamba2 {name} cache after the {when}")
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
    steps16 = lm_run(params, cfg, {"tokens": tokens}, cache_len,
                     forced=greedy32[:, :-1])[0]
    diff = max(float((a - b).abs().max()) for a, b in zip(steps16, steps32))
    agree = float(np.mean([bool(a[b, -1].argmax() == c[b, -1].argmax())
                           for a, c in zip(steps16, steps32) for b in range(LM_BATCH)]))

    batch = {"tokens": tokens.cuda()}
    with torch.inference_mode():
        def prefill():
            return lm.prefill(params, cfg, batch, cache_len)

        other = other_bytes((params, batch))
        torch.cuda.reset_peak_memory_stats()
        _, caches = prefill()
        pre_peak = torch.cuda.max_memory_allocated() - other
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
    return {"device_ms": pre_dev, "peak_bytes": pre_peak}


# -- 9. serve the attention, recurrent and MoE archs -------------------------------
def lm_batch(cfg, b, s, seed):
    """A prompt as repro_torch.launch.serve draws it (host tensors): tokens,
    then the stub frontends' embeddings from the same generator."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))}
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.as_tensor(rng.normal(
            size=(b, cfg.n_frontend_tokens, cfg.d_model)) * 0.02).to(dt)
    if cfg.frontend == "audio":
        batch = {"embeds": torch.as_tensor(rng.normal(
            size=(b, s, cfg.d_model)) * 0.02).to(dt)}
    return batch


def hold_lm(name, got, want):
    """Every step's logits and every cache leaf (after the prefill and at
    the end) of a card run against the CPU run, within ``lm_close``.
    Returns the largest (abs, share of scale) of the logits and caches."""
    steps, _, cache_p, cache_e, _ = got
    c_steps, _, c_cache_p, c_cache_e, _ = want
    logits = max(lm_close(a, b, f"{name} logits of step {i}")
                 for i, (a, b) in enumerate(zip(steps, c_steps)))
    caches = (0.0, 0.0)
    for when, g, w in (("prefill", cache_p, c_cache_p), ("end", cache_e, c_cache_e)):
        for gi, (gg, ww) in enumerate(zip(g, w)):
            for ti, (gb, wb) in enumerate(zip(gg, ww)):
                require(gb.keys() == wb.keys(), f"{name}: cache trees differ")
                for leaf in wb:
                    caches = max(caches, lm_close(
                        gb[leaf], wb[leaf],
                        f"{name} cache {gi}.{ti}.{leaf} after the {when}"))
    return logits, caches


def serve_smoke_archs():
    """Phase 9 (a): every arch's smoke config in f32 (MoE capacity 8.0, the
    reference's smoke settings: b 2, s 12, cache 16) and recurrentgemma's at
    s 40, past its window of 32: prefill and 3 greedy decode steps on the
    card and on the CPU, same weights; equal greedy tokens.  Returns the
    largest error's share of its tensor's scale and the kernels' launches
    on the card's runs (each run's prefill and decode counted alone)."""
    from repro_torch.configs import ARCH_NAMES, smoke_config
    from repro_torch.models import init as minit

    worst, launches = 0.0, {k: 0 for k in REPLACES}
    for arch, seq in [(a, 12) for a in ARCH_NAMES] + [("recurrentgemma-2b", 40)]:
        cfg = smoke_config(arch)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        cache_len = 16 if seq == 12 else seq + 4
        host = minit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        batch = lm_batch(cfg, 2, seq, seed=0)
        got = lm_run(minit.tree_to(host, "cuda"), cfg, batch, cache_len, steps=3)
        want = lm_run(host, cfg, batch, cache_len, steps=3)
        greedy = [torch.cat([r[1], r[0][-1][:, -1].argmax(-1)[:, None]], 1)
                  for r in (got, want)]
        require(torch.equal(*greedy), f"{arch} s {seq}: greedy tokens differ: "
                f"{greedy[0].tolist()} vs {greedy[1].tolist()}")
        logits, caches = hold_lm(f"{arch}-smoke s {seq}", got, want)
        worst = max(worst, logits[1], caches[1])
        in_prefill, in_decode = got[4]
        # only mamba2's prefill runs a kernel of ours: K5, once a layer
        want_k5 = cfg.n_layers if "mamba2" in cfg.block_pattern else 0
        require(nonzero(in_prefill) == (nonzero({"ssd_chunk": want_k5}))
                and nonzero(in_decode) == "none",
                f"{arch}: launches {in_prefill} in the prefill, {in_decode} "
                "in decode")
        for k, v in in_prefill.items():
            launches[k] += v
        print(f"lm smoke {arch} s {seq}: card vs CPU logits max abs {logits[0]:.3e} "
              f"(rel {logits[1]:.3e}), caches {caches[0]:.3e} (rel {caches[1]:.3e}); "
              f"greedy tokens equal {greedy[0][0].tolist()}; launches in the "
              f"prefill {nonzero(got[4][0])}")
    return worst, launches


def nonzero(counts):
    return {k: v for k, v in counts.items() if v} or "none"


def serve_recurrentgemma_f32():
    """Phase 9 (b): recurrentgemma-2b at full width and depth in f32: batch
    RG_F32[0] x RG_F32[1] prompt tokens, then RG_F32[2] decode steps, the
    CPU teacher-forced with the card's tokens.  Returns the host weights."""
    from repro_torch.configs import get_config
    from repro_torch.models import init as minit

    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), dtype="float32")
    b, seq, steps = RG_F32
    t0 = time.perf_counter()
    host = minit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    t_init = time.perf_counter() - t0
    params = minit.tree_to(host, "cuda")
    batch, cache_len = lm_batch(cfg, b, seq, seed=0), seq + steps + 1
    got = lm_run(params, cfg, batch, cache_len, steps=steps)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = lm_run(host, cfg, batch, cache_len, forced=got[1], steps=steps)
    t_cpu = time.perf_counter() - t0
    logits, caches = hold_lm("recurrentgemma-2b", got, want)
    print(f"recurrentgemma-2b f32: {minit.param_count(cfg):,} parameters "
          f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV head of {cfg.head_dim}, window {cfg.attn_window}, "
          f"vocab {cfg.vocab}; CPU init {t_init:.1f} s), batch {b} x {seq} + "
          f"{steps} steps: card vs the port on the CPU (CPU run {t_cpu:.1f} s, "
          "decode teacher-forced) logits max abs "
          f"{logits[0]:.3e} rel {logits[1]:.3e}, every cache max abs {caches[0]:.3e} "
          f"rel {caches[1]:.3e}; greedy tokens of request 0: {got[1][0].tolist()}")
    return host


def time_lm(name, card, params, cfg, batch, cache_len):
    """Prefill and decode of ``batch`` timed on the card: host ms to a sync,
    device ms and busy share by the profiler, the top device ops, and the
    peak device memory of these runs (the weights included).  Returns the
    logits of the prefill and of one decode step, and the prefill's device
    ms and its peak as the dry run counts it (the first call alone)."""
    from repro_torch.models import model as lm

    other = other_bytes(params)
    torch.cuda.reset_peak_memory_stats()
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    pos = batch["embeds" if "embeds" in batch else "tokens"].shape[1] \
        + cfg.n_frontend_tokens
    with torch.inference_mode():
        def prefill():
            return lm.prefill(params, cfg, dev_batch, cache_len)

        first, caches = prefill()
        pre_peak = torch.cuda.max_memory_allocated() - other
        tok = first[:, -1].argmax(-1)[:, None]

        def decode():
            return lm.decode_step(params, cfg, tok, pos, caches, cache_len)

        step = decode()[0]
        pre_host = host_ms(prefill, reps=3)
        dec_host = host_ms(decode, reps=LM_STEPS)
        (pre_dev, pre_n, pre_top), (dec_dev, dec_n, dec_top) = (
            profiled_ms(prefill), profiled_ms(decode))
    b, seq = batch["embeds" if "embeds" in batch else "tokens"].shape[:2]
    print(f"{name} [{card}]: prefill (batch {b} x {seq}) {pre_host:.3f} ms, device "
          f"{pre_dev:.3f} ms in {pre_n} launches, busy share {pre_dev / pre_host:.3f}; "
          f"decode {dec_host:.3f} ms a step ({b * 1e3 / dec_host:.1f} tok/s), device "
          f"{dec_dev:.3f} ms in {dec_n} launches, busy share {dec_dev / dec_host:.3f}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"{name} profile [{card}]: prefill top: {pre_top}")
    print(f"{name} profile [{card}]: decode step top: {dec_top}")
    return first, step, {"device_ms": pre_dev, "peak_bytes": pre_peak}


def serve_recurrentgemma_bf16(card, host32):
    """Phase 9 (c): recurrentgemma-2b in the published bf16 through the
    user's entry point, then timed on the same weights (the init draws in
    f32 and casts, so ``host32`` cast to bf16 is serve.main's)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import init as minit

    cfg = get_config("recurrentgemma-2b")
    require(cfg.dtype == "bfloat16", f"published dtype {cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve.main(["--arch", "recurrentgemma-2b", "--batch", str(LM_BATCH),
                      "--prompt-len", str(LM_PROMPT), "--gen", str(LM_STEPS)])
    t_main = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(out["tokens"].shape == (LM_BATCH, LM_STEPS)
            and ((0 <= out["tokens"]) & (out["tokens"] < cfg.vocab)).all(),
            "recurrentgemma-2b bf16: serve.main's tokens out of range")
    print(f"recurrentgemma-2b bf16 [{card}]: serve.main (batch {LM_BATCH} x "
          f"{LM_PROMPT} + {LM_STEPS} greedy steps, {t_main:.1f} s with the CPU init): "
          f"prefill {out['prefill_s'] * 1e3:.3f} ms (first call), decode "
          f"{out['decode_tok_per_s']:.1f} tok/s, peak device memory "
          f"{peak / 2**30:.3f} GiB")
    params = minit.tree_to(minit.tree_to(host32, "cuda"), torch.bfloat16)
    batch = lm_batch(cfg, LM_BATCH, LM_PROMPT, seed=0)
    first, step, measured = time_lm("recurrentgemma-2b bf16", card, params, cfg, batch,
                          LM_PROMPT + LM_STEPS)
    require(bool(torch.isfinite(first).all() and torch.isfinite(step).all()),
            "recurrentgemma-2b bf16: logits not finite")
    agree = float((first[:, -1].argmax(-1).cpu().numpy() == out["tokens"][:, 0]).mean())
    print(f"recurrentgemma-2b bf16: logits finite; the first greedy token equals "
          f"serve.main's on {agree:.2f} of the batch")
    del params
    torch.cuda.empty_cache()
    return measured


class RouteLog:
    """Records the experts each MoE layer routes to (``blocks._route``),
    for the card and CPU runs of one request."""

    def __init__(self):
        from repro_torch.models import blocks
        self.blocks, self.route, self.picks = blocks, blocks._route, []

    def __enter__(self):
        def route(*args):
            w, e = self.route(*args)
            self.picks.append(e.cpu())
            return w, e

        self.blocks._route = route
        return self.picks

    def __exit__(self, *exc):
        self.blocks._route = self.route


def serve_olmoe(card):
    """Phase 9 (d): olmoe-1b-7b at full width with its depth cut: f32 card
    against the CPU port with the routing compared pair by pair, sort and
    onehot dispatch on the card, then bf16 timed."""
    from repro_torch.configs import get_config
    from repro_torch.models import init as minit, model as lm

    full = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(full, n_layers=OLMOE_LAYERS, dtype="float32")
    t0 = time.perf_counter()
    host = minit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    t_init = time.perf_counter() - t0
    params = minit.tree_to(host, "cuda")
    b, seq, steps = OLMOE_F32
    batch, cache_len = lm_batch(cfg, b, seq, seed=0), seq + steps + 1
    with RouteLog() as card_picks:
        got = lm_run(params, cfg, batch, cache_len, steps=steps)
    with RouteLog() as cpu_picks:
        want = lm_run(host, cfg, batch, cache_len, forced=got[1], steps=steps)
    require(len(card_picks) == len(cpu_picks) == OLMOE_LAYERS * (steps + 1),
            "olmoe: MoE layers routed a different number of times")
    flips = sum(int((a != c).sum()) for a, c in zip(card_picks, cpu_picks))
    pairs = sum(a.numel() for a in card_picks)
    print(f"olmoe-1b-7b: depth cut to {OLMOE_LAYERS} of {full.n_layers} layers "
          f"(width not cut: d {cfg.d_model}, {cfg.moe.n_experts} experts, top "
          f"{cfg.moe.top_k}, expert d_ff {cfg.moe.d_ff}, capacity "
          f"{cfg.moe.capacity_factor}), {minit.param_count(cfg):,} parameters "
          f"(CPU init {t_init:.1f} s); routed pairs whose expert differs between "
          f"the card and the CPU: {flips} of {pairs}")
    require(flips == 0, f"olmoe: {flips} routed pairs differ between card and CPU")
    logits, caches = hold_lm("olmoe-1b-7b", got, want)

    # sort and onehot agree on the card when nothing drops (capacity 8.0)
    agree = {}
    for dispatch in ("sort", "onehot"):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0, dispatch=dispatch))
        with torch.inference_mode():
            agree[dispatch] = lm.prefill(
                params, c, {k: v.cuda() for k, v in batch.items()}, cache_len)[0].cpu()
    dispatch_err = lm_close(agree["onehot"], agree["sort"],
                            "olmoe onehot vs sort dispatch logits")
    print(f"olmoe-1b-7b f32: batch {b} x {seq} + {steps} steps, card vs the port on "
          f"the CPU logits max abs {logits[0]:.3e} rel {logits[1]:.3e}, every cache "
          f"max abs {caches[0]:.3e} rel {caches[1]:.3e}; on the card at capacity "
          f"8.0 onehot vs sort logits max abs {dispatch_err[0]:.3e} rel "
          f"{dispatch_err[1]:.3e}")
    del params
    torch.cuda.empty_cache()

    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params = minit.tree_to(minit.tree_to(host, "cuda"), torch.bfloat16)
    batch = lm_batch(cfg16, LM_BATCH, LM_PROMPT, seed=0)
    t0 = time.perf_counter()
    run = lm_run(params, cfg16, batch, LM_PROMPT + LM_STEPS + 1, steps=LM_STEPS)
    t_run = time.perf_counter() - t0
    require(all(bool(torch.isfinite(x).all()) for x in run[0]),
            "olmoe bf16: logits not finite")
    print(f"olmoe-1b-7b bf16 [{card}]: batch {LM_BATCH} x {LM_PROMPT} + {LM_STEPS} "
          f"greedy steps in {t_run:.3f} s, logits finite; greedy tokens of request "
          f"0: {run[1][0, :12].tolist()}")
    measured = time_lm(f"olmoe-1b-7b {OLMOE_LAYERS}L bf16", card, params, cfg16,
                       batch, LM_PROMPT + LM_STEPS + 1)[2]
    del params
    torch.cuda.empty_cache()
    return measured


def lm_phase(card):
    """Phase 9: the attention, recurrent and MoE archs (no kernel of ours
    runs on their path: the reference has no Pallas kernel for these
    blocks; the mamba2 smoke config's prefill launches K5).  Returns the
    device ms and peaks of the two bf16 prefills (phase 11 reads them)."""
    worst, launches = serve_smoke_archs()
    print(f"lm smoke: all archs' card vs CPU within tolerance, largest share of "
          f"scale {worst:.3e}; launches on the smoke path {nonzero(launches)}")
    host32 = serve_recurrentgemma_f32()
    measured = {"recurrentgemma-2b prefill": serve_recurrentgemma_bf16(card, host32)}
    del host32
    measured[f"olmoe-1b-7b {OLMOE_LAYERS}L prefill"] = serve_olmoe(card)
    return measured


# -- 10. train mamba2-130m ---------------------------------------------------------
#: phase 10 (a): K5's gradient at mamba2-130m's train shape (batch 8 x 1024:
#: 32 chunks) and its smoke shape (batch 2 x 40: 6 chunks), (G, Q, H, P, N, Hg)
TRAIN_SSD_SHAPES = [(32, 256, 24, 64, 128, 1), (6, 16, 8, 16, 16, 1)]
#: phase 10 (c): mamba2-130m at full width and depth in f32: batch, tokens
TRAIN_F32 = (2, 256)
#: phase 10 (d): the bf16 run through train.main
TRAIN_RUN = dict(steps=30, batch=8, seq=1024, ckpt_every=10, failure=15)
#: the annotation the K5 Function's backward runs under (its ops are plain
#: PyTorch, so the profiler names them by op, not by kernel)
K5_BACKWARD = "ssd_chunk_backward"
K5_KERNELS = ("ssd_scores_kernel", "ssd_chunk_kernel")


def k5_gradient(card):
    """Phase 10 (a): SSDChunk on the card (the kernel forward, the plain
    backward) against autograd through the plain version on a card copy,
    within ``lm_close``; one launch a forward, none in the backward.  At
    the train shape, the forward kernel, the plain forward and the plain
    backward are timed.  Returns that shape's times."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.ssd_chunk import SSDChunk, ssd_chunk, ssd_chunk_backward, ssd_chunk_ref

    times = {}
    for shape in TRAIN_SSD_SHAPES:
        ops = [t.requires_grad_() for t in ssd_inputs(shape, seed=21, decay="mamba2")]
        rng = np.random.default_rng(22)
        before = launch_counts()["ssd_chunk"]
        y, state = ssd_chunk(*ops)
        require(type(y.grad_fn) is SSDChunk._backward_cls,
                f"ssd_chunk's output has grad_fn {type(y.grad_fn).__name__}")
        gy, gs = (torch.tensor(rng.normal(size=t.shape), dtype=torch.float32).cuda()
                  for t in (y, state))
        got = torch.autograd.grad([y, state], ops, [gy, gs])
        torch.cuda.synchronize()
        launched = launch_counts()["ssd_chunk"] - before
        require(launched == 1, f"K5 launched {launched} times for one forward and backward")
        ref = [t.detach().clone().requires_grad_() for t in ops]
        want = torch.autograd.grad(list(ssd_chunk_ref(*ref)), ref, [gy, gs])
        errs = {name: lm_close(a.cpu(), b.cpu(), f"K5 gradient {name} at {shape}")
                for name, a, b in zip(("x", "b", "c", "la"), got, want)}
        print(f"train: K5 gradient at {shape} (G, Q, H, P, N, Hg), card vs autograd "
              "of the plain version on the card: "
              + ", ".join(f"g{k} max abs {a:.3e} rel {r:.3e}" for k, (a, r) in errs.items())
              + "; one launch for the forward, none in the backward")
        if shape == TRAIN_SSD_SHAPES[0]:
            x, b, c, la = (t.detach() for t in ops)
            times = {"forward_ms": device_ms(lambda: ssd_chunk(x, b, c, la), iters=20),
                     "plain_forward_ms": device_ms(lambda: ssd_chunk_ref(x, b, c, la), iters=5),
                     "backward_ms": device_ms(
                         lambda: ssd_chunk_backward(x, b, c, la, gy, gs), iters=5)}
    print(f"train: K5 at the train shape {TRAIN_SSD_SHAPES[0]}: kernel forward "
          f"{times['forward_ms']:.5f} ms, plain forward {times['plain_forward_ms']:.5f} "
          f"ms, plain backward {times['backward_ms']:.5f} ms (device, graph replay)")
    return times


def train_batch(cfg, b, s, seed):
    """``lm_batch``'s prompt as a train batch: the audio arch's frame
    embeddings carry no tokens, so it gets labels too, as the reference's
    smoke tests give it."""
    batch = lm_batch(cfg, b, s, seed)
    if cfg.frontend == "audio":
        rng = np.random.default_rng(seed + 1)
        batch["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)))
    return batch


def hold_train_step(name, cfg, host, batch):
    """One train step of ``cfg`` on the card against the same step of the
    port on the CPU, from ``host``'s weights: the loss, grad norm and every
    gradient leaf within ``lm_close``; the MoE routing pair for pair.
    Returns the largest share of scale, the K5 launches of the card's
    gradient, and the card's gradients."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.models import init as minit, model as lm
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.tree import leaves

    opt = AdamWConfig(warmup_steps=1, total_steps=3)
    params = minit.tree_to(host, "cuda")
    with RouteLog() as card_picks:
        reset_launch_counts()
        loss, grads = lm.value_and_grad(params, cfg, {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        k5 = launch_counts()["ssd_chunk"]
    with RouteLog() as cpu_picks:
        c_loss, c_grads = lm.value_and_grad(host, cfg, batch)
    flips = sum(int((a != c).sum()) for a, c in zip(card_picks, cpu_picks))
    require(len(card_picks) == len(cpu_picks) and flips == 0,
            f"{name}: {flips} routed pairs differ between card and CPU")
    worst = lm_close(loss.cpu(), c_loss, f"{name} loss")
    for i, (a, b) in enumerate(zip(leaves(grads), leaves(c_grads))):
        worst = max(worst, lm_close(a.cpu(), b, f"{name} gradient leaf {i}"),
                    key=lambda e: e[1])
    step = steps.make_train_step(cfg, opt)
    _, _, m_card = step(params, init_state(params), {k: v.cuda() for k, v in batch.items()})
    _, _, m_cpu = step(host, init_state(host), batch)
    for k in ("loss", "grad_norm", "lr"):
        worst = max(worst, lm_close(m_card[k].cpu(), m_cpu[k], f"{name} train_step {k}"),
                    key=lambda e: e[1])
    return worst, k5, grads, sum(a.numel() for a in card_picks)


def train_smoke_archs():
    """Phase 10 (b): every arch's smoke config in f32 (MoE capacity 8.0),
    batch 2 x 40: one train step on the card against the CPU."""
    from repro_torch.configs import ARCH_NAMES, smoke_config
    from repro_torch.models import init as minit

    worst = 0.0
    for arch in ARCH_NAMES:
        cfg = smoke_config(arch)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        host = minit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        (err, rel), k5, _, pairs = hold_train_step(f"{arch}-smoke", cfg, host,
                                                   train_batch(cfg, 2, 40, seed=0))
        want = cfg.n_layers if "mamba2" in cfg.block_pattern else 0
        require(k5 == want, f"{arch}: K5 launched {k5} times in a train step, not {want}")
        worst = max(worst, rel)
        print(f"train smoke {arch}: card vs CPU loss, grad norm and every gradient "
              f"leaf max abs {err:.3e} (rel {rel:.3e}); K5 launches {k5}"
              + (f"; routed pairs whose expert differs: 0 of {pairs}" if pairs else ""))
    return worst


def train_mamba2_f32():
    """Phase 10 (c): mamba2-130m at full width and depth in f32 (remat on,
    as published), batch TRAIN_F32: the train step's gradients on the card
    against the CPU; then one AdamW update of the card's gradients on the
    card and on a CPU copy (independent steps are not compared: Adam's
    first step moves an element by about +-lr, so a gradient near 0 whose
    sign differs moves it by 2 lr)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init as minit
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config("mamba2-130m"), dtype="float32")
    host = minit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b, s = TRAIN_F32
    t0 = time.perf_counter()
    (err, rel), k5, grads, _ = hold_train_step("mamba2-130m f32", cfg, host,
                                               train_batch(cfg, b, s, seed=0))
    t_hold = time.perf_counter() - t0
    require(k5 == 2 * cfg.n_layers, f"mamba2 f32: K5 launched {k5} times in a "
            f"remat train step, not {2 * cfg.n_layers}")
    opt = AdamWConfig(warmup_steps=1, total_steps=3)
    params = minit.tree_to(host, "cuda")
    on_card = apply_updates(params, grads, init_state(params), opt)
    on_cpu = apply_updates(host, minit.tree_to(grads, "cpu"), init_state(host), opt)
    upd = max((lm_close(a.cpu(), b_, "mamba2 f32 update") for a, b_ in
               zip(leaves(on_card[:2]), leaves(on_cpu[:2]))), key=lambda e: e[1])
    print(f"train: mamba2-130m f32 ({cfg.param_count():,} parameters, remat), batch "
          f"{b} x {s}: card vs the port on the CPU ({t_hold:.1f} s with the CPU step) "
          f"loss, grad norm and every gradient max abs {err:.3e} rel {rel:.3e}; K5 "
          f"launches {k5} (forward and recompute); one AdamW update of the card's "
          f"gradients, card vs CPU, max abs {upd[0]:.3e} rel {upd[1]:.3e}")


def train_profile(step):
    """One profiled call of ``step``: device ms and launches of its kernels,
    the top rows, K5's forward kernels and the device time of the kernels
    launched inside the K5 backward's annotation."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total == 0 and e.self_device_time_total > 0
                   and e.key != K5_BACKWARD),
                  key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in rows) / 1e3
    k5_fwd = sum(e.self_device_time_total for e in rows
                 if any(k in e.key for k in K5_KERNELS)) / 1e3
    k5_bwd = sum(e.device_time_total for e in prof.events()
                 if e.name == K5_BACKWARD and e.device_type.name == "CPU") / 1e3
    top = "; ".join(f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                    for e in rows[:8])
    return total, sum(e.count for e in rows), k5_fwd, k5_bwd, top


def train_mamba2_bf16(card):
    """Phase 10 (d): the published bf16 through the user's entry point,
    train.main, with a failure and a restore; then its step timed on the
    same weights.  Returns K5's launches in train.main, and the step's
    device ms and its peak as the dry run counts it (phase 11 reads them)."""
    import io
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import storage_bytes
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps, train
    from repro_torch.models import init as minit
    from repro_torch.optim import AdamWConfig, init_state

    cfg = get_config("mamba2-130m")
    require(cfg.dtype == "bfloat16" and cfg.remat, f"published {cfg.dtype}, remat {cfg.remat}")
    run = TRAIN_RUN
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out_buf = io.StringIO()
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out_buf):
            out = train.main([
                "--arch", "mamba2-130m", "--steps", str(run["steps"]),
                "--batch", str(run["batch"]), "--seq", str(run["seq"]),
                "--ckpt-every", str(run["ckpt_every"]),
                "--simulate-failure", str(run["failure"]), "--ckpt-dir", ckpt])
        t_main = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log = out_buf.getvalue()
    print("\n".join(f"train.main: {line}" for line in log.splitlines()))
    restored = run["failure"] // run["ckpt_every"] * run["ckpt_every"]
    steps_run = run["failure"] + run["steps"] - restored
    require(f"restored step {restored}" in log, f"train.main did not restore step {restored}")
    require(out["last_loss"] < out["first_loss"],
            f"train.main: the loss did not fall: {out['first_loss']} -> {out['last_loss']}")
    want = 2 * cfg.n_layers * steps_run
    require(counts["ssd_chunk"] == want,
            f"train.main: K5 launched {counts['ssd_chunk']} times, not {want} "
            f"({2 * cfg.n_layers} a step x {steps_run} steps)")
    print(f"train: train.main ran {steps_run} steps in {t_main:.1f} s (with the CPU "
          f"init, the data and the checkpoints), restored step {restored} after the "
          f"failure at {run['failure']}; first loss {out['first_loss']:.4f} -> last-10 "
          f"mean {out['last_loss']:.4f}; launches {nonzero(counts)}")

    # the step alone, on train.main's weights and data
    params = minit.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    opt_state = init_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    placed = torch.cuda.memory_allocated()
    step_fn = steps.make_train_step(cfg, AdamWConfig(
        lr=1e-3, total_steps=run["steps"], warmup_steps=max(1, run["steps"] // 20)))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=run["seq"],
                                  global_batch=run["batch"]))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in data.batch_at(0).items()}
    state = [params, opt_state]

    def one_step():
        state[0], state[1], m = step_fn(state[0], state[1], batch)
        return float(m["loss"])        # the launcher's one host read a step

    other = placed - storage_bytes((params, opt_state))
    ms = host_ms(one_step, reps=5)
    peak = torch.cuda.max_memory_allocated()
    total, n, k5_fwd, k5_bwd, top = train_profile(one_step)
    tokens = run["batch"] * run["seq"]
    print(f"train timing [{card}]: mamba2-130m bf16 batch {run['batch']} x {run['seq']} "
          f"(remat): {ms:.3f} ms a step (host clock to a sync, the loss read), "
          f"{tokens * 1e3 / ms:.1f} tokens/s; device {total:.3f} ms in {n} launches, "
          f"busy share {total / ms:.3f}; peak device memory {peak / 2**30:.3f} GiB "
          f"({placed / 2**30:.3f} GiB of weights and AdamW state placed before)")
    print(f"train profile [{card}]: one step: K5 forward kernels {k5_fwd:.3f} ms "
          f"({2 * cfg.n_layers} launches), K5 plain backward {k5_bwd:.3f} ms "
          f"({cfg.n_layers} calls); top: {top}")
    del state, params, opt_state, batch
    torch.cuda.empty_cache()
    return counts["ssd_chunk"], {"device_ms": total, "peak_bytes": peak - other}


def train_phase(card):
    """Phase 10: the training path (repro_torch.launch.train): K5's
    gradient, every smoke arch's train step and mamba2-130m's at full width
    held against the CPU, then the bf16 run with a failure and a restore.
    Returns the K5 launches of train.main, K5's times at its shape, and the
    bf16 step's device ms and peak."""
    times = k5_gradient(card)
    worst = train_smoke_archs()
    print(f"train smoke: every arch's train step, card vs CPU, largest share of "
          f"scale {worst:.3e}")
    train_mamba2_f32()
    launches, measured = train_mamba2_bf16(card)
    return launches, times, measured


# -- 11. the dry run ---------------------------------------------------------------
#: phase 11 (a): where the sweep's records go, and the cells the reference
#: skips (its shape_applicable: long_500k for every arch that is not
#: sub-quadratic)
DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun.jsonl"
DRYRUN_SKIPS = {(arch, "long_500k") for arch in (
    "musicgen-large", "kimi-k2-1t-a32b", "olmoe-1b-7b", "phi3-medium-14b",
    "llama3.2-3b", "qwen1.5-4b", "qwen3-8b", "phi-3-vision-4.2b")}
#: phase 11 (b): a predicted peak further than this share from the measured
#: one is printed as such (and logged in ROADMAP.md), not failed
PEAK_OFF = 0.25
#: the most phase 11 waits for the worker once phases 1-10 are done
DRYRUN_WAIT_S = 600
#: phase 11 (a) sweeps every cell at both production meshes (256 and 512
#: ranks of a fake world) in this many card-free processes
DRYRUN_WORKERS = 4
DRYRUN_MESHES = ("single", "multi")


def dryrun_shares():
    """The sweep's (mesh, arch, shape) cells dealt to DRYRUN_WORKERS lists,
    heaviest first to the lightest list (a cell's weight by its shape and
    arch, from the traces' seconds on a host CPU)."""
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.launch.shapes import SHAPES

    shape_w = {"train_4k": 4, "prefill_32k": 4, "decode_32k": 1, "long_500k": 0.3}
    arch_w = {"kimi-k2-1t-a32b": 3, "musicgen-large": 2, "olmoe-1b-7b": 2}
    cells = sorted(((m, a, s) for m in DRYRUN_MESHES for a in ARCH_NAMES
                    for s in SHAPES),
                   key=lambda c: -shape_w[c[2]] * arch_w.get(c[1], 1))
    shares, load = [[] for _ in range(DRYRUN_WORKERS)], [0.0] * DRYRUN_WORKERS
    for c in cells:
        i = load.index(min(load))
        shares[i].append(c)
        load[i] += shape_w[c[2]] * arch_w.get(c[1], 1)
    return shares


def measured_cells():
    """Phase 11 (b): the cells that phases 7, 9 and 10 measure, as (name,
    config, kind, batch, positions)."""
    from repro_torch.configs import get_config

    olmoe = dataclasses.replace(get_config("olmoe-1b-7b"), n_layers=OLMOE_LAYERS)
    return [
        ("mamba2-130m train", get_config("mamba2-130m"), "train",
         TRAIN_RUN["batch"], TRAIN_RUN["seq"]),
        ("recurrentgemma-2b prefill", get_config("recurrentgemma-2b"), "prefill",
         LM_BATCH, LM_PROMPT),
        (f"olmoe-1b-7b {OLMOE_LAYERS}L prefill", olmoe, "prefill", LM_BATCH, LM_PROMPT),
        ("mamba2-130m prefill", get_config("mamba2-130m"), "prefill", LM_BATCH,
         LM_PROMPT),
    ]


@contextlib.contextmanager
def k5_backward_counted():
    """Count the bytes and FLOPs of K5's plain backward apart while a step
    is counted: each call runs under a second counter of its own (the
    dry run's counter still sees every op)."""
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.launch import roofline

    plain, seen = ops.ssd_chunk_backward, {"bytes": 0, "flops": 0, "calls": 0}

    def counted(*args):
        with roofline._OpCounter() as inner:
            out = plain(*args)
        seen["bytes"] += inner.bytes
        seen["flops"] += sum(inner.flops.values())
        seen["calls"] += 1
        return out

    ops.ssd_chunk_backward = counted
    try:
        yield seen
    finally:
        ops.ssd_chunk_backward = plain


def dryrun_worker(conn, out_path, cells, measured_too):
    """Phase 11's host half, in a process of its own beside phases 1-10,
    with the card hidden: its share of the (mesh, arch, shape) cells
    through ``run_cell`` (records to ``out_path``), then, where
    ``measured_too``, the measured cells through the one-card
    ``count_cell``.  Sends ("ok", records, cells, seconds, card seen) or
    ("error", traceback)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        torch.set_num_threads(1)
        from repro_torch.launch import dryrun, roofline

        t0 = time.perf_counter()
        records = []
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            for mesh, arch, shape in cells:
                records.append(dryrun.run_cell(arch, shape, mesh, verbose=False))
                f.write(json.dumps(records[-1]) + "\n")
        measured = []
        for name, cfg, kind, b, seq in (measured_cells() if measured_too else []):
            with k5_backward_counted() as k5_bwd:
                count = dryrun.count_cell(cfg, kind, b, seq)
            terms = roofline.analyze(count)
            measured.append(dict(name=name, kind=kind, b=b, seq=seq, k5_backward=k5_bwd,
                                 compute_ms=terms.compute_s * 1e3,
                                 memory_ms=terms.memory_s * 1e3,
                                 dominant=terms.dominant, flops=terms.flops,
                                 flops_by_dtype=terms.flops_by_dtype,
                                 hbm_bytes=terms.hbm_bytes, peak_bytes=count.peak_bytes,
                                 seconds=count.seconds))
        conn.send(("ok", records, measured, time.perf_counter() - t0,
                   torch.cuda.is_available()))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def dryrun_start():
    """Start DRYRUN_WORKERS spawned, daemonic workers on their shares of the
    sweep (the first also counts the measured cells); returns [(conn,
    process)]."""
    ctx = get_context("spawn")
    started = []
    for i, share in enumerate(dryrun_shares()):
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=dryrun_worker, daemon=True, args=(
            send, DRYRUN_OUT.with_suffix(f".{i}.jsonl"), share, i == 0))
        proc.start()
        send.close()
        started.append((recv, proc))
    return started


def dryrun_phase(card, started, measured):
    """Phase 11: (a) the sweep's records at both meshes, one line a cell,
    held to 0 errors and the reference's skips at each; (b) each measured
    cell's one-card bound beside its device ms (the bound may not exceed
    it) and its predicted peak beside the measured one.  Returns the rows
    of (b)."""
    t0 = time.perf_counter()
    records, cells, seconds = [], [], []
    for conn, proc in started:
        left = max(1.0, DRYRUN_WAIT_S - (time.perf_counter() - t0))
        require(conn.poll(left),
                f"dry run: no result from a worker within {DRYRUN_WAIT_S} s")
        msg = conn.recv()
        proc.join(timeout=60)
        require(msg[0] == "ok", f"dry run: a worker failed:\n{msg[-1]}")
        _, recs, meas, secs, saw_card = msg
        require(not saw_card, "dry run: a worker saw a card")
        records += recs
        cells += meas
        seconds.append(secs)
    with open(DRYRUN_OUT, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    for r in records:
        head = f"dryrun: {r['arch']} x {r['shape']} x {r['mesh']}: {r['status']}"
        if r["status"] == "ok":
            mem = r["memory_analysis"]
            print(f"{head}, {r['dominant']}; {r['chips']} ranks, a device: compute "
                  f"{r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f} ms, "
                  f"collective {r['collective_s'] * 1e3:.3f} ms "
                  f"({ {k: v for k, v in r['collective_counts'].items() if v} }); peak "
                  f"{mem['peak_bytes'] / 2**30:.3f} GiB, fits one card "
                  f"{mem['fits_one_card']}; traced in {r['compile_s']} s")
        else:
            print(f"{head}: {r.get('reason') or r.get('error')}")
    for mesh in DRYRUN_MESHES:
        rs = [r for r in records if r["mesh"] == mesh]
        n = {k: sum(r["status"] == k for r in rs) for k in ("ok", "skipped", "error")}
        skips = {(r["arch"], r["shape"]) for r in rs if r["status"] == "skipped"}
        print(f"dryrun: --mesh {mesh}: {n['ok']} ok, {n['skipped']} skipped, "
              f"{n['error']} errors of {len(rs)} cells")
        require(n["error"] == 0, f"dry run: {n['error']} cells failed at --mesh {mesh}")
        require(skips == DRYRUN_SKIPS and n["ok"] + n["skipped"] == len(rs) == 40,
                f"dry run --mesh {mesh}: skipped {sorted(skips)}, the reference "
                f"skips {sorted(DRYRUN_SKIPS)}")
    print(f"dryrun: both meshes swept in {max(seconds):.1f} s on the host with no "
          f"card visible ({len(started)} processes: "
          f"{', '.join(f'{s:.1f}' for s in seconds)} s; records in "
          f"{DRYRUN_OUT.relative_to(DRYRUN_OUT.parents[1])})")
    rows = []
    for c in cells:
        m = measured[c["name"]]
        bound = max(c["compute_ms"], c["memory_ms"])
        off = c["peak_bytes"] / m["peak_bytes"] - 1
        row = dict(c, bound_ms=bound, device_ms=m["device_ms"],
                   share=bound / m["device_ms"], measured_peak_bytes=m["peak_bytes"],
                   peak_off=off)
        rows.append(row)
        print(f"dryrun vs measured [{card}]: {c['name']} (batch {c['b']} x "
              f"{c['seq']}): bound {bound:.3f} ms by {c['dominant']} (compute "
              f"{c['compute_ms']:.3f} ms, memory {c['memory_ms']:.3f} ms, "
              f"collective 0 ms; {c['flops']:.4e} FLOPs "
              f"{ {k: f'{v:.4e}' for k, v in c['flops_by_dtype'].items()} }, "
              f"{c['hbm_bytes']:.4e} bytes); measured device {m['device_ms']:.3f} "
              f"ms; bound / measured {bound / m['device_ms']:.3f}; peak predicted "
              f"{c['peak_bytes'] / 2**30:.3f} GiB, measured "
              f"{m['peak_bytes'] / 2**30:.3f} GiB ({off:+.3f})"
              + (f" MORE THAN {PEAK_OFF:.0%} OFF" if abs(off) > PEAK_OFF else ""))
        if c["k5_backward"]["calls"]:
            k5 = c["k5_backward"]
            print(f"dryrun vs measured [{card}]: {c['name']}: K5's plain backward "
                  f"({k5['calls']} calls) {k5['bytes']:.4e} bytes, "
                  f"{k5['bytes'] / c['hbm_bytes']:.3f} of the step's, "
                  f"{k5['bytes'] / HBM_BYTES_S * 1e3:.3f} ms at the memory rate; "
                  f"{k5['flops']:.4e} FLOPs")
        require(bound <= m["device_ms"],
                f"dry run: {c['name']}'s bound {bound:.3f} ms exceeds its measured "
                f"{m['device_ms']:.3f} ms: a faulty count")
    return rows


# -- 12. the SNN over a mesh of ranks ------------------------------------------------
MESH_DIR = Path(__file__).resolve().parent / "build" / "mesh"
#: phase 12 (b): four ranks, every one on the one card, and their meshes
#: (data, model)
MESH_RANKS, MESH_SHAPES = 4, ((4, 1), (2, 2))
MESH_TIMEOUT_S = 600
#: tests/test_tiling.py's "skip-and-loop" geometry, its seed and tiling
#: budget: the fixture of ROADMAP.md §3, placed round-robin on a 4 x 4 grid
#: over four devices (9 tiles, 36 projections, 28 halo edges, 168 bits a
#: step); 64 steps of 8 lanes at rate 0.3
SKIP_AND_LOOP = (
    [("in", 15), ("h1", 14), ("h2", 12), ("out", 7)],
    [("in", "h1", 0.4, 2), ("h1", "h2", 0.4, 2), ("in", "h2", 0.3, 1),
     ("h2", "h2", 0.3, 2), ("h2", "out", 0.5, 2), ("out", "h1", 0.3, 1)],
    1808, 5,
)
PLACED_STEPS = 64


def skip_and_loop():
    """The placed fixture: tiled network, report (parallel and serial
    projections alternate), assignment over four devices and spikes."""
    from repro_torch.core import (
        CompileReport, LIFParams, Population, SNNNetwork, SwitchingCompiler,
        random_projection,
    )
    from repro_torch.placement import (
        CoreGrid, build_device_assignment, round_robin_place, tile_network,
    )

    pop_spec, proj_spec, seed, budget = SKIP_AND_LOOP
    rng = np.random.default_rng(seed)
    pops = {n: Population(n, s) for n, s in pop_spec}
    projs = []
    for pre, post, density, delay_range in proj_spec:
        p = random_projection(
            pops[pre], pops[post], density, delay_range,
            seed=int(rng.integers(0, 2**31)),
            delay_granularity=rng.choice(["source", "synapse"]),
        )
        p.lif = LIFParams(alpha=0.5, v_th=64.0)
        projs.append(p)
    net = SNNNetwork(populations=list(pops.values()), projections=projs,
                     name="skip-and-loop")
    tiled = tile_network(net, max_neurons=budget)
    grid = CoreGrid(rows=4, cols=4)
    da = build_device_assignment(round_robin_place(tiled, grid), tiled, grid,
                                 n_devices=MESH_RANKS)
    tn = tiled.network
    report = CompileReport(layers=[
        SwitchingCompiler("serial" if i % 2 else "parallel").compile_layer(l)
        for i, l in enumerate(tn.layers)
    ])
    spikes = (rng.random((PLACED_STEPS, MICRO_BATCH, net.n_input)) < 0.3
              ).astype(np.float32)
    return tn, report, da, spikes


def mesh_paths(exe, x, vs=None):
    """Phase 12's launch paths of one executable."""
    return {"run_device": lambda: exe.run_device(x),
            "run_batched": lambda: exe.run_batched(x),
            "run_temporal": lambda: exe.run_temporal(x, valid_steps=vs)}


def host_arrays(outs):
    return [z.cpu().numpy() for z in outs]


def mesh_one_rank(card, kept):
    """Phase 12 (a): the 100k scaffold under a 1 x 1 mesh on a world of one
    NCCL rank, against phase 8's unsharded replies; timed in turns with
    the unsharded launch; no collective may run on the size-1 groups."""
    import torch.distributed as dist

    from repro_torch.core.runtime import (
        NetworkExecutable, network_executable, release_network_executable,
    )
    from repro_torch.distributed import exchange
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh

    n = max(SCAFFOLD_SIZES)
    net, rep, x8, want = kept[n]
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    store = MESH_DIR / "store_one"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    counts = {k: 0 for k in REPLACES}
    try:
        mesh = make_host_mesh()
        require(tuple(mesh.shape) == (1, 1), f"host mesh {tuple(mesh.shape)}")
        base = network_executable(net, rep, device=CARD)
        exe = NetworkExecutable.build(net, rep, device=CARD).shard(mesh=mesh)
        xs = torch.as_tensor(x8, device=CARD)
        plain, sharded = mesh_paths(base, xs), mesh_paths(exe, xs)
        for path, launch in sharded.items():
            if path not in want:
                print(f"mesh one rank [{card}]: {n} {path} skipped: phase 8 "
                      "refused it")
                continue
            reset_launch_counts()
            exchange.reset_exchange_counts()
            outs = launch()
            torch.cuda.synchronize()
            c, ex = launch_counts(), exchange.exchange_counts()
            for k in counts:
                counts[k] += c[k]
            require(bool(exe.last_check), f"mesh one rank {path}: last_check")
            got = host_arrays(outs)
            require(all(np.array_equal(a, b) for a, b in zip(got, want[path])),
                    f"mesh one rank {n} {path}: differs from phase 8's "
                    "unsharded replies")
            calls = sum(v["calls"] for v in ex.values())
            require(calls == 0, f"mesh one rank {path}: {calls} collectives on "
                    "size-1 groups")
            new, _, old, _ = in_turns(launch, plain[path], reps=5)
            steps = xs.shape[0]
            print(f"mesh one rank [{card}]: {n} {path} under make_host_mesh() "
                  f"(1 x 1, {exchange.transport(None)}): bitwise equal to phase "
                  f"8's unsharded replies; launches "
                  f"{ {k: v for k, v in c.items() if v} }; collectives a step "
                  f"{calls / steps:g}; host {new / steps * 1e3:.1f} us a step "
                  f"sharded against {old / steps * 1e3:.1f} unsharded (in turns, "
                  f"{new:.3f} against {old:.3f} ms a launch)")
        release_network_executable(rep)
        del base, exe
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return counts


def mesh_rank(rank, world, case_path, out_dir):
    """One rank of phase 12 (b): gloo over a FileStore, on the one card."""
    import pickle
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.core.runtime import NetworkExecutable
    from repro_torch.distributed import exchange, snn_mesh
    from repro_torch.distributed.sharding import is_sharded
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.event_scatter import event_scatter, event_scatter_ref
    from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
    from repro_torch.kernels.spike_wdm_matmul import (
        spike_wdm_project, spike_wdm_project_ref,
    )

    if CARD == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out_dir / "store"), world), rank=rank,
        world_size=world, timeout=timedelta(seconds=MESH_TIMEOUT_S // 2))
    with open(case_path, "rb") as fh:
        case = pickle.load(fh)
    res = {"rank": rank, "runs": [], "operands": []}

    def run(tag, exe, paths, want, steps):
        for path, launch in paths.items():
            reset_launch_counts()
            exchange.reset_exchange_counts()
            outs = launch()
            torch.cuda.synchronize()
            ex = exchange.exchange_counts()
            launches = {k: v for k, v in launch_counts().items() if v}
            got = host_arrays(outs)
            # a second launch, its operands built: host clock to a sync
            t0 = time.perf_counter()
            launch()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            res["runs"].append({
                "tag": tag, "path": path, "ms": ms, "steps": steps,
                "equal": bool(exe.last_check) and len(got) == len(want[path])
                and all(np.array_equal(a, b) for a, b in zip(got, want[path])),
                "launches": launches,
                "exchange": {k: v for k, v in ex.items() if v["calls"]},
                "halo_per_step": exe.halo_elements_per_step(MICRO_BATCH),
                "transport": exchange.transport(None, exe.device),
            })

    net, rep, x8, want = case["scaffold"]
    gnet, grep, xg, vg, gwant, grecord = case["gesture"]
    for data, model in MESH_SHAPES:
        mesh = snn_mesh(model_axis=model)
        tag = f"{data} x {model}"
        exe = NetworkExecutable.build(net, rep, device=CARD).shard(mesh=mesh)
        xs = torch.as_tensor(x8, device=CARD)
        paths = mesh_paths(exe, xs)
        paths.pop("run_temporal")            # refused at 10k, as on one card
        # every serial edge in the event form: each rank walks its slab of
        # rows with the kernel, and the partial updates are summed
        paths["run_device_event"] = lambda: exe.run_device(xs, serial_form="event")
        run(f"scaffold {tag}", exe, paths,
            dict(want, run_device_event=want["run_device"]), xs.shape[0])
        # every split K2/K3 operand this rank holds, at its own shape,
        # against the plain version on the card (not counted: after the runs)
        gen = torch.Generator(device=CARD).manual_seed(rank)
        for (i, kind), specs in sorted(exe._specs.items()):
            if not is_sharded(specs[0], mesh):
                continue
            m = exe.metas[i]
            if kind == "wdm":
                wdm, src, dly = exe.params[i]
                ring = (torch.rand((xs.shape[1] // data, m.ring_depth, m.n_source),
                                   device=CARD, generator=gen) < 0.2
                        ).to(torch.int8)
                ok = all(torch.equal(spike_wdm_project(wdm, src, dly, ring, t),
                                     spike_wdm_project_ref(wdm, src, dly, ring, t))
                         for t in range(m.ring_depth + 2))
                res["operands"].append(("spike_wdm_project", tag, i,
                                        tuple(wdm.shape), ok))
            elif kind == "rows" and (i, kind) in exe._operands:
                *rows, row_ptr = exe._operands[(i, kind)]
                x = (torch.rand((xs.shape[1] // data, m.n_source), device=CARD,
                                generator=gen) < 0.2).float()
                kw = dict(d_slots=m.delay_range + 1, n_target=m.n_target)
                ok = all(torch.equal(event_scatter(*rows, row_ptr, x, t, **kw),
                                     event_scatter_ref(*rows, x, t, **kw))
                         for t in range(m.delay_range + 2))
                res["operands"].append(("event_scatter", tag, i,
                                        tuple(rows[0].shape), ok))
            elif kind == "sparse":
                val, idx = exe._operands[(i, kind)]
                x = (torch.rand((xs.shape[1] // data, m.n_source), device=CARD,
                                generator=gen) < 0.2).float().t()
                ok = torch.equal(sparse_gather(val, idx, x),
                                 sparse_gather_ref(val, idx, x))
                res["operands"].append(("sparse_gather", tag, i,
                                        tuple(val.shape), ok))
        gexe = NetworkExecutable.build(gnet, grep, device=CARD).shard(mesh=mesh)
        gx, gv = torch.as_tensor(xg, device=CARD), torch.as_tensor(vg, device=CARD)
        run(f"gesture {tag}", gexe, {"run_temporal": mesh_paths(gexe, gx, gv)[
            "run_temporal"]}, gwant, gx.shape[0])
        res["runs"][-1]["record"] = grep.temporal[(MICRO_BATCH, gx.shape[0])
                                                  ].as_dict() == grecord
    tn, trep, da, spikes, twant = case["placed"]
    exe = NetworkExecutable.build(tn, trep, device=CARD).shard(assignment=da)
    xs = torch.as_tensor(spikes, device=CARD)
    run("skip-and-loop assignment", exe, mesh_paths(exe, xs), twant, xs.shape[0])
    res["owned"] = [i for i, p in enumerate(exe.params) if p is not None]
    with open(out_dir / f"rank{rank}.json", "w") as fh:
        json.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()


def mesh_four_ranks(card, kept, gesture):
    """Phase 12 (b): four gloo ranks on the one card, every operand of a
    rank on ``cuda:0`` and each collective through a host buffer: the 10k
    scaffold over meshes 4 x 1 and 2 x 2 (run_device, run_batched), the
    gesture network's run_temporal over the same meshes, and the placed
    skip-and-loop fixture through shard(assignment=); every rank's trains
    against the one-card run."""
    import pickle

    from repro_torch.core.runtime import (
        network_executable, release_network_executable,
    )

    t0 = time.perf_counter()
    n = min(SCAFFOLD_SIZES)
    net, rep, x8, served = kept[n]
    gnet, grep, (xg, vg) = gesture
    gexe = network_executable(gnet, grep, device=CARD)
    gwant = {"run_temporal": host_arrays(gexe.run_temporal(xg, valid_steps=vg))}
    grecord = grep.temporal[(MICRO_BATCH, xg.shape[0])].as_dict()
    tn, trep, da, spikes = skip_and_loop()
    summary = da.summary()
    require((len(da.tile_device), len(da.proj_device), len(da.halo),
             da.halo_bits_per_step()) == (9, 36, 28, 168),
            f"skip-and-loop plan {summary}")
    texe = network_executable(tn, trep, device=CARD)
    twant = {k: host_arrays(f()) for k, f in mesh_paths(texe, torch.as_tensor(
        spikes, device=CARD)).items()}
    for r in (rep, grep, trep):
        release_network_executable(r)
    out_dir = MESH_DIR / "four"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()
    case_path = out_dir / "case.pkl"
    with open(case_path, "wb") as fh:
        pickle.dump({"scaffold": (net, rep, x8, served),
                     "gesture": (gnet, grep, xg, vg, gwant, grecord),
                     "placed": (tn, trep, da, spikes, twant)}, fh)
    print(f"mesh four ranks [{card}]: case written in "
          f"{time.perf_counter() - t0:.1f} s; skip-and-loop plan {summary}")
    ctx = get_context("spawn")
    procs = [ctx.Process(target=mesh_rank,
                         args=(r, MESH_RANKS, case_path, out_dir))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    require(codes == [0] * MESH_RANKS, f"mesh four ranks: exit codes {codes}")
    ranks = []
    for r in range(MESH_RANKS):
        with open(out_dir / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    by_run = {}
    for res in ranks:
        for row in res["runs"]:
            by_run.setdefault((row["tag"], row["path"]), []).append(row)
    pairs = {(h.pre, h.dst_device): h.n_bits for h in da.halo}
    for (tag, path), rows in by_run.items():
        require(all(r["equal"] for r in rows),
                f"mesh four ranks {tag} {path}: ranks {[r['equal'] for r in rows]} "
                "equal to the one-card run")
        if "record" in rows[0]:
            require(all(r["record"] for r in rows),
                    f"mesh four ranks {tag}: run_temporal's record differs")
        for r in rows:
            l = r["launches"]
            require(l.get("lif_step", 0) > 0 or path == "run_temporal",
                    f"mesh four ranks {tag} {path}: no lif_step launched")
        if tag.startswith("skip-and-loop"):
            sent = sum(r["exchange"].get("send", {}).get("elements", 0)
                       for r in rows)
            per_step = MICRO_BATCH * sum(pairs.values())
            require(sent == PLACED_STEPS * per_step
                    and all(r["halo_per_step"] == per_step for r in rows),
                    f"mesh four ranks {tag} {path}: {sent} halo elements sent, "
                    f"the plan's {per_step} a step")
        print(f"mesh four ranks [{card}]: {tag} {path}: every rank bitwise equal "
              f"to the one-card run ({rows[0]['transport']}); per rank: "
              + "; ".join(
                  f"r{k} {r['ms']:.1f} ms ({r['ms'] / r['steps'] * 1e3:.0f} us a "
                  f"step), launches {r['launches']}, collectives "
                  f"{ {op: (v['calls'], v['elements']) for op, v in r['exchange'].items()} }"
                  for k, r in enumerate(rows)))
    ops = [tuple(o) for res in ranks for o in res["operands"]]
    require(ops and all(o[-1] for o in ops),
            f"mesh four ranks: sharded operands that differ from their plain "
            f"versions: {[o for o in ops if not o[-1]]}")
    shapes = sorted({(o[0], tuple(o[3])) for o in ops})
    print(f"mesh four ranks [{card}]: {len(ops)} sharded K2/K3/event-form "
          "operand slabs "
          f"bitwise equal to their plain versions, shapes {shapes}; skip-and-loop "
          f"halo {MICRO_BATCH * sum(pairs.values())} elements a step "
          f"({len(pairs)} (pre, dst_device) rows of the plan's {len(da.halo)} "
          f"edges); projections by rank {[len(r['owned']) for r in ranks]}; "
          f"{time.perf_counter() - t0:.1f} s in all")


def mesh_phase(card, kept, gesture):
    """Phase 12: (a) one NCCL rank at full width, (b) four gloo ranks on the
    one card.  Returns the launch counts of (a)'s main path."""
    counts = mesh_one_rank(card, kept)
    mesh_four_ranks(card, kept, gesture)
    return counts


# -- 13. the language models over a mesh of ranks -------------------------------
LM_MESH_DIR = Path(__file__).resolve().parent / "build" / "lm_mesh"
#: (b): mamba2-130m at full width over four ranks, its train batch (f32)
#: and its prompt (prefill, then LM_MESH_DECODE greedy steps)
LM_MESH_SHAPES = ((2, 2), (4, 1), (1, 4))
LM_MESH_TRAIN, LM_MESH_PROMPT, LM_MESH_DECODE = (8, 256), (8, 256), 4
#: (b): smoke configs over 2 x 2: (tag, arch, MoE dispatch)
LM_MESH_SMOKE = (("olmoe-1b-7b sort", "olmoe-1b-7b", "sort"),
                 ("olmoe-1b-7b local", "olmoe-1b-7b", "local"),
                 ("recurrentgemma-2b", "recurrentgemma-2b", None),
                 ("qwen3-8b", "qwen3-8b", None))
#: (a): recurrentgemma-2b bf16 prefill and decode on the 1 x 1 mesh
LM_MESH_RG = (4, 1024, 8)


def close_share(got, want):
    """lm_close's rule without raising: (within, max |diff|, share of scale)."""
    got, want = got.detach().double(), want.detach().double().to(got.device)
    scale = float(want.abs().max())
    diff = (got - want).abs()
    ok = bool((diff <= 1e-4 * want.abs() + 1e-4 * scale).all()) and bool(
        torch.isfinite(got).all())
    err = float(diff.max()) if diff.numel() else 0.0
    return ok, err, err / max(scale, 1e-30)


def worst_of(pairs):
    """(all within, worst share, worst abs) over (got, want) pairs."""
    res = [close_share(g, w) for g, w in pairs]
    return (all(r[0] for r in res), max(r[2] for r in res), max(r[1] for r in res))


def card_params(cfg, seed, device):
    """Random weights drawn on ``device`` from ``seed`` (the CPU draw of a
    3B-parameter model takes ~30 s): norms one, every other leaf normal
    times 0.02 (the init's scale; the comparisons hold two routes to the
    same weights, whatever they are)."""
    from repro_torch.models import init as minit
    from repro_torch.tree import flatten_with_keys, unflatten_like

    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = minit.param_shapes(cfg, device="meta")
    out = []
    for key, t in flatten_with_keys(shapes):
        name = key.split("/")[-1].split(".")[-1]
        if name.startswith(("ln", "gn")) or name.endswith("norm"):
            out.append(torch.ones(t.shape, dtype=t.dtype, device=device))
        else:
            out.append((torch.randn(t.shape, generator=gen, device=device) * 0.02
                        ).to(t.dtype))
    return unflatten_like(shapes, out)


def placed(cfg, mesh, rules, params, state=None, batch=None, device=None):
    """The DTensor blocks of a step's arguments under the sharding trees."""
    from repro_torch.distributed import sharding as PS
    from repro_torch.launch import steps

    out = [PS.shard_tree(params, steps.param_shardings(cfg, mesh, rules), device)]
    if state is not None:
        out.append(PS.shard_tree(state, steps.opt_shardings(cfg, mesh, rules), device))
    if batch is not None:
        out.append(PS.shard_tree(batch, {
            k: PS.NamedSharding(mesh, PS.spec_for_shape(steps.BATCH_AXES[k], rules,
                                                        v.shape, mesh))
            for k, v in batch.items()}, device))
    return out


def lm_mesh_one_rank(card):
    """Phase 13 (a): a world of one NCCL rank and the 1 x 1 mesh at full
    width.  mamba2-130m's f32 train step (batch TRAIN_F32) through
    shard_tree and DTensor against the unsharded step on the card: loss,
    every gradient leaf, the updated parameters and moments within
    lm_close, and as many K5 launches; its bf16 step (TRAIN_RUN's batch)
    timed in turns with the unsharded one; recurrentgemma-2b's bf16
    prefill and decode the same way.  Returns the K5 launches of the
    sharded path."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as PS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init as minit, model as lm
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.tree import leaves

    LM_MESH_DIR.mkdir(parents=True, exist_ok=True)
    store = LM_MESH_DIR / "store_one"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1)
    k5 = 0
    try:
        mesh, rules = make_host_mesh(), PS.make_rules()
        require(tuple(mesh.shape) == (1, 1), f"host mesh {tuple(mesh.shape)}")
        # (1) the f32 train step and its gradients
        cfg = dataclasses.replace(get_config("mamba2-130m"), dtype="float32")
        host = minit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        params = minit.tree_to(host, CARD)
        batch = {k: v.to(CARD) for k, v in train_batch(cfg, *TRAIN_F32, seed=0).items()}
        step = steps.make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=3))
        reset_launch_counts()
        want = step(params, init_state(params), batch)
        torch.cuda.synchronize()
        k5_plain = launch_counts()["ssd_chunk"]
        w_loss, w_grads = lm.value_and_grad(params, cfg, batch)
        dp, ds, db = placed(cfg, mesh, rules, params, init_state(params), batch)
        with PS.sharding_ctx(mesh, rules):
            reset_launch_counts()
            got = step(dp, ds, db)
            torch.cuda.synchronize()
            k5_mesh = launch_counts()["ssd_chunk"]
            g_loss, g_grads = lm.value_and_grad(dp, cfg, db)
        k5 += k5_mesh
        got, g_grads, g_loss = PS.gather_tree((got, g_grads, g_loss))
        ok, rel, err = worst_of(
            [(g_loss, w_loss), (got[2]["loss"], want[2]["loss"])]
            + list(zip(leaves(g_grads), leaves(w_grads)))
            + list(zip(leaves(got[:2]), leaves(want[:2]))))
        require(ok, f"mesh 1 x 1 mamba2 f32: the sharded step differs from the "
                f"unsharded one (worst share {rel:.3e})")
        require(k5_mesh == k5_plain == 2 * cfg.n_layers,
                f"mesh 1 x 1 mamba2 f32: K5 launched {k5_mesh} times, the "
                f"unsharded step {k5_plain}, not {2 * cfg.n_layers}")
        print(f"lm mesh one rank [{card}]: mamba2-130m f32 (full width, remat) "
              f"batch {TRAIN_F32[0]} x {TRAIN_F32[1]} over make_host_mesh() (1 x 1, "
              f"nccl) against the unsharded step on the card: loss, every "
              f"gradient leaf, the updated parameters and both moments within "
              f"lm_close (worst {rel:.3e} of scale, max abs {err:.3e}); K5 "
              f"launches {k5_mesh} sharded, {k5_plain} unsharded")
        del params, dp, ds, db, got, want, g_grads, w_grads
        # (2) the bf16 step timed in turns with the unsharded one
        cfg = get_config("mamba2-130m")
        run = TRAIN_RUN
        params = minit.init_params(cfg, torch.Generator().manual_seed(0), CARD)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=run["seq"],
                                      global_batch=run["batch"]))
        batch = {k: torch.as_tensor(v, device=CARD) for k, v in data.batch_at(0).items()}
        step = steps.make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=30))
        plain_state = [params, init_state(params)]
        mesh_state = placed(cfg, mesh, rules, params, init_state(params))
        db = placed(cfg, mesh, rules, params, batch=batch)[1]

        def plain_step():
            plain_state[0], plain_state[1], m = step(*plain_state, batch)
            return float(m["loss"])

        def mesh_step():
            with PS.sharding_ctx(mesh, rules):
                mesh_state[0], mesh_state[1], m = step(*mesh_state, db)
            return float(PS.gather_tree(m["loss"]))

        reset_launch_counts()
        mesh_step()
        torch.cuda.synchronize()
        k5 += launch_counts()["ssd_chunk"]
        new, new_ab, old, old_ab = in_turns(mesh_step, plain_step, reps=3)
        rows = {}
        for name, fn in (("sharded", mesh_step), ("unsharded", plain_step)):
            torch.cuda.reset_peak_memory_stats()
            total, n, _, _, _ = train_profile(fn)
            rows[name] = (total, n, torch.cuda.max_memory_allocated())
        tokens = run["batch"] * run["seq"]
        for name, ms, ab in (("sharded", new, new_ab), ("unsharded", old, old_ab)):
            total, n, peak = rows[name]
            print(f"lm mesh one rank timing [{card}]: mamba2-130m bf16 batch "
                  f"{run['batch']} x {run['seq']} (remat) {name}: {ms:.3f} ms a step "
                  f"(host clock to a sync, in turns {ab[0]:.3f}, {ab[1]:.3f}), "
                  f"{tokens * 1e3 / ms:.1f} tokens/s; device {total:.3f} ms in {n} "
                  f"launches, busy share {total / ms:.3f}; peak device memory "
                  f"{peak / 2**30:.3f} GiB")
        print(f"lm mesh one rank timing [{card}]: the 1 x 1 mesh's step takes "
              f"{new / old:.3f} of the unsharded step's host time")
        del params, plain_state, mesh_state, db, batch
        torch.cuda.empty_cache()
        # (3) recurrentgemma-2b bf16: prefill and decode
        cfg = get_config("recurrentgemma-2b")
        b, s, n_dec = LM_MESH_RG
        params = card_params(cfg, 0, CARD)
        batch = {k: v.to(CARD) for k, v in lm_batch(cfg, b, s, seed=0).items()}
        cache_len = s + n_dec
        (dp, db) = placed(cfg, mesh, rules, params, batch=batch)
        with torch.no_grad():
            reset_launch_counts()
            w_logits, w_caches = lm.prefill(params, cfg, batch, cache_len)
            with PS.sharding_ctx(mesh, rules):
                g_logits, g_caches = lm.prefill(dp, cfg, db, cache_len)
            pairs = [(PS.gather_tree(g_logits), w_logits)]
            pairs += list(zip(leaves(PS.gather_tree(g_caches)), leaves(w_caches)))
            tok = w_logits[:, -1].float().argmax(-1)[:, None]
            w_c, g_c = w_caches, g_caches
            for i in range(n_dec):
                wl, w_c = lm.decode_step(params, cfg, tok, s + i, w_c, cache_len)
                with PS.sharding_ctx(mesh, rules):
                    gl, g_c = lm.decode_step(dp, cfg, PS.shard_tree(
                        {"tokens": tok}, placed_tokens(mesh, rules, tok))["tokens"],
                        s + i, g_c, cache_len)
                pairs.append((PS.gather_tree(gl), wl))
                tok = wl[:, -1].float().argmax(-1)[:, None]
            ok, rel, err = worst_of(pairs)
            require(ok, f"mesh 1 x 1 recurrentgemma-2b bf16: sharded prefill or "
                    f"decode differs (worst share {rel:.3e})")

            def pre_plain():
                return lm.prefill(params, cfg, batch, cache_len)

            def pre_mesh():
                with PS.sharding_ctx(mesh, rules):
                    return lm.prefill(dp, cfg, db, cache_len)

            d_tok = PS.shard_tree({"tokens": tok}, placed_tokens(mesh, rules, tok))["tokens"]

            def dec_plain():
                return lm.decode_step(params, cfg, tok, s, w_caches, cache_len)

            def dec_mesh():
                with PS.sharding_ctx(mesh, rules):
                    return lm.decode_step(dp, cfg, d_tok, s, g_caches, cache_len)

            p_new, _, p_old, _ = in_turns(pre_mesh, pre_plain, reps=3)
            d_new, _, d_old, _ = in_turns(dec_mesh, dec_plain, reps=8)
            prof = {k: profiled_ms(f)[:2] for k, f in (
                ("pre_mesh", pre_mesh), ("pre_plain", pre_plain),
                ("dec_mesh", dec_mesh), ("dec_plain", dec_plain))}
        print(f"lm mesh one rank [{card}]: recurrentgemma-2b bf16 prefill (batch "
              f"{b} x {s}) and {n_dec} greedy decode steps over the 1 x 1 mesh "
              f"against the unsharded run: logits and caches within lm_close "
              f"(worst {rel:.3e} of scale, max abs {err:.3e})")
        for what, new, old, km, kp in (("prefill", p_new, p_old, "pre_mesh", "pre_plain"),
                                       ("decode step", d_new, d_old, "dec_mesh", "dec_plain")):
            print(f"lm mesh one rank timing [{card}]: recurrentgemma-2b bf16 {what}: "
                  f"sharded {new:.3f} ms (device {prof[km][0]:.3f} ms in "
                  f"{prof[km][1]} launches, busy {prof[km][0] / new:.3f}), unsharded "
                  f"{old:.3f} ms (device {prof[kp][0]:.3f} ms in {prof[kp][1]} "
                  f"launches, busy {prof[kp][0] / old:.3f}); ratio {new / old:.3f}")
        del params, dp, db, w_caches, g_caches, w_c, g_c
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"ssd_chunk": k5}


def placed_tokens(mesh, rules, tok):
    from repro_torch.distributed import sharding as PS
    return {"tokens": PS.NamedSharding(mesh, PS.spec_for_shape(
        ("batch", None), rules, tok.shape, mesh))}


def lm_mesh_case(name, cfg, mesh, rules, batch, prompt, n_dec, device):
    """One case on this rank, over ``mesh`` and unsharded on the same card:
    the loss and every gradient leaf; the train step's loss and moments;
    its updated parameters against one AdamW update of the same (gathered)
    gradients on one card (independent steps are not compared: Adam's
    first step moves an element by about +-lr, so a gradient near 0 whose
    sign differs moves it by 2 lr); a prefill and ``n_dec`` decode
    steps.  Returns (within, worst share by part, K5 launches and
    collectives of the sharded train step)."""
    from repro_torch.distributed import exchange, sharding as PS, staged
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.models import init as minit, model as lm
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.tree import leaves

    opt = AdamWConfig(warmup_steps=1, total_steps=3)
    params = minit.init_params(cfg, torch.Generator().manual_seed(0), device=device)
    step = steps.make_train_step(cfg, opt)
    want = step(params, init_state(params), batch)
    w_loss, w_grads = lm.value_and_grad(params, cfg, batch)
    dp, ds, db = placed(cfg, mesh, rules, params, init_state(params), batch)
    staged.reset_calls()
    exchange.reset_exchange_counts()
    reset_launch_counts()
    t0 = time.perf_counter()
    with PS.sharding_ctx(mesh, rules):
        got = step(dp, ds, db)
        on_card = blocks_on(got[:2], device)
        got = PS.gather_tree(got)
    if device != "cpu":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    k5 = launch_counts()["ssd_chunk"]
    calls = {k: tuple(v) for k, v in staged.CALLS.items()}
    with PS.sharding_ctx(mesh, rules):
        g_loss, g_grads = lm.value_and_grad(dp, cfg, db)
        upd = PS.gather_tree(apply_updates(dp, g_grads, ds, opt)[:2])
        g_loss, g_grads = PS.gather_tree((g_loss, g_grads))
    same = apply_updates(params, g_grads, init_state(params), opt)
    parts = {
        "loss and gradients": [(g_loss, w_loss), (got[2]["loss"], want[2]["loss"])]
        + list(zip(leaves(g_grads), leaves(w_grads))),
        "moments": list(zip(leaves((got[1].m, got[1].v)),
                            leaves((want[1].m, want[1].v)))),
        "update of the same gradients": list(zip(leaves(upd), leaves(same[:2]))),
        "prefill and decode": []}
    cache_len = prompt["tokens"].shape[1] + n_dec
    (db_p,) = placed(cfg, mesh, rules, params, batch=prompt)[1:]
    with torch.no_grad():
        w_logits, w_c = lm.prefill(params, cfg, prompt, cache_len)
        with PS.sharding_ctx(mesh, rules):
            g_logits, g_c = lm.prefill(dp, cfg, db_p, cache_len)
        pd = parts["prefill and decode"]
        pd.append((PS.gather_tree(g_logits), w_logits))
        pd += list(zip(leaves(PS.gather_tree(g_c)), leaves(w_c)))
        tok = w_logits[:, -1].float().argmax(-1)[:, None]
        s = prompt["tokens"].shape[1]
        for i in range(n_dec):
            wl, w_c = lm.decode_step(params, cfg, tok, s + i, w_c, cache_len)
            with PS.sharding_ctx(mesh, rules):
                d_tok = PS.shard_tree({"tokens": tok}, placed_tokens(mesh, rules, tok))
                gl, g_c = lm.decode_step(dp, cfg, d_tok["tokens"], s + i, g_c, cache_len)
            pd.append((PS.gather_tree(gl), wl))
            tok = wl[:, -1].float().argmax(-1)[:, None]
        pd += list(zip(leaves(PS.gather_tree(g_c)), leaves(w_c)))
    shares = {k: worst_of(v) for k, v in parts.items()}
    ok = all(v[0] for v in shares.values())
    return {"case": name, "ok": ok and on_card, "on_card": on_card,
            "rel": max(v[1] for v in shares.values()),
            "err": max(v[2] for v in shares.values()),
            "parts": {k: v[1] for k, v in shares.items()}, "k5": k5,
            "calls": calls, "exchange": {k: v for k, v in exchange.exchange_counts().items()
                                         if v["calls"]}, "train_ms": ms}


def blocks_on(tree, device) -> bool:
    """Does every DTensor leaf of ``tree`` hold its block on ``device``
    (DTensor moves a block to its mesh's device type)?"""
    from repro_torch.tree import leaves

    want = torch.device(device).type
    return all(t.to_local().device.type == want for t in leaves(tree)
               if hasattr(t, "to_local"))


def lm_mesh_compressed(cfg, batch, device):
    """make_train_step_compressed over (pod 2, data 1, model 2) on this
    rank against its oracle on the card: each pod's gradient summed in
    full precision (the reference's sum over pods), the loss averaged, one
    AdamW step; the loss within lm_close and every element of m within
    (1 - b1) of one int8 quantum of its leaf's shared scale."""
    from repro_torch.distributed import sharding as PS, staged
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init as minit, model as lm
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.tree import leaves, unflatten_like

    opt = AdamWConfig(warmup_steps=1, total_steps=3)
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    rules = PS.make_rules(multi_pod=True)
    params = minit.init_params(cfg, torch.Generator().manual_seed(0), device=device)
    half = batch["tokens"].shape[0] // 2
    pods = [lm.value_and_grad(params, cfg, {k: v[sl] for k, v in batch.items()})
            for sl in (slice(0, half), slice(half, None))]
    g_sum = unflatten_like(pods[0][1], [a + b for a, b in zip(leaves(pods[0][1]),
                                                              leaves(pods[1][1]))])
    _, w_opt, _ = apply_updates(params, g_sum, init_state(params), opt)
    w_loss = (pods[0][0] + pods[1][0]) / 2
    scales = [max(float(a.abs().max()), float(b.abs().max())) / 127.0
              for a, b in zip(leaves(pods[0][1]), leaves(pods[1][1]))]
    dp, ds, db = placed(cfg, mesh, rules, params, init_state(params), batch)
    staged.reset_calls()
    reset_launch_counts()
    p2, o2, met = steps.make_train_step_compressed(cfg, opt, mesh, n_pods=2)(dp, ds, db)
    k5 = launch_counts()["ssd_chunk"]
    on_card = blocks_on((p2, o2), device)
    m_got = leaves(PS.gather_tree(o2.m))
    worst = max(float((g - w.to(g.device)).abs().max())
                / ((1 - opt.b1) * max(sc, 1e-12))
                for g, w, sc in zip(m_got, leaves(w_opt.m), scales))
    ok, rel, err = close_share(met["loss"], w_loss)
    return {"case": "compressed (pod 2, data 1, model 2)",
            "ok": ok and worst <= 1.001 and on_card, "on_card": on_card,
            "rel": rel, "err": err, "quanta": worst, "k5": k5,
            "calls": {k: tuple(v) for k, v in staged.CALLS.items()}}


def lm_mesh_rank(rank, world, out_dir):
    """One rank of phase 13 (b): every collective host-staged on the one
    card (``cpu:gloo,cuda:staged``); the cases' results to a JSON file."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.distributed import sharding as PS, staged
    from repro_torch.launch.mesh import make_host_mesh

    device = CARD
    if CARD == "cuda":
        torch.cuda.set_device(0)
        staged.register()
        backend = "cpu:gloo,cuda:staged"
    else:
        staged.register(devices=("cpu",))
        backend = "cpu:staged"
    dist.init_process_group(backend, store=dist.FileStore(str(out_dir / "store"), world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=MESH_TIMEOUT_S // 2))
    res = {"rank": rank, "backend": dist.get_backend(), "cases": []}
    full = dataclasses.replace(get_config("mamba2-130m"), dtype="float32")
    batch = {k: v.to(device) for k, v in
             train_batch(full, *LM_MESH_TRAIN, seed=0).items()}
    prompt = {k: v.to(device) for k, v in
              lm_batch(full, *LM_MESH_PROMPT, seed=1).items()}
    for data, model in LM_MESH_SHAPES:
        mesh = make_host_mesh(model)
        row = lm_mesh_case(f"mamba2-130m f32 {data} x {model}", full, mesh,
                           PS.make_rules(), batch, prompt, LM_MESH_DECODE, device)
        res["cases"].append(row)
    for tag, arch, dispatch in LM_MESH_SMOKE:
        cfg = smoke_config(arch)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0, dispatch=dispatch))
        sb = {k: v.to(device) for k, v in train_batch(cfg, 8, 64, seed=0).items()}
        sp = {k: v.to(device) for k, v in lm_batch(cfg, 8, 64, seed=1).items()}
        res["cases"].append(lm_mesh_case(f"{tag} smoke 2 x 2", cfg, make_host_mesh(2),
                                         PS.make_rules(), sb, sp, LM_MESH_DECODE,
                                         device))
    res["cases"].append(lm_mesh_compressed(full, batch, device))
    with open(out_dir / f"rank{rank}.json", "w") as fh:
        json.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()


def lm_mesh_four_ranks(card):
    """Phase 13 (b): four ranks on the one card (NCCL refuses two ranks on
    one card: every collective host-staged); every rank's gathered outputs
    of every case against the unsharded step on the card."""
    t0 = time.perf_counter()
    out_dir = LM_MESH_DIR / "four"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()
    ctx = get_context("spawn")
    procs = [ctx.Process(target=lm_mesh_rank, args=(r, MESH_RANKS, out_dir))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + MESH_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    require(codes == [0] * MESH_RANKS, f"lm mesh four ranks: exit codes {codes}")
    ranks = []
    for r in range(MESH_RANKS):
        with open(out_dir / f"rank{r}.json") as fh:
            ranks.append(json.load(fh))
    for i, row in enumerate(ranks[0]["cases"]):
        rows = [res["cases"][i] for res in ranks]
        name = row["case"]
        require(all(r["on_card"] for r in rows),
                f"lm mesh four ranks {name}: a rank's blocks left the card")
        require(all(r["ok"] for r in rows),
                f"lm mesh four ranks {name}: ranks within the tolerance "
                f"{[r['ok'] for r in rows]} (worst shares {[r['rel'] for r in rows]}"
                + (f", quanta {[r['quanta'] for r in rows]})" if "quanta" in row
                   else f", by part {[r['parts'] for r in rows]})"))
        if name.startswith("mamba2") or name.startswith("compressed"):
            require(all(r["k5"] > 0 for r in rows),
                    f"lm mesh four ranks {name}: K5 launches {[r['k5'] for r in rows]}")
        rule = (f"m within {max(r['quanta'] for r in rows):.3f} of (1 - b1) one int8 "
                "quantum, loss within lm_close" if "quanta" in row else
                f"within lm_close of the unsharded step (worst share of scale "
                + ", ".join(f"{k} {max(r['parts'][k] for r in rows):.3e}"
                            for k in row["parts"]) + ")")
        print(f"lm mesh four ranks [{card}]: {name}: every rank {rule} "
              f"({ranks[0]['backend']}); per rank: " + "; ".join(
                  f"r{k} K5 {r['k5']}, collectives "
                  f"{ {op: (c, b) for op, (c, b) in r['calls'].items()} }"
                  + (f", train step {r['train_ms']:.0f} ms" if "train_ms" in r else "")
                  for k, r in enumerate(rows)))
    print(f"lm mesh four ranks [{card}]: {len(ranks[0]['cases'])} cases in "
          f"{time.perf_counter() - t0:.1f} s")


def lm_mesh_phase(card):
    """Phase 13: (a) one NCCL rank at full width, (b) four ranks on the
    card.  Returns the K5 launches of (a)'s sharded path."""
    counts = lm_mesh_one_rank(card)
    lm_mesh_four_ranks(card)
    return counts


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
        # the package's count (ssd_chunk_cost, which the dry run books too):
        # each operand read once (B and C once per group), y and the state
        # written once; the scores C.B^T once a group over j <= i, the
        # decayed scores times X a head, and the state's; each product runs
        # as three TF32 products (3xTF32)
        from repro_torch.kernels.ssd_chunk import ssd_chunk_cost

        g, q, h, p, n, hg = shape
        ops = ssd_inputs(shape, seed)
        pairs = q * (q + 1) // 2
        flops, n_bytes = ssd_chunk_cost(g, q, h, p, n, hg)
        per_head = g * h * (pairs * (2 * n + 2 * p) + 2 * q * n * p)
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
        "ssd_chunk": [((16, 256, 24, 64, 128, 1), 1), ((1, 256, 24, 64, 128, 1), 1),
                      ((16, 256, 24, 64, 128, 24), 1)],
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
                val, idx = exe._form_operands(i, "sparse")
                ell.append((val, idx, meta.n_source))
    return sorted(lif), sorted(wdm), ell, par, sorted(step)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this test needs the card",
              file=sys.stderr)
        return 1
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
    # 11. the dry run's sweep needs no card: it runs beside phases 1-10 in
    # daemonic processes (ended with the script whatever happens)
    dry_started = dryrun_start()

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
    _, host32, steps32, greedy32, ssd_launches = serve_mamba2_f32()
    measured = {}

    for name, rep in reports.items():
        time_serving(net, name, rep, batches[0], card)
        time_temporal(net, name, rep, batches[1], card)
    time_engine(net, reports, engine, traffic, e_stats, e_rps, card)
    measured["mamba2-130m prefill"] = serve_mamba2_bf16(card, host32, steps32, greedy32)

    lap("8. the cerebellum scaffold")
    # 8. the cerebellum scaffold at 10k and 100k neurons, its paths' counts
    # read around each path alone
    s_counts, s_json, s_kept = scaffold_phase(card)

    lap("9. serve the attention, recurrent and MoE archs")
    # 9. the other nine archs: smoke configs, recurrentgemma-2b at full
    # width, olmoe-1b-7b at full width and 4 layers
    measured.update(lm_phase(card))

    lap("10. train mamba2-130m")
    # 10. the training path: K5's gradient, every arch's train step against
    # the CPU, then train.main in bf16 (K5 counted around it alone)
    train_launches, train_k5, measured["mamba2-130m train"] = train_phase(card)

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
    # K5: the served prefill's launches and train.main's; its row at the
    # train step's shape (the prefill's is printed beside it)
    launches["ssd_chunk"] += ssd_launches + train_launches
    path["ssd_chunk"] = (TRAIN_SSD_SHAPES[0], 0)
    rows = kernel_rows(path, err, launches, card, temporal_gather,
                       max(x.shape[0] for x, _ in batches), fps[1:])
    # K5's gradient is plain PyTorch (the reference's is XLA's autodiff)
    next(r for r in rows if r["name"] == "ssd_chunk")["plain_backward_ms"] = \
        train_k5["backward_ms"]

    lap("11. the dry run")
    # 11. the dry run: the sweep's records, and the measured cells' bounds
    dryrun_phase(card, dry_started, measured)

    lap("12. the SNN over a mesh of ranks")
    # 12. (a) the 100k scaffold under a 1 x 1 mesh on one NCCL rank, its
    # counts read around its paths alone; (b) four gloo ranks on the card
    m_counts = mesh_phase(card, s_kept, (net, reports["classifier"], batches[1]))
    for row in rows:
        row["launches"] += m_counts.get(row["name"], 0)

    lap("13. the language models over a mesh of ranks")
    # 13. (a) mamba2-130m and recurrentgemma-2b under a 1 x 1 mesh on one
    # NCCL rank, K5 counted around the sharded path; (b) four ranks on the card
    lm_counts = lm_mesh_phase(card)
    for row in rows:
        row["launches"] += lm_counts.get(row["name"], 0)

    lap("14. the event form's kernel")
    # 14. the event-driven scatter against the sweep on the microcircuit's
    # largest event-form projection; its launches are phase 8's and 12's
    event_row = event_phase(card)
    event_row["launches"] = launches["event_scatter"] + m_counts.get(
        "event_scatter", 0)
    rows.append(event_row)

    lap("15. K2's two designs")
    # 15. K2's streamed design at the microcircuit's maps and the scaffold's,
    # against the latency design, and the threshold's sweep
    rows += wdm_phase(card)
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
