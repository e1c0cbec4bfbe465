#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; exits non-zero, printing no result, without them.  Three phases,
none of which is caught and swallowed:

1. **Build.**  Compile the three CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together), print the card's name
   and power limit, and hold each kernel against its plain PyTorch version
   on the card: the LIF update bitwise on ``v`` and ``z`` with
   ``alpha`` in {0.5, 0.9}, the int8 WDM matmul and the ELL gather exactly,
   at the gesture path's shapes and at the shapes of the reference
   package's kernel tests and kernel benchmark.
2. **Compile.**  Train AdaBoost on a reduced paradigm-dataset grid that
   holds the gesture regime, and compile the paper's gesture network
   (2048-20-4, density 0.0316, §IV-C) under ``classifier``, ``serial``
   and ``parallel``.
3. **Serve.**  Sixteen seeded requests (25-75 steps, widths 2048/1536/1024
   zero-padded to 2048, rate 0.2) as two padded micro-batches of 8 through
   ``network_executable(...).run_device(..., valid_steps=...)`` for each
   report.  Every reply must equal, bit for bit, the request run alone at
   batch 1 on the card, the port on the CPU, and ``run_graph_reference``.

Earlier lines print the kernels' launch counts on the served path, their
times (CUDA events) beside the plain versions' and a library call's, and
the served micro-batch's time per step.  The line before the last is the
``kernels`` JSON object; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): device
# memory bytes/s, int8 tensor-core ops/s, f32 (non-tensor-core) flop/s.
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
F32_OPS_S = 67e12

N_INPUT = 2048
MICRO_BATCH = 8
REPLACES = {
    "lif_update": "src/repro/kernels/lif_update/kernel.py:41",
    "spike_wdm_matmul": "src/repro/kernels/spike_wdm_matmul/kernel.py:54",
    "sparse_gather": "src/repro/kernels/sparse_gather/kernel.py:48",
}


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


def ell_inputs(r, lanes, s, b, seed):
    """Ragged ELL rows: each row keeps a random number of lanes, the rest
    padding (weight 0, index 0), with int8-magnitude integer weights."""
    rng = np.random.default_rng(seed)
    val = rng.integers(-127, 128, (r, lanes)).astype(np.float32)
    idx = rng.integers(0, s, (r, lanes)).astype(np.int32)
    keep = np.arange(lanes)[None, :] < rng.integers(0, lanes + 1, (r, 1))
    val, idx = np.where(keep, val, 0), np.where(keep, idx, 0).astype(np.int32)
    x = (rng.random((s, b)) < 0.2).astype(np.float32)
    return [torch.tensor(a).cuda() for a in (val, idx, x)]


def max_abs_diff(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| in float64 (exact for int32 and f32 values)."""
    if out.numel() == 0:
        return 0.0
    return float((out.double() - ref.double()).abs().max())


def check_kernels(shapes) -> dict:
    """Kernel vs plain version on the card at every shape; max |diff| each."""
    from repro_torch.kernels.lif_update import lif_update, lif_update_ref
    from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
    from repro_torch.kernels.spike_wdm_matmul import (
        spike_wdm_matmul, spike_wdm_matmul_ref,
    )

    err = {"lif_update": 0.0, "spike_wdm_matmul": 0.0, "sparse_gather": 0.0}
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
    for seed, (r, lanes, s, b) in enumerate(shapes["sparse_gather"]):
        val, idx, x = ell_inputs(r, lanes, s, b, seed)
        out, ref = sparse_gather(val, idx, x), sparse_gather_ref(val, idx, x)
        torch.cuda.synchronize()
        require(torch.equal(out, ref), f"sparse_gather differs at {(r, lanes, s, b)}")
        err["sparse_gather"] = max(err["sparse_gather"], max_abs_diff(out, ref))
    return err


# -- 2. compile ----------------------------------------------------------------
def gesture_net():
    from repro_torch.core import feedforward_network
    from repro_torch.core.layer import LIFParams

    net = feedforward_network([N_INPUT, 20, 4], density=0.0316, delay_range=1,
                              seed=0, name="gesture")
    for layer in net.layers:
        layer.lif = LIFParams(alpha=0.5, v_th=64.0)
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
    return reports


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


def hold_replies(net, reports, batches, served):
    """Every served reply against its solo run on the card, the port on the
    CPU, and run_graph_reference."""
    from repro_torch.core.runtime import (
        NetworkExecutable, network_executable, run_graph_reference,
    )

    for name, rep in reports.items():
        exe = network_executable(net, rep)
        forms = rep.serial_forms.get(("fused", MICRO_BATCH))
        for layer, form in zip(rep.layers, forms):
            if layer.paradigm == "serial":
                require(form == "sparse", f"{name}: serial form {form} at batch 8")
        for (x, vs), outs in zip(batches, served[name]):
            for b, steps in enumerate(vs):
                solo = exe.run(x[:steps, b : b + 1])
                oracle = run_graph_reference(net, x[:steps, b : b + 1])
                for z, s, o in zip(outs, solo, oracle):
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


def time_serving(net, name, rep, batch, card):
    """One served micro-batch: host time per launch (ends in a sync), the
    same launch's device time (captured once as a CUDA graph and replayed,
    so no host time is in it), and the device kernels that make it up."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.runtime import network_executable

    exe = network_executable(net, rep)
    x, vs = batch
    xs = torch.as_tensor(x, device="cuda")
    vs_t = torch.as_tensor(vs, device="cuda")

    def launch():
        exe.run_device(xs, valid_steps=vs_t)

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        launch()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    dev = device_ms(launch, iters=1, replays=reps) / 1e3
    steps = x.shape[0]
    print(f"serve timing [{card}]: {name} micro-batch of {len(vs)} "
          f"({steps} steps): {dt * 1e3:.3f} ms per launch, "
          f"{dt / steps * 1e6:.1f} us per step, "
          f"{int(vs.sum()) / dt:,.0f} request-steps/s; device time "
          f"{dev * 1e3:.3f} ms per launch, busy share {dev / dt:.3f}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        launch()
        torch.cuda.synchronize()
    # rows with no host time of their own are the device's kernels and copies
    rows = sorted(
        (e for e in prof.key_averages()
         if e.self_cpu_time_total == 0 and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    total = sum(e.self_device_time_total for e in rows)
    top = "; ".join(f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                    for e in rows[:6])
    print(f"serve profile [{card}]: {name}: device {total / 1e3:.3f} ms in "
          f"{sum(e.count for e in rows)} launches; top: {top}")


# -- kernel timings --------------------------------------------------------------
def kernel_rows(path, err, counts, card):
    """Times at the main path's largest shape of each kernel (the JSON
    rows), and at the reference benchmark's larger shapes (printed only).

    ``ms``/``plain_ms``/``library_ms`` are device times from CUDA-graph
    replay; the eager per-call times (host enqueue included) are printed
    beside them."""
    from repro_torch.kernels.lif_update import lif_update, lif_update_ref
    from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
    from repro_torch.kernels.spike_wdm_matmul import (
        spike_wdm_matmul, spike_wdm_matmul_ref,
    )

    def timed(kernel, plain, library, n_bytes, n_ops, ops_rate):
        b, by = bound_ms(n_bytes, n_ops, ops_rate)
        t = {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
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
        # library yardstick: the same ELL as one CSR sparse x dense product
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
        return timed(
            lambda: sparse_gather(val, idx, x),
            lambda: sparse_gather_ref(val, idx, x),
            lambda: torch.sparse.mm(csr, x),
            8 * r * lanes + 4 * rows_read * bsz + 4 * r * bsz, 2 * nnz * bsz,
            F32_OPS_S,
        )

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
        "sparse_gather": [tuple(ell_inputs(4096, 32, 2048, 8, 1))],
    }
    fns = {"lif_update": lif_row, "spike_wdm_matmul": wdm_row,
           "sparse_gather": gather_row}
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
    return rows


def path_desc(name, args):
    if name == "sparse_gather":
        val, _, x = args
        return f"R={val.shape[0]} L={val.shape[1]} S={x.shape[0]} B={x.shape[1]}"
    return str(args[0] if name == "lif_update" else tuple(args[:3]))


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
    print(f"build: 3 kernels built or found in {time.perf_counter() - t0:.1f} s")
    fixed = {
        "lif_update": [(256, 128), (300, 36), (1, 1), (1000, 3), (1024, 128)],
        "spike_wdm_matmul": [(4, 16, 1), (128, 128, 128), (128, 512, 128),
                             (300, 700, 36), (1, 1, 1), (257, 1025, 129),
                             (512, 2048, 128)],
        "sparse_gather": [(4096, 32, 2048, 8), (3000, 17, 500, 3), (1, 1, 1, 1)],
    }
    err = check_kernels(fixed)
    print("build: kernels equal their plain versions at the reference's test "
          "and benchmark shapes")

    # 2. compile
    net = gesture_net()
    reports = compile_reports(net)
    lif_s, wdm_s, ell_s = path_shapes(net, reports, MICRO_BATCH)
    print(f"compile: path shapes: lif {lif_s}, wdm {wdm_s}, ell "
          f"{[(tuple(v.shape), s) for v, _, s in ell_s]}")
    path_err = check_kernels({
        "lif_update": lif_s, "spike_wdm_matmul": wdm_s,
        "sparse_gather": [(v.shape[0], v.shape[1], s, MICRO_BATCH)
                          for v, _, s in ell_s],
    })
    from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
    for val, idx, s in ell_s:           # the compiled ELL operands themselves
        x = (torch.rand((s, MICRO_BATCH), device="cuda") < 0.2).float()
        out, ref = sparse_gather(val, idx, x), sparse_gather_ref(val, idx, x)
        require(torch.equal(out, ref), "sparse_gather differs on the compiled operands")
        path_err["sparse_gather"] = max(path_err["sparse_gather"], max_abs_diff(out, ref))
    err = {k: max(err[k], path_err[k]) for k in err}

    # 3. serve: the main path, with the launch counts read around it
    reqs = make_requests()
    batches = [micro_batch(reqs[:MICRO_BATCH]), micro_batch(reqs[MICRO_BATCH:])]
    reset_launch_counts()
    served = serve_main_path(net, reports, batches)
    counts = launch_counts()
    print(f"serve: launches on the served path: {counts}")
    for name, n in counts.items():
        require(n > 0, f"{name} was never launched on the served path")
    hold_replies(net, reports, batches, served)
    for name, rep in reports.items():
        time_serving(net, name, rep, batches[0], card)

    gather_args = max(ell_s, key=lambda e: e[0].numel())
    ga_val, ga_idx, ga_s = gather_args
    path = {
        "lif_update": ((MICRO_BATCH, max(n for _, n in lif_s)), 0),
        "spike_wdm_matmul": (*max(wdm_s, key=lambda s: s[0] * s[1]), 0),
        "sparse_gather": (
            ga_val, ga_idx,
            (torch.rand((ga_s, MICRO_BATCH), device="cuda") < 0.2).float(),
        ),
    }
    rows = kernel_rows(path, err, counts, card)
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
