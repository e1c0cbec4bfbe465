"""One run of one benchmark cell of the port (``repro_torch``).

    python3 snnbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run loads the cell's configuration
(from the compile cache when it is there and the run is not traced),
makes its traffic from the seed, warms the cell's bucket shapes, serves
the traffic through the port's ``ServingEngine`` for ``--seconds``, then
holds the replies against the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (and ``breakdown`` in a
traced run) and ``checks``; the last lines of standard error are the
numbers compared, each with its limit.

Without a CUDA card, or with fewer than the cell asks for, it exits 3 and
prints no result; if JAX or the JAX package is loaded when the window has
closed, it exits 4.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASE = Path(__file__).resolve().parent
#: build and kernel caches of PyTorch and Triton, at fixed paths in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": BASE / ".cache" / "torch_extensions",
          "TRITON_CACHE_DIR": BASE / ".cache" / "triton"}
#: top-level modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds at the end of a traced window run under the profiler (phase B)
PROFILED_S = 3.0


def _setup_paths() -> None:
    for k, v in CACHES.items():
        os.environ[k] = str(v)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


_setup_paths()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from snnbench import check, schedule, serve, stats, system, trace  # noqa: E402
from snnbench.lookup import metric_reader  # noqa: E402
from snnbench.work.step import StepWork  # noqa: E402


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self._per_step = {}

    def per_step(self, work, model: str, batch: int):
        """Bound seconds of each call of a kernel in one step of ``model``:
        counted from the graph, given which kernel form the program runs
        each projection in at this batch."""
        key = (work.__name__, model, batch)
        if key not in self._per_step:
            forms = self.executables[model].serial_forms(batch)
            self._per_step[key] = work.per_step(self.graph, forms, batch)
        return self._per_step[key]


def run_cell(bench: dict, workload: str, seed: int, seconds: float, traced: bool, *,
             device=None, root: Path = ROOT, base: Path = BASE,
             t_start: float = T_START, log=print) -> dict:
    """Load, warm, measure, check; returns the result's dict."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg_path = root / entry["file"]
    cfg = json.loads(cfg_path.read_text())
    traffic = json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text())
    generator = base / "configs" / f"{cfg['generator']}.py"
    readers = {m["name"]: (m, metric_reader(base, m["name"]))
               for m in cell_metrics(bench, workload, traced)}
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None \
        else torch.device(device)
    on_card = dev.type == "cuda"

    graph, reports, compile_s = system.load(cfg_path, cfg, generator, fresh=traced)
    log(f"setup: graph and reports {'compiled' if compile_s else 'from the cache'} "
        f"at {time.perf_counter() - t_start:.1f} s")
    sched = schedule.make(traffic, cfg, graph, seed, seconds, dev, base)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    net = system.port_network(graph)
    engine = serve.build_engine(net, reports, traffic, None if on_card else dev)
    warmed = serve.warm(engine, traffic)
    log(f"setup: {warmed} bucket shapes warmed at {time.perf_counter() - t_start:.1f} s")
    before = engine.stats()

    spans = prof = None
    if traced:
        work = StepWork(graph)

        def count_work(rec, mb, replies):
            ops = n_bytes = 0.0
            for req in mb.requests:
                reply = replies.get(req.request_id)
                if isinstance(reply, list):
                    o, b = work.request(req.spikes, reply)
                    ops, n_bytes = ops + o, n_bytes + b
            rec["bound_s"] = StepWork.bound(ops, n_bytes)

        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # the first start of a profiler in a process sets it up (seconds):
        # pay that here, in set-up, and not inside phase B
        warm_prof = torch.profiler.profile(activities=acts)
        warm_prof.start()
        torch.zeros(1, device=dev).add_(1)
        warm_prof.stop()
        prof = torch.profiler.profile(activities=acts)
        spans = serve.Spans(engine, on_launch=count_work, prof=prof,
                            profiled_s=min(PROFILED_S, seconds / 2))

    # what set-up left on the heap (a fresh compile leaves much more than a
    # cached one) stays out of the window's garbage collections
    gc.collect()
    gc.freeze()
    run_window = serve.run_open if sched.loop == "open" else serve.run_closed
    win = run_window(engine, sched, traffic, seconds, seed, spans=spans)
    setup_s = win.t0 - t_start
    after = engine.stats()
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    faults = _faults(before, after)
    late = [r.t_submit - r.t_due for r in win.requests if r.t_due < win.t_end]
    log(f"window: {len(win.requests)} requests, {sum(r.kind == 'ok' for r in win.requests)} "
        f"served, generator late by {1e3 * float(np.mean(late)):.3f} ms on average "
        f"(most {1e3 * float(np.max(late)):.3f}); faults after warm-up {faults}"
        + (f"; {win.reused} requests sent from a restarted list" if win.reused else ""))

    profile = None
    if traced:
        spans.close()
        profile = trace.read(prof.events()) if spans.profiled else None
    run = Run(window=win, sched=sched, graph=graph, setup_s=setup_s,
              compile_s=compile_s, engine=engine, launches=spans.launches if spans else [],
              phase_a=spans.phase_a if spans else None, profile=profile,
              executables={m: engine.pool.peek(m).report.executable
                           for m in engine.pool.models()})
    metrics = {}
    for name, (m, reader) in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": m["unit"]}

    del run, engine, net, reports, spans, prof
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.compare(graph, sched, win, dev)
    log(f"check: {numbers['replies_compared']} replies held against the reference "
        f"in {time.perf_counter() - t_check:.1f} s")
    result = {
        "correct": check.is_correct(numbers),
        "attempted": sum(r.t_due < win.t_end for r in win.requests),
        "failed": stats.failed(win) + sum(faults.values()),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak},
    }
    if traced and profile is not None:
        result["device"].update(busy_s=profile["busy_s"], window_s=profile["window_s"])
        result["breakdown"] = trace.breakdown(profile)
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


#: engine counters that must not move after warm-up: each is a failed operation
FAULT_COUNTERS = ("bucket_misses", "relowerings")
SUPERVISOR_FAULTS = ("retries", "watchdog_stalls", "validation_failures",
                     "degraded_launches", "bisections", "quarantined")


def _faults(before: dict, after: dict) -> dict:
    out = {k: after[k] - before[k] for k in FAULT_COUNTERS}
    out.update({k: after["supervisor"][k] - before["supervisor"][k]
                for k in SUPERVISOR_FAULTS})
    return {k: v for k, v in out.items() if v}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      log=log)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; the benchmark may not load them",
              file=sys.stderr)
        return 4
    for line in check.lines({k: v["value"] for k, v in result["checks"].items()}):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
