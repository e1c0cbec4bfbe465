"""The control of a cell: the plain reference computed one precision
lower (bfloat16 for the configuration's float32) put in the program's
place, over the requests a run of the cell compares, held against the
float32 reference by the run's own comparison.  It must come out not
correct on every seed.

    python3 snnbench/control.py --workload gesture-poisson --seconds 10 --seeds 1 2 3

For an open-loop cell the requests are those due in a window of
``--seconds``; for a closed loop, ``--compare`` requests picked by the
run's own rule for which replies it keeps.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from snnbench.run import BASE, ROOT  # noqa: E402  (sets the paths)
import torch  # noqa: E402

from snnbench.lookup import load_module  # noqa: E402

from snnbench import check, schedule, serve  # noqa: E402


def compared(sched, traffic: dict, seconds: float, seed: int, n: int):
    """The schedule's requests a run of ``seconds`` would compare."""
    if sched.loop == "open":
        return list(range(int(np.searchsorted(sched.due_s, seconds))))
    keep, most = serve._keep_set(sched, traffic, seed)
    per = len(sched) // traffic["clients"]
    idx = np.flatnonzero(keep)
    idx = idx[np.argsort(idx % per, kind="stable")]
    return [int(i) for i in idx[: min(n, most)]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--compare", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BASE / "traffic" / f"{cell['traffic']}.json").read_text())
    generator = load_module(BASE / "configs" / f"{cfg['generator']}.py", "configs")
    graph = generator.generate(cfg)
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        sched = schedule.make(traffic, cfg, graph, seed, args.seconds, args.device)
        idx = compared(sched, traffic, args.seconds, seed, args.compare)
        numbers = check.control(graph, sched, idx, torch.device(args.device))
        numbers["correct"] = check.is_correct(numbers)
        numbers.update(seed=seed, seconds=time.perf_counter() - t)
        rows.append(numbers)
        print(f"control {args.workload} seed {seed}: " + ", ".join(
            f"{k} {v}" for k, v in numbers.items()), flush=True)
    print(json.dumps({"workload": args.workload, "control": rows}))
    return 0 if rows and not any(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
