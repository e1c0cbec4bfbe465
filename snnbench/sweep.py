"""The knee of an open-loop cell: the highest offered rate the engine
sustains without a growing backlog, found by one sweep on the card.

    python3 snnbench/sweep.py --workload gesture-poisson --seed 7 --seconds 8 \\
        --rates 150 200 250 300

Each rate serves the cell's traffic mix with ``rate_hz`` set to it, in
one process over one warmed engine, and prints a line: the rate served,
p50 and p95 from due, the mean latency of the window's first and last
quarter of arrivals (a backlog that grows makes the last the larger), how
long the replies due in the window took past its close, and how late the
generator ran.  A cell's rate is then written into its traffic file by
hand, at 0.8 of the knee.
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


from snnbench import schedule, serve, stats, system  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg_path = ROOT / entry["file"]
    cfg = json.loads(cfg_path.read_text())
    traffic = json.loads((BASE / "traffic" / f"{cell['traffic']}.json").read_text())
    generator = BASE / "configs" / f"{cfg['generator']}.py"
    dev = torch.device("cuda", torch.cuda.current_device())
    graph, reports, _ = system.load(cfg_path, cfg, generator, fresh=False)
    engine = serve.build_engine(system.port_network(graph), reports, traffic, None)
    serve.warm(engine, traffic)
    rows = []
    for k, rate in enumerate(args.rates):
        mix = dict(traffic, rate_hz=rate, check={"every": 10**9, "max": 0})
        sched = schedule.make(mix, cfg, graph, args.seed + k, args.seconds, dev)
        win = serve.run_open(engine, sched, mix, args.seconds, args.seed + k)
        done = [r for r in win.requests if r.kind == "ok"]
        lat = stats.latencies_ms(win)
        quarter = [np.mean([(r.t_reply - r.t_due) * 1e3 for r in done
                            if lo <= (r.t_due - win.t0) / args.seconds < hi])
                   for lo, hi in ((0.0, 0.25), (0.75, 1.0))]
        row = {"offered_hz": rate, "requests": len(win.requests),
               "served_in_window_hz": sum(r.t_reply <= win.t_end for r in done)
               / args.seconds,
               "p50_ms": stats.quantile(lat, 0.5), "p95_ms": stats.quantile(lat, 0.95),
               "first_quarter_ms": quarter[0], "last_quarter_ms": quarter[1],
               "past_close_s": max(r.t_reply for r in done) - win.t_end,
               "late_ms_mean": 1e3 * float(np.mean([r.t_submit - r.t_due
                                                    for r in win.requests])),
               "failed": stats.failed(win)}
        rows.append(row)
        print(" ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in row.items()), flush=True)
        time.sleep(0.5)
    print(json.dumps({"workload": args.workload, "sweep": rows,
                      "card": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
