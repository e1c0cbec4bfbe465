"""Mean firing rate of each population of the benchmark's microcircuit
configuration, from the plain reference (``snnbench/reference``) on the
frozen generator's graph, over the steps of a request from ``--from-step``
on, for each scalar on every population's ``v_th``.

    python3 tools/microcircuit_rates.py [--scale 1.0] [--v-th-scale 1.0 ...]

One JSON line a scalar: the rate of each population in Hz (dt 1 ms).  The
full scale needs a CUDA card (about 25 GB of device memory); a small
``--scale`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=str(ROOT / "snnbench/configs/microcircuit-pd14.json"))
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--v-th-scale", type=float, nargs="+", default=[1.0])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--from-step", type=int, default=16)
    ap.add_argument("--seed", type=int, nargs="+", default=[1])
    args = ap.parse_args(argv)

    import torch

    from snnbench.configs import microcircuit
    from snnbench.reference import Simulator

    cfg = json.loads(Path(args.config).read_text())
    if args.scale is not None:
        cfg["scale"] = args.scale
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    t0 = time.perf_counter()
    graph = microcircuit.generate(cfg)
    print(f"generated {sum(len(e['indices']) for e in graph['projections'])} synapses "
          f"in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    sim = Simulator(graph, device=dev)
    lif = list(sim.lif)
    for seed in args.seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        x = (torch.rand((args.steps, args.lanes, sim.n_input), generator=gen,
                        device=dev) < cfg["ext_rate"]).to(torch.uint8)
        for k in args.v_th_scale:
            sim.lif = [(a, None if v is None else max(1.0, float(round(v * k))))
                       for a, v in lif]
            t0 = time.perf_counter()
            trains = sim.run(x)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rates = {p["name"]: 1e3 * float(z[args.from_step:].float().mean())
                     for p, z in zip(graph["populations"], trains)}
            print(json.dumps({"seed": seed, "v_th_scale": k, "v_th": sim.lif[1][1],
                              "rates_hz": rates, "seconds": round(secs, 3),
                              "device": str(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
