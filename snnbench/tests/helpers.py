"""Shared by the benchmark's CPU tests: the repository's paths, the cells'
files, and a scaffold fixture: the port's own cerebellum-class recipe
(no published deployment, so no cell of the benchmark), which drives the
harness's multi-population, recurrent and closed-loop paths."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BASE = ROOT / "snnbench"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a closed loop of 16 clients over the scaffold fixture, full buckets of 8
CLOSED = {"generator": "closed", "clients": 16, "requests_per_client_per_s": 8,
          "steps": [32, 64], "input_rate": "config", "tenants": {"default": 1.0},
          "classes": [{"share": 1.0, "priority": 0, "deadline_ms": None}],
          "engine": {"micro_batch": 8, "min_bucket_steps": 8, "max_wait_ms": None},
          "check": {"every": 1, "max": 10**6}}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str) -> dict:
    return json.loads((BASE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((BASE / "traffic" / f"{name}.json").read_text())


def scaffold(n: int = 1000) -> dict:
    """The scaffold fixture at ``n`` neurons."""
    cfg = json.loads((BASE / "tests" / "scaffold-1k.json").read_text())
    return dict(cfg, n_neurons=n, name=f"scaffold-{n}")
