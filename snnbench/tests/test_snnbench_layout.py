"""The harness finds a cell's configuration, traffic (its mix and its
arrival process) and metrics by the names in the benchmark file: a new
configuration, traffic mix, arrival process and metric are new files,
and run through it unchanged."""
import json
import shutil

import pytest

from snnbench.tests.helpers import BASE

GENERATOR = '''
import numpy as np
from snnbench.graph import chain_graph


def generate(cfg):
    rng = np.random.default_rng(cfg["seed"])
    w = np.where(rng.random((24, 6)) < 0.5, rng.integers(1, 128, (24, 6)), 0).astype(float)
    d = np.ones((24, 6), np.int64)
    return chain_graph(cfg["name"], [(w, d)], 1, 0.5, 64.0)
'''
ARRIVALS = '''
import numpy as np

LOOP = "open"


def count(traffic, seconds):
    return int(round(traffic["per_s"] * seconds))


def arrivals(traffic, n, permute):
    return np.arange(n) / traffic["per_s"], np.full(n, -1)
'''
METRIC = '''
def read(run):
    return float(len(run.window.requests))
'''


def _layout(tmp):
    for sub in ("configs", "traffic", "metrics"):
        (tmp / sub).mkdir()
    (tmp / "configs" / "dummy.py").write_text(GENERATOR)
    (tmp / "configs" / "dummy.json").write_text(json.dumps({
        "name": "dummy", "generator": "dummy", "seed": 3,
        "tenants": {"default": {"compile": "serial"}}}))
    (tmp / "traffic" / "even.py").write_text(ARRIVALS)
    (tmp / "traffic" / "trickle.json").write_text(json.dumps({
        "generator": "even", "per_s": 40.0, "steps": [5, 9], "input_rate": 0.3,
        "tenants": {"default": 1.0},
        "classes": [{"share": 1.0, "priority": 0, "deadline_ms": None}],
        "engine": {"micro_batch": 4, "min_bucket_steps": 8, "max_wait_ms": None},
        "check": {"every": 1, "max": 1000}}))
    (tmp / "metrics" / "requests_seen.py").write_text(METRIC)
    shutil.copy(BASE / "metrics" / "setup_s.py", tmp / "metrics" / "setup_s.py")
    return {
        "configs": [{"name": "dummy", "file": "configs/dummy.json"}],
        "workloads": [{"name": "dummy-trickle", "config": "dummy",
                       "traffic": "trickle", "chips": 1}],
        "end_to_end": [{"name": "requests_seen", "unit": "requests"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []}


def test_a_new_config_traffic_and_metric_run_through_the_lookup(tmp_path, monkeypatch):
    from snnbench import run, system

    monkeypatch.setattr(system, "CACHE_DIR", tmp_path / "cache")
    bench = _layout(tmp_path)
    res = run.run_cell(bench, "dummy-trickle", 2**31 + 5, 0.5, False, device="cpu",
                       root=tmp_path, base=tmp_path, log=lambda m: None)
    assert res["correct"] is True
    assert res["metrics"]["requests_seen"] == {"value": 20.0, "unit": "requests"}
    assert res["attempted"] == 20 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def test_a_metric_reader_is_found_by_its_name_or_its_stem():
    from snnbench.lookup import metric_reader

    assert metric_reader(BASE, "engine_overhead_ms.rate").__file__.endswith(
        "engine_overhead_ms.py")
    assert metric_reader(BASE, "lif_step_roofline.p95").__file__.endswith(
        "lif_step_roofline.py")
    with pytest.raises(FileNotFoundError):
        metric_reader(BASE, "no_such_metric.p95")


def test_every_metric_of_the_benchmark_has_a_reader_and_every_cell_its_files():
    from snnbench.lookup import metric_reader
    from snnbench.tests.helpers import ROOT, bench

    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert hasattr(metric_reader(BASE, m["name"]), "read")
    for w in b["workloads"]:
        cfg = next(c for c in b["configs"] if c["name"] == w["config"])
        gen = json.loads((ROOT / cfg["file"]).read_text())["generator"]
        assert (BASE / "configs" / f"{gen}.py").exists()
        mix = json.loads((BASE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BASE / "traffic" / f"{mix['generator']}.py").exists()

