"""The microcircuit cell's harness path on the CPU, at scale 0.01 (771
neurons, 44k synapses; the cell itself runs at 1.0): the port's served
replies equal the plain reference bit for bit in the cell's closed loop,
the bfloat16 control and a planted fault (every step returning its state
unchanged) each read not correct, and the
event form's roofline counts its synaptic events from the graph and the
replies."""
import copy
import json
import shutil
import types

import numpy as np
import pytest
import torch

from snnbench.tests.helpers import BASE, bench, config, traffic
from snnbench.tests.test_snnbench_faults import CPU_GRACE_S, FAULTS
from snnbench import check, schedule
from snnbench.configs import microcircuit

SCALE = 0.01
CELL = "microcircuit-small-stream"


def _small() -> dict:
    return dict(config("microcircuit-pd14"), scale=SCALE, name="microcircuit-small")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A compile cache of the module's own and the harness's files with the
    configuration at scale 0.01 under the cell's own traffic."""
    from snnbench import system

    old = system.CACHE_DIR
    system.CACHE_DIR = tmp_path_factory.mktemp("compile")
    base = tmp_path_factory.mktemp("base")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BASE / sub, base / sub)
    (base / "configs" / "microcircuit-small.json").write_text(json.dumps(_small()))
    b = copy.deepcopy(bench())
    b["configs"].append({"name": "microcircuit-small",
                         "file": str(base / "configs" / "microcircuit-small.json")})
    b["workloads"].append({"name": CELL, "config": "microcircuit-small",
                           "traffic": "stream1", "chips": 1})
    yield base, b
    system.CACHE_DIR = old


def _run(cache, seed, monkeypatch):
    from snnbench import run, serve

    monkeypatch.setattr(serve, "GRACE_S", CPU_GRACE_S)
    base, b = cache
    return run.run_cell(b, CELL, seed, 1.0, False, device="cpu", base=base,
                        log=lambda m: None)


@pytest.mark.parametrize("seed", [2**31 + 31, 32, 2**33 + 33])
def test_served_replies_equal_the_reference(seed, cache, monkeypatch):
    res = _run(cache, seed, monkeypatch)
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"] is True, checks
    assert checks["mismatched_spikes"] == 0 and checks["missing_replies"] == 0
    assert checks["replies_compared"] >= 1 and res["failed"] == 0


def test_a_planted_fault_reads_not_correct(cache, monkeypatch):
    FAULTS["unchanged_state"](monkeypatch)
    res = _run(cache, 2**31 + 41, monkeypatch)
    assert res["correct"] is False
    assert res["checks"]["mismatched_spikes"]["value"] > 0


@pytest.mark.parametrize("seed", [51, 2**31 + 52])
def test_the_control_reads_not_correct(seed):
    cfg = _small()
    graph = microcircuit.generate(cfg)
    sched = schedule.make(traffic("stream1"), cfg, graph, seed, 2.0, "cpu")
    r = check.control(graph, sched, list(range(6)), torch.device("cpu"))
    assert r["replies_compared"] == 6
    assert r["mismatched_spikes"] > check.LIMITS["mismatched_spikes"]
    assert not check.is_correct(r)


def test_the_event_forms_roofline_counts_events_from_the_replies():
    """Two requests of phase B on a chain 3 -> 2 -> 2 whose first edge runs
    the event form: 12 bytes a synaptic event (a source's spike times its
    out-degree), over the device time of every op but K1, K2, K3 and copies;
    a request whose reply was not kept counts at the kept ones' mean a
    step; no event projection, no reading."""
    from snnbench.graph import chain_graph
    from snnbench.lookup import metric_reader
    from snnbench.run import Run
    from snnbench.serve import Request, Window
    from snnbench.work.event_form import BYTES_PER_EVENT
    from snnbench.work.peaks import HBM_BYTES_S

    w1 = np.array([[3.0, 1.0], [0.0, 2.0], [5.0, 0.0]])
    w2 = np.array([[1.0, 1.0], [0.0, 4.0]])
    graph = chain_graph("t", [(w1, np.ones((3, 2))), (w2, np.ones((2, 2)))], 1, 0.5, 2.0)
    payloads = [np.array([[1, 1, 0], [0, 1, 1]], np.uint8),
                np.array([[1, 0, 0], [1, 1, 1], [0, 0, 1]], np.uint8)]
    sched = types.SimpleNamespace(steps=np.array([2, 3]),
                                  payload=lambda i: payloads[i])
    reply = [np.array([[1, 0], [1, 1]], np.uint8), np.zeros((2, 2), np.uint8)]
    kept = {0: ([reply[0], reply[1]], [0, 1], 0)}
    reqs = [Request(0, t_submit=1.0, t_reply=2.0, kind="ok"),
            Request(1, t_submit=2.0, t_reply=3.0, kind="ok")]
    win = Window(t0=0.0, t_end=3.0, requests=reqs, kept=kept)
    launches = [{"model": "default", "batch": 1, "bucket": 4, "requests": 1,
                 "phase": "B", "t": 1.5},
                {"model": "default", "batch": 1, "bucket": 4, "requests": 1,
                 "phase": "B", "t": 2.5}]
    ops = {"indexFuncLargeIndex<float>": [2e-6, 8], "gather_kernel": [3e-6, 8],
           "lif_step_kernel_StepParams_": [9.0, 16], "wdm_kernel<true>": [9.0, 8],
           "Memcpy HtoD (Pageable -> Device)": [9.0, 2]}
    profile = {"busy_s": 1.0, "window_s": 2.0, "ops": ops, "idle": {}}

    def run_with(forms):
        exe = types.SimpleNamespace(serial_forms=lambda batch: forms)
        return Run(window=win, sched=sched, graph=graph, launches=launches,
                   profile=profile, executables={"default": exe})

    reader = metric_reader(BASE, "event_form_roofline.p95")
    # request 0: input spikes of sources 0, 1, 1, 2 (out-degrees 2, 1, 1)
    kept_events = 2 + 1 + 1 + 1
    # request 1 was not kept: 3 steps at 5 events over 2 steps
    events = kept_events + 3 * kept_events / 2
    want = 100 * BYTES_PER_EVENT * events / HBM_BYTES_S / 5e-6
    assert reader.read(run_with(("event", "-"))) == pytest.approx(want)
    # the second edge in the event form too: population 1's spikes 2, 1
    # times its out-degrees 2, 1; the profiler kept 8 of the 16 implied
    # index_add_ calls, so the bound scales by half
    both = kept_events + (2 * 2 + 1 * 1)
    want = 100 * BYTES_PER_EVENT * (both + 3 * both / 2) / HBM_BYTES_S * 0.5 / 5e-6
    assert reader.read(run_with(("event", "event"))) == pytest.approx(want)
    assert reader.read(run_with(("-", "sparse"))) is None
