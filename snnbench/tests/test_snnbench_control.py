"""The control — the reference in bfloat16, one precision below the
configurations' float32, put in the program's place — comes out not
correct under the runs' own comparison, at a size a test run holds (and,
on a card, at the cell's own size)."""
import json

import pytest
import torch

from snnbench.tests.helpers import CLOSED, ROOT, config, scaffold, traffic
from snnbench import check, control, schedule
from snnbench.configs import cerebellum, feedforward


def _readings(name, gen, cfg, mix, seconds, seeds, device, compare=128):
    graph = gen.generate(cfg)
    out = []
    for seed in seeds:
        sched = schedule.make(mix, cfg, graph, seed, seconds, device)
        idx = control.compared(sched, mix, seconds, seed, compare)
        out.append(check.control(graph, sched, idx, torch.device(device)))
    return out


@pytest.mark.parametrize("seed", [11, 2**31 + 12, 13])
def test_control_fails_on_the_gesture_cell(seed):
    (r,) = _readings("gesture", feedforward, config("gesture"), traffic("poisson"),
                     2.0, [seed], "cpu")
    assert r["replies_compared"] == 512
    assert r["mismatched_spikes"] > check.LIMITS["mismatched_spikes"]
    assert not check.is_correct(r)


@pytest.mark.parametrize("seed", [21, 2**31 + 22, 23])
def test_control_fails_on_the_scaffold_fixture_in_a_closed_loop(seed):
    (r,) = _readings("scaffold", cerebellum, scaffold(1000), CLOSED, 10.0, [seed],
                     "cpu", compare=32)
    assert r["replies_compared"] == 32
    assert not check.is_correct(r)


@pytest.mark.cuda
def test_control_fails_at_the_cells_own_size(card):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    secs = bench["run_seconds"]
    for r in _readings("gesture", feedforward, config("gesture"), traffic("poisson"),
                       secs, [1, 2, 3], card):
        assert not check.is_correct(r)
