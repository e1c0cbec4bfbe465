"""Each fault a cell can have, planted under the timed path of a CPU run
(the harness's look for a card skipped), turns ``correct`` false; the
same run with nothing planted is correct.  The faults: a step that
returns its state unchanged; half of each batch left out; an answer
altered where it is produced.  (No cell spans chips, so there is no
exchange between chips to leave out.)  Besides the benchmark's cell, a
closed loop over the scaffold fixture drives the harness's closed-loop
and multi-population paths the same way."""
import copy
import json
import shutil

import pytest

from snnbench.tests.helpers import BASE, CLOSED, bench, scaffold

CELLS = {"gesture-poisson": 0.5, "scaffold-closed": 2.0}
#: seconds past the close a reply may take: the CPU's plain kernels on a
#: loaded host can take longer than the card's minute, and timing is not
#: what these runs check
CPU_GRACE_S = 900.0


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A compile cache of the module's own, and a copy of the harness's
    files with the scaffold fixture and its closed loop added (which keeps
    every reply: a short CPU window finishes few requests)."""
    from snnbench import system

    old = system.CACHE_DIR
    system.CACHE_DIR = tmp_path_factory.mktemp("compile")
    base = tmp_path_factory.mktemp("base")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BASE / sub, base / sub)
    (base / "configs" / "scaffold-1k.json").write_text(json.dumps(scaffold(1000)))
    (base / "traffic" / "closed-16.json").write_text(json.dumps(CLOSED))
    b = copy.deepcopy(bench())
    b["configs"].append({"name": "scaffold-1k",
                         "file": str(base / "configs" / "scaffold-1k.json")})
    b["workloads"].append({"name": "scaffold-closed", "config": "scaffold-1k",
                           "traffic": "closed-16", "chips": 1})
    yield base, b
    system.CACHE_DIR = old


def _unchanged_state(monkeypatch):
    import repro_torch.core.runtime.executor as executor

    def step(edges, v, z, out, t, *, alpha, v_th):
        out.copy_(z.to(out.dtype))          # neither v nor z moves
        return out

    monkeypatch.setattr(executor, "lif_step", step)


def _outputs(monkeypatch, change):
    from repro_torch.serving.pool import ExecutablePool

    run = ExecutablePool.run_microbatch

    def broken(self, mb, *a, **kw):
        outs = run(self, mb, *a, **kw)
        seen = set()
        for z in outs:
            if id(z) not in seen:
                seen.add(id(z))
                change(z)
        return outs

    monkeypatch.setattr(ExecutablePool, "run_microbatch", broken)


def _half_batch(monkeypatch):
    _outputs(monkeypatch, lambda z: z[:, z.shape[1] // 2:].zero_())


def _altered_answer(monkeypatch):
    def flip(z):
        z[0, 0, 0] = 1.0 - z[0, 0, 0]
    _outputs(monkeypatch, flip)


FAULTS = {"none": None, "unchanged_state": _unchanged_state,
          "half_batch": _half_batch, "altered_answer": _altered_answer}


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(cell, fault, cache, monkeypatch):
    from snnbench import run, serve

    monkeypatch.setattr(serve, "GRACE_S", CPU_GRACE_S)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    base, b = cache
    res = run.run_cell(b, cell, 2**31 + 77, CELLS[cell], False, device="cpu",
                       base=base, log=lambda m: None)
    assert res["checks"]["replies_compared"]["value"] >= 1
    assert res["correct"] is (fault == "none"), res["checks"]
    if fault != "none":
        assert res["checks"]["mismatched_spikes"]["value"] > 0
