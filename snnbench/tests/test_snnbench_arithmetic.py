"""The end-to-end and per-layer arithmetic, on hand-made windows."""
import types

import numpy as np
import pytest

from snnbench.tests.helpers import BASE
from snnbench import stats
from snnbench.serve import Request, Window
from snnbench.work import peaks, step


def _window(rows, t_end=10.0):
    """rows: (due, reply or None, kind)."""
    reqs = []
    for k, (due, reply, kind) in enumerate(rows):
        r = Request(index=k, t_due=due, t_reply=reply, kind=kind)
        reqs.append(r)
    return Window(t0=0.0, t_end=t_end, requests=reqs, kept={})


def test_latency_runs_from_due_over_all_served_requests():
    rows = [(float(k), float(k) + 0.010 * (k + 1), "ok") for k in range(10)]
    rows += [(1.5, None, "shed"), (2.5, 3.0, "failed"), (3.5, None, "pending"),
             (10.5, 10.6, "ok")]                       # due after the close
    win = _window(rows)
    lat = stats.latencies_ms(win)
    assert np.allclose(np.sort(lat), 10.0 * np.arange(1, 11))
    assert stats.quantile(lat, 0.5) == pytest.approx(55.0)
    assert stats.quantile(lat, 0.95) == pytest.approx(95.5)
    assert stats.failed(win) == 3


def test_rate_is_over_the_whole_window_and_a_stall_lowers_it():
    class Sched:
        steps = np.full(20, 50)

    steady = _window([(0.0, 0.5 * (k + 1), "ok") for k in range(20)])
    stalled = _window([(0.0, 0.5 * (k + 1) + (4.0 if k >= 5 else 0.0), "ok")
                       for k in range(20)])
    assert stats.steps_per_s(steady, Sched) == pytest.approx(20 * 50 / 10.0)
    assert stats.steps_per_s(stalled, Sched) == pytest.approx(12 * 50 / 10.0)


def test_step_work_counts_the_least_work_from_the_spikes():
    from snnbench.graph import chain_graph

    w = np.array([[3.0, 0.0], [2.0, -1.0], [0.0, 0.0]])
    d = np.array([[1, 1], [1, 1], [1, 1]])
    graph = chain_graph("t", [(w, d)], delay_range=1, alpha=0.5, v_th=2.0)
    sw = step.StepWork(graph)
    payload = np.array([[1, 1, 1], [1, 0, 0], [0, 1, 0], [1, 1, 1]], np.uint8)
    reply = [np.zeros((4, 2), np.float32)]
    ops, n_bytes = sw.request(payload, reply)
    # spikes at steps 0..2 land inside the request: out-degrees 1, 2, 0
    events = (1 + 2) + 1 + 2
    assert ops == 3 * 4 * 2 + events
    assert n_bytes == 4 * (3 + 2) / 8
    assert sw.bound(ops, n_bytes) == max(ops / peaks.INT8_OPS_S,
                                         n_bytes / peaks.HBM_BYTES_S)


class _Work:
    NAMES = ("k_one",)
    __name__ = "k_one_work"

    @staticmethod
    def per_step(graph, forms, batch):
        return [1e-6, 2e-6]


def _run(ops):
    from snnbench.run import Run

    launches = [{"model": "default", "bucket": 10, "batch": 8, "phase": "A",
                 "sup_s": 0.01, "pool_s": 0.008, "bound_s": 1e-5},
                {"model": "default", "bucket": 10, "batch": 8, "phase": "B",
                 "sup_s": 0.01, "pool_s": 0.008}]
    profile = {"busy_s": 0.5, "window_s": 2.0, "ops": ops, "idle": {}}
    exe = types.SimpleNamespace(serial_forms=lambda batch: ())
    return Run(launches=launches, profile=profile, graph=None,
               executables={"default": exe})


@pytest.mark.parametrize("other", ["k_two", "k_three<true"])
def test_mfu_and_roofline_read_the_counted_work_whatever_else_is_profiled(other):
    from snnbench.lookup import metric_reader
    from snnbench.work.roofline import share

    run = _run({"k_one_kernel": [6e-5, 20], other: [1.0, 100]})
    mfu = metric_reader(BASE, "step_mfu.p95").read(run)
    assert mfu == pytest.approx(100 * 1e-5 / 0.01)
    # 10 steps x (1 + 2) us of bound over 60 us of the kernel's calls
    assert share(run, _Work) == pytest.approx(100 * 30e-6 / 6e-5)
    assert metric_reader(BASE, "idle_share.p95").read(run) == pytest.approx(75.0)
    # the profiler kept 10 of the 20 implied calls: the bound scales with them
    run = _run({"k_one_kernel": [3e-5, 10], other: [1.0, 100]})
    assert share(run, _Work) == pytest.approx(100 * 15e-6 / 3e-5)
    # a kernel that did not run leaves its roofline silent
    assert share(_run({other: [1.0, 100]}), _Work) is None



def test_kernel_work_is_counted_from_the_graph_not_the_programs_operands():
    """K3 counts each stored synapse once (8 bytes), a lane's spike of each
    source with a synapse and a lane's current of each (delay, target) pair
    with one: no padded slot.  K2 counts the map's distinct (source, delay)
    columns, K1 each driven population."""
    from snnbench.graph import chain_graph
    from snnbench.work import lif_step, sparse_gather, spike_wdm_project

    w = np.array([[3.0, 0.0, 1.0], [0.0, 0.0, 0.0], [2.0, -1.0, 0.0], [0.0, 0.0, 5.0]])
    d = np.array([[1, 1, 2], [1, 1, 1], [2, 1, 1], [1, 1, 2]])
    graph = chain_graph("t", [(w, d)], delay_range=2, alpha=0.5, v_th=2.0)
    f32, i8 = peaks.F32_FLOPS_S, peaks.INT8_OPS_S
    # 5 synapses; sources 0, 2, 3; (delay, target): (1,0) (2,2) (2,0) (1,1)
    assert sparse_gather.per_step(graph, ("sparse",), 8) == [
        peaks.bound_s(2 * 5 * 8, 8 * 5 + 4 * 8 * (3 + 4), f32)]
    assert sparse_gather.per_step(graph, ("event",), 8) == []
    # columns (source, delay): (0,1) (0,2) (2,2) (2,1) (3,2): M 3, K 5
    assert spike_wdm_project.per_step(graph, ("-",), 4) == [
        peaks.bound_s(2 * 3 * 5 * 4, 3 * 5 + 8 * 5 + 4 * 5 + 4 * 4 * 3, i8)]
    # one driven population of 3, one serial in-edge with a ring of 3 slots
    assert lif_step.per_step(graph, ("sparse",), 2) == [
        peaks.bound_s((3 + 0 + 5) * 6, (12 * 3 + 14) * 6, f32)]
    assert lif_step.per_step(graph, ("-",), 2) == [
        peaks.bound_s((0 + 0 + 5) * 6, (4 + 14) * 6, f32)]
