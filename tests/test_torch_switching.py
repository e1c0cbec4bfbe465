"""The port's switching compiler around the dense cap, and its serial
compiler's sparse path, on the CPU.

* Under ``classifier`` and ``ideal`` a CSR projection whose dense form is
  over ``DENSE_ELEMENT_CAP`` compiles serial, ``forced``, the classifier's
  label kept and the fallback counted; an explicit ``parallel`` still
  raises.
* ``compile_serial`` groups the synapses by cell with one stable sort; its
  programs are byte-identical to the former per-cell scan, kept here as
  the oracle, on random projections and on the gesture and cerebellum
  fixtures.
"""
import numpy as np
import pytest

from repro_torch.core import (
    CompileReport,
    LIFParams,
    SwitchingCompiler,
    compile_serial,
    feedforward_network,
)
from repro_torch.core.cost_model import equal_parts, serial_pe_cost, serial_pe_overhead
from repro_torch.core.dataset import LABEL_PARALLEL, LABEL_SERIAL
from repro_torch.core.hw import DEFAULT_S2
from repro_torch.core.layer import (
    DENSE_ELEMENT_CAP,
    DenseStorageError,
    Population,
    SNNNetwork,
    is_sparse,
    random_sparse_projection,
)
from repro_torch.core.serial_compiler import (
    SerialCell,
    SerialProgram,
    _matrix_split_factor,
    pack_rows,
)
from repro_torch.scaffold import build_cerebellum


def old_compile_serial(layer, *, hw=DEFAULT_S2):
    """``compile_serial`` as it was: every cell scans all synapses again
    and grows its master population table a row at a time."""
    src_parts = equal_parts(layer.n_source, hw.max_neurons_per_pe)
    tgt_parts = equal_parts(layer.n_target, hw.max_neurons_per_pe)
    n_src_vertex = len(src_parts)
    src_edges = np.cumsum([0] + src_parts)
    tgt_edges = np.cumsum([0] + tgt_parts)

    sparse = is_sparse(layer)
    if sparse:
        all_src, all_tgt, all_w, all_d = layer.coo()
        cell_a = np.searchsorted(src_edges, all_src, side="right") - 1
        cell_b = np.searchsorted(tgt_edges, all_tgt, side="right") - 1

    cells = []
    for a, sp in enumerate(src_parts):
        s0 = int(src_edges[a])
        for b, tp in enumerate(tgt_parts):
            t0 = int(tgt_edges[b])
            if sparse:
                sel = (cell_a == a) & (cell_b == b)
                si = all_src[sel] - s0
                ti = all_tgt[sel] - t0
                w_sel, d_sel = all_w[sel], all_d[sel]
                rows_per_src = np.bincount(si, minlength=sp)
                cell_elems = sp * tp
            else:
                w = layer.weights[s0 : s0 + sp, t0 : t0 + tp]
                d = layer.delays[s0 : s0 + sp, t0 : t0 + tp]
                conn = w != 0.0
                rows_per_src = conn.sum(axis=1)
                si, ti = np.nonzero(conn)
                w_sel, d_sel = w[si, ti], d[si, ti]
                cell_elems = w.size
            row_start = np.concatenate([[0], np.cumsum(rows_per_src)[:-1]])
            address_list = np.stack([row_start, rows_per_src], axis=1).astype(np.int64)
            packed = pack_rows(w_sel, d_sel, ti)
            mpt = np.array([[a, 0, sp]], dtype=np.int64)
            for extra in range(n_src_vertex - 1):
                mpt = np.vstack([mpt, [extra if extra < a else extra + 1, 0, 0]])
            overhead = serial_pe_overhead(tp, sp, layer.delay_range, n_src_vertex, hw=hw)
            k = min(hw.max_matrix_split,
                    _matrix_split_factor(4.0 * packed.size, overhead, hw))
            cost = serial_pe_cost(tp, sp, (packed.size / max(1, cell_elems)),
                                  layer.delay_range, n_src_vertex, hw=hw, matrix_split=k)
            cells.append(SerialCell(
                src_start=s0, src_size=sp, tgt_start=t0, tgt_size=tp,
                master_population_table=mpt, address_list=address_list,
                synaptic_rows=packed, matrix_split=k, cost=cost))
    return SerialProgram(layer_name=layer.name, n_source=layer.n_source,
                         n_target=layer.n_target, delay_range=layer.delay_range,
                         cells=cells)


def _same_program(new, old):
    assert (new.layer_name, new.n_source, new.n_target, new.delay_range) == (
        old.layer_name, old.n_source, old.n_target, old.delay_range)
    assert len(new.cells) == len(old.cells)
    for c, o in zip(new.cells, old.cells):
        assert (c.src_start, c.src_size, c.tgt_start, c.tgt_size, c.matrix_split,
                c.cost) == (o.src_start, o.src_size, o.tgt_start, o.tgt_size,
                            o.matrix_split, o.cost)
        for name in ("master_population_table", "address_list", "synaptic_rows"):
            x, y = getattr(c, name), getattr(o, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert x.tobytes() == y.tobytes(), name


def _sparse(n_source, n_target, density, delay_range, seed):
    pre, post = Population("a", n_source), Population("b", n_target)
    return random_sparse_projection(pre, post, density, delay_range, seed=seed,
                                    inhibitory_fraction=0.3, name=f"p{seed}")


@pytest.mark.parametrize("shape", [
    (700, 600, 0.05, 4, 1),      # 3 x 3 cells, four delays
    (1200, 300, 0.02, 8, 2),     # 5 x 2 cells
    (256, 256, 0.9, 2, 3),       # dense rows, split matrices
    (40, 1000, 0.0, 1, 4),       # no synapse at all
    (600, 30, 0.001, 3, 5),      # empty cells among full ones
])
def test_sparse_compile_is_byte_identical_to_the_per_cell_scan(shape):
    n_source, n_target, density, delay_range, seed = shape
    proj = _sparse(n_source, n_target, density, delay_range, seed)
    _same_program(compile_serial(proj), old_compile_serial(proj))


@pytest.mark.parametrize("fixture", ["gesture", "cerebellum-1200"])
def test_fixture_programs_are_byte_identical_to_the_per_cell_scan(fixture):
    if fixture == "gesture":
        layers = feedforward_network([2048, 20, 4], density=0.0316,
                                     delay_range=1, seed=0).layers
    else:
        layers = build_cerebellum(1200, seed=90).network.projections
    for layer in layers:
        _same_program(compile_serial(layer), old_compile_serial(layer))


class _Always:
    """A classifier that predicts one label for every layer."""

    def __init__(self, label):
        self.label = label

    def predict(self, feats):
        return np.full(len(feats), self.label)


def _over_cap():
    """A CSR projection of 5000 x 4000 (over the 2**24 cap), 2000 synapses."""
    proj = _sparse(5000, 4000, 1e-4, 3, 9)
    assert proj.n_source * proj.n_target > DENSE_ELEMENT_CAP
    proj.lif = LIFParams(alpha=0.5, v_th=8.0)
    return proj


def _under_cap():
    proj = _sparse(300, 200, 0.05, 2, 10)
    proj.lif = LIFParams(alpha=0.5, v_th=8.0)
    return proj


@pytest.mark.parametrize("policy,label", [
    ("classifier", LABEL_PARALLEL), ("classifier", LABEL_SERIAL), ("ideal", None)])
def test_a_projection_over_the_cap_compiles_serial(policy, label):
    clf = _Always(label) if policy == "classifier" else None
    comp = SwitchingCompiler(policy, clf)
    big, small = _over_cap(), _under_cap()
    got = comp.compile_layer(big)
    assert got.paradigm == "serial" and got.n_compilations == 1
    _same_program(got.program, old_compile_serial(big))
    if policy == "classifier":
        # the classifier's label is kept; only a parallel one is overruled
        assert got.predicted_label == label
        assert got.forced is (label == LABEL_PARALLEL)
    else:
        assert got.predicted_label == LABEL_SERIAL and got.forced
    under = comp.compile_layer(small)
    assert not under.forced
    if policy == "classifier":
        assert under.paradigm == ("parallel" if label == LABEL_PARALLEL else "serial")
    report = CompileReport([got, under, got])
    assert report.cap_fallbacks == 2 * int(got.forced)


def test_an_explicit_parallel_policy_still_raises_over_the_cap():
    with pytest.raises(DenseStorageError):
        SwitchingCompiler("parallel").compile_layer(_over_cap())
    assert not SwitchingCompiler("parallel").compile_layer(_under_cap()).forced


def test_a_network_over_the_cap_compiles_and_runs_under_the_classifier():
    """A two-population graph with a self-loop over the cap: the report
    counts one fallback and the executable runs it on the serial path."""
    from repro_torch.core.runtime import NetworkExecutable

    pops = [Population("in", 5000), Population("out", 4000,
                                                lif=LIFParams(alpha=0.5, v_th=2.0))]
    a = random_sparse_projection(pops[0], pops[1], 1e-3, 2, seed=1, name="in->out")
    b = random_sparse_projection(pops[1], pops[1], 1e-4, 2, seed=2, name="out->out")
    net = SNNNetwork(populations=pops, projections=[a, b])
    report = SwitchingCompiler("classifier", _Always(LABEL_PARALLEL)).compile_network(net)
    assert [l.paradigm for l in report.layers] == ["serial", "parallel"]
    assert report.cap_fallbacks == 1
    x = (np.random.default_rng(0).random((6, 2, 5000)) < 0.2).astype(np.float32)
    outs = NetworkExecutable.build(net, report, device="cpu").run(x)
    assert len(outs) == 2 and outs[0].shape == (6, 2, 4000)
