"""The port's host side equals the reference package's, array for array.

The graph IR, both paradigm compilers, the lowering, the serial form
choice, the paradigm dataset and AdaBoost are NumPy code that the port
keeps as its own copy; these tests hold each copy to the original on the
same seeds.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as P
from repro.core.cost_model import DEFAULT_SERIAL_BATCH_COST as R_COST
from repro.core.runtime import lower_parallel as r_lower_parallel
from repro.core.runtime import lower_serial as r_lower_serial
from repro.core.switching import temporal_character as r_temporal_character
from repro_torch.core.cost_model import DEFAULT_SERIAL_BATCH_COST as P_COST
from repro_torch.core.runtime import lower_parallel as p_lower_parallel
from repro_torch.core.runtime import lower_serial as p_lower_serial
from repro_torch.core.switching import temporal_character as p_temporal_character


def assert_same(a, b, where="value"):
    """Deep equality of two host objects: dataclasses field by field,
    arrays exactly (dtype included), containers item by item."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            if f.compare:
                assert_same(getattr(a, f.name), getattr(b, f.name),
                            f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


NETS = [
    ([2048, 20, 4], 0.0316, 1, 0),      # the gesture network
    ([60, 50, 40], 0.5, 4, 3),
    ([33, 17], 1.0, 8, 11),
]


@pytest.mark.parametrize("sizes,density,delay_range,seed", NETS)
def test_feedforward_network_weights_and_delays(sizes, density, delay_range, seed):
    rn = R.feedforward_network(sizes, density=density, delay_range=delay_range,
                               seed=seed)
    pn = P.feedforward_network(sizes, density=density, delay_range=delay_range,
                               seed=seed)
    assert len(rn.layers) == len(pn.layers)
    for rl, pl in zip(rn.layers, pn.layers):
        np.testing.assert_array_equal(rl.weights, pl.weights)
        np.testing.assert_array_equal(rl.delays, pl.delays)
        assert rl.delay_range == pl.delay_range
        assert_same(rl.character(), pl.character())
    assert rn.topo_order == pn.topo_order
    assert rn.input_slices == pn.input_slices


LAYERS = [
    (40, 30, 0.3, 4, "source"),
    (64, 48, 0.6, 1, "synapse"),
    (100, 80, 0.15, 8, "synapse"),
    (33, 17, 1.0, 3, "source"),
    (2048, 20, 0.0316, 1, "source"),
    (20, 10, 0.0, 2, "source"),         # empty layer
]


def _pair(ns, nt, dens, dr, gran, seed=0):
    return (
        R.random_layer(ns, nt, dens, dr, seed=seed, delay_granularity=gran),
        P.random_layer(ns, nt, dens, dr, seed=seed, delay_granularity=gran),
    )


@pytest.mark.parametrize("ns,nt,dens,dr,gran", LAYERS)
def test_compiled_programs_equal(ns, nt, dens, dr, gran):
    rl, pl = _pair(ns, nt, dens, dr, gran)
    assert_same(R.compile_serial(rl), P.compile_serial(pl), "serial")
    assert_same(R.compile_parallel(rl), P.compile_parallel(pl), "parallel")
    assert R.serial_pe_count(rl.character()) == P.serial_pe_count(pl.character())
    assert R.serial_pe_count_exact(rl) == P.serial_pe_count_exact(pl)
    assert R.parallel_pe_count_exact(rl) == P.parallel_pe_count_exact(pl)


@pytest.mark.parametrize("ns,nt,dens,dr,gran", LAYERS)
def test_lowered_operands_equal(ns, nt, dens, dr, gran):
    rl, pl = _pair(ns, nt, dens, dr, gran)
    rs = r_lower_serial(R.compile_serial(rl))
    ps = p_lower_serial(P.compile_serial(pl), device="cpu")
    for name in ("row_weight", "row_delay", "row_src", "row_tgt"):
        np.testing.assert_array_equal(np.asarray(getattr(rs, name)),
                                      getattr(ps, name).numpy(), err_msg=name)
        assert np.asarray(getattr(rs, name)).dtype == getattr(ps, name).numpy().dtype
    rp = r_lower_parallel(R.compile_parallel(rl))
    pp = p_lower_parallel(P.compile_parallel(pl), device="cpu")
    for name in ("wdm_stack", "col_source", "col_delay"):
        np.testing.assert_array_equal(np.asarray(getattr(rp, name)),
                                      getattr(pp, name).numpy(), err_msg=name)
        assert np.asarray(getattr(rp, name)).dtype == getattr(pp, name).numpy().dtype
    assert (rp.n_source, rp.n_target, rp.delay_range) == (
        pp.n_source, pp.n_target, pp.delay_range)


def test_choose_form_grid():
    """The three-way serial form choice, over (rows, S, T, D, B)."""
    assert R_COST.as_dict() == P_COST.as_dict()
    seen = set()
    for rows in (0, 3, 60, 1279, 20_000, 400_000):
        for s in (20, 300, 2048, 20_000):
            for t in (4, 20, 300, 5_000):
                for d in (1, 4, 16):
                    for b in (1, 2, 3, 8, 64, 256):
                        want = R_COST.choose_form(rows, s, t, d, b)
                        assert P_COST.choose_form(rows, s, t, d, b) == want, (
                            rows, s, t, d, b)
                        seen.add(want)
                        assert (P_COST.dense_fits(s, t, d)
                                == R_COST.dense_fits(s, t, d))
    assert seen == {"event", "sparse", "dense"}


def test_choose_form_fourway_grid():
    """The four-way choice with a step count (temporal competing), with
    and without ``allow_temporal``, and the whole-train operand choice."""
    seen = set()
    for rows in (0, 60, 1279, 20_000, 400_000):
        for s in (20, 2048, 20_000):
            for t in (4, 20, 5_000):
                for d in (1, 4):
                    for b in (1, 8, 64):
                        for steps in (None, 2, 16, 256, 4096, 10**6):
                            for allow in (True, False):
                                want = R_COST.choose_form(
                                    rows, s, t, d, b, steps=steps,
                                    allow_temporal=allow)
                                assert P_COST.choose_form(
                                    rows, s, t, d, b, steps=steps,
                                    allow_temporal=allow) == want, (
                                    rows, s, t, d, b, steps, allow)
                                seen.add(want)
                        assert P_COST.temporal_operand(rows, s, t, d, b) == (
                            R_COST.temporal_operand(rows, s, t, d, b))
    assert seen == {"event", "sparse", "dense", "temporal"}


@pytest.mark.parametrize("alpha,v_th", [(0.0, 64.0), (0.5, 64.0), (1.0, 64.0),
                                        (1.0, 64.5), (0.9, 1.0)])
@pytest.mark.parametrize("inhib", [0.0, 0.3])
def test_temporal_character_equal(alpha, v_th, inhib):
    """The temporal eligibility features, dense and CSR layers alike."""
    for make in ("random_projection", "random_sparse_projection"):
        pops = [(m.Population("a", 30), m.Population("b", 12)) for m in (R, P)]
        rl, pl = (
            getattr(mod, make)(a, b, 0.3, 3, seed=5, inhibitory_fraction=inhib)
            for mod, (a, b) in zip((R.layer, P.layer), pops)
        )
        rl.lif = R.LIFParams(alpha=alpha, v_th=v_th)
        pl.lif = P.LIFParams(alpha=alpha, v_th=v_th)
        rc, pc = r_temporal_character(rl), p_temporal_character(pl)
        assert_same(pc["character"], rc["character"], make)
        assert {k: pc[k] for k in ("mode", "exact", "nonneg_weights")} == {
            k: rc[k] for k in ("mode", "exact", "nonneg_weights")}
        assert pc["nonneg_weights"] == (inhib == 0.0)


GRID = dict(
    source_grid=(50, 300, 2048), target_grid=(10, 20, 100),
    density_grid=(0.03, 0.1, 0.5, 0.9), delay_grid=(1, 4), seed=0,
)


def test_dataset_and_adaboost_predictions_equal():
    rds, pds = R.generate_dataset(**GRID), P.generate_dataset(**GRID)
    assert_same(rds, pds, "dataset")
    rclf, racc = R.train_switch_classifier(rds, seed=0)
    pclf, pacc = P.train_switch_classifier(pds, seed=0)
    assert racc == pacc
    probe = np.random.default_rng(5).uniform(
        [10, 4, 0.0, 1], [3000, 400, 1.0, 16], (400, 4)
    )
    X = np.concatenate([rds.features, probe])
    np.testing.assert_array_equal(rclf.predict(X), pclf.predict(X))
    np.testing.assert_array_equal(rclf.decision_function(X),
                                  pclf.decision_function(X))
    # the classifier prejudges the gesture net's projections alike
    rn = R.feedforward_network([2048, 20, 4], density=0.0316, delay_range=1, seed=0)
    pn = P.feedforward_network([2048, 20, 4], density=0.0316, delay_range=1, seed=0)
    rr = R.SwitchingCompiler("classifier", rclf).compile_network(rn)
    pr = P.SwitchingCompiler("classifier", pclf).compile_network(pn)
    assert [l.paradigm for l in rr.layers] == [l.paradigm for l in pr.layers]
    assert rr.total_pes == pr.total_pes


@pytest.mark.parametrize("policy", ["serial", "parallel", "ideal"])
def test_switching_policies_equal(policy):
    rn = R.feedforward_network([2048, 20, 4], density=0.0316, delay_range=1, seed=0)
    pn = P.feedforward_network([2048, 20, 4], density=0.0316, delay_range=1, seed=0)
    rr = R.SwitchingCompiler(policy).compile_network(rn)
    pr = P.SwitchingCompiler(policy).compile_network(pn)
    for rc, pc in zip(rr.layers, pr.layers):
        assert (rc.paradigm, rc.predicted_label, rc.pe_count, rc.n_compilations,
                rc.host_bytes_peak) == (pc.paradigm, pc.predicted_label,
                                        pc.pe_count, pc.n_compilations,
                                        pc.host_bytes_peak)
        assert_same(rc.program, pc.program, policy)


#: the per-arch config modules (src/repro/configs/*.py besides the registry)
CONFIG_MODULES = ["mamba2_130m", "musicgen_large", "kimi_k2_1t_a32b", "olmoe_1b_7b",
                  "phi3_medium_14b", "llama3_2_3b", "qwen1_5_4b", "qwen3_8b",
                  "recurrentgemma_2b", "phi3_vision_4_2b"]


@pytest.mark.parametrize("module", CONFIG_MODULES)
def test_config_module_copies_equal(module):
    """Each per-arch module is the original with only its import lines
    changed, and gives the same CONFIG and SMOKE."""
    import importlib
    from pathlib import Path

    r = importlib.import_module(f"repro.configs.{module}")
    p = importlib.import_module(f"repro_torch.configs.{module}")
    assert_same(r.CONFIG, p.CONFIG, f"{module}.CONFIG")
    assert_same(r.SMOKE, p.SMOKE, f"{module}.SMOKE")

    def body(m):
        return [line for line in Path(m.__file__).read_text().splitlines()
                if not line.startswith(("from ", "import "))]

    assert body(r) == body(p)


def test_data_pipeline_copy_is_the_reference():
    """``repro_torch.data.pipeline`` is the original with only its import
    lines changed."""
    from pathlib import Path

    import repro.data.pipeline as r
    import repro_torch.data.pipeline as p

    def body(m):
        return [line for line in Path(m.__file__).read_text().splitlines()
                if not line.startswith(("from ", "import "))]

    assert body(r) == body(p)


@pytest.mark.parametrize("vocab,seq,batch,n_hosts,host_id", [
    (50280, 1024, 8, 1, 0), (256, 32, 4, 1, 0), (256, 40, 6, 2, 1), (7, 5, 3, 3, 2)])
def test_synthetic_lm_batches_are_the_references_bit_for_bit(vocab, seq, batch,
                                                             n_hosts, host_id):
    from repro.data import DataConfig as RConfig, SyntheticLM as RLM
    from repro_torch.data import DataConfig as PConfig, SyntheticLM as PLM

    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, n_hosts=n_hosts,
              host_id=host_id)
    r, p = RLM(RConfig(**kw)), PLM(PConfig(**kw))
    for step in (0, 1, 15, 29):
        want, got = r.batch_at(step), p.batch_at(step)
        assert got.keys() == want.keys() == {"tokens"}
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    p.load_state_dict({"step": 3})
    r.load_state_dict({"step": 3})
    for _, a, b in zip(range(2), iter(p), iter(r)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert p.state_dict() == r.state_dict() == {"step": 4}
    assert p.local_batch == r.local_batch == batch // n_hosts


# -- the dry run's host copies: the HLO collective parser and the shapes ----------------
#: tests/test_roofline.py's SYNTH_HLO and more lines: the async form, a tuple
#: result, all-to-all, a group given by the iota form, one given by no form
#: (the default group), an unknown dtype (no bytes) and a comment
HLO_LINES = [
    "  %ar = bf16[8,512]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add",
    "  %ag = f32[16,1024]{1,0} all-gather(%x), replica_groups=[4,8]<=[32], dimensions={0}",
    "  %rs = f32[4,256]{1,0} reduce-scatter(%ag), replica_groups={{0,1}}, to_apply=%add",
    "  %cp = s8[128]{0} collective-permute(%x), source_target_pairs={{0,1}}",
    "  // %dead = bf16[9999,9999] all-reduce(%x)  (comment: must be ignored)",
    "  %ars = (bf16[64]{0}, bf16[64]{0}) all-reduce-start(%a, %b), replica_groups={{0,1}}",
    "  %a2a = (f32[8,32]{1,0}, f32[8,32]{1,0}) all-to-all(%p, %q), replica_groups={{0,1,2,3,4,5,6,7}}",
    "  %agd = u8[1000]{0} all-gather(%y), dimensions={0}",
    "  %ags = (s32[3,5]{1,0}, f32[]) all-gather-start(%z), replica_groups=[2,16]<=[32]",
    "  %odd = token[] all-reduce(%t), replica_groups={{0,1}}",
    "  %cps = f8e4m3fn[2,2,2]{2,1,0} collective-permute-start(%w), source_target_pairs={{1,0}}",
    "  %add.1 = f32[8]{0} add(%u, %v)",
]


@pytest.mark.parametrize("lines", [HLO_LINES[:5], HLO_LINES, HLO_LINES[5:], []])
@pytest.mark.parametrize("link_bw,group", [(50e9, 16), (450e9, 4)])
def test_collective_parser_copy_is_the_reference(lines, link_bw, group):
    from repro.launch import roofline as r
    from repro_torch.launch import roofline as p

    text = "HloModule test\n" + "\n".join(lines)
    want = r.collective_bytes_from_hlo(text, link_bw=link_bw, default_group=group)
    got = p.collective_bytes_from_hlo(text, link_bw=link_bw, default_group=group)
    assert got.bytes_by_type == want.bytes_by_type
    assert got.count_by_type == want.count_by_type
    assert got.ring_time_s == want.ring_time_s
    assert got.total_bytes == want.total_bytes


def test_roofline_helpers_are_the_references():
    from repro.launch import roofline as r
    from repro_torch.launch import roofline as p

    assert p._DTYPE_BYTES == r._DTYPE_BYTES and p._COLLECTIVES == r._COLLECTIVES
    for name in ("_SHAPE_RE", "_GROUPS_RE", "_GROUPS_IOTA_RE"):
        assert getattr(p, name).pattern == getattr(r, name).pattern, name
    for dtype in list(r._DTYPE_BYTES) + ["token", "xyz"]:
        for dims in ("", "7", "3,5", "2,0,4"):
            assert p._shape_bytes(dtype, dims) == r._shape_bytes(dtype, dims)
    for op in r._COLLECTIVES:
        for n in (0, 1, 2, 4, 16, 512):
            assert p._ring_factor(op, n) == r._ring_factor(op, n)


@pytest.mark.parametrize("arch", [
    "mamba2-130m", "musicgen-large", "kimi-k2-1t-a32b", "olmoe-1b-7b",
    "phi3-medium-14b", "llama3.2-3b", "qwen1.5-4b", "qwen3-8b",
    "recurrentgemma-2b", "phi-3-vision-4.2b"])
def test_shapes_copies_are_the_references(arch):
    """SHAPES, Cell, shape_applicable and tokens_per_step over every shape,
    on the full config and the smoke config."""
    from repro.configs import get_config as r_config, smoke_config as r_smoke
    from repro.launch import shapes as r
    from repro_torch.configs import get_config as p_config, smoke_config as p_smoke
    from repro_torch.launch import shapes as p

    assert p.SHAPES == r.SHAPES
    for (rc, pc) in ((r_config(arch), p_config(arch)), (r_smoke(arch), p_smoke(arch))):
        for shape in r.SHAPES:
            assert p.Cell(arch, shape).kind == r.Cell(arch, shape).kind
            assert p.shape_applicable(pc, shape) == r.shape_applicable(rc, shape)
            assert p.tokens_per_step(pc, shape) == r.tokens_per_step(rc, shape)
