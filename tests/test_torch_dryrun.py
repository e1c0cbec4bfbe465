"""The port's dry run (``repro_torch.launch.dryrun``, ``shapes``,
``roofline``) against the reference package and against itself, on the
CPU.

The reference's numbers come from ``repro.launch.shapes``,
``repro.launch.roofline`` and the config methods; ``repro.launch.dryrun``
is never imported here (it sets ``XLA_FLAGS`` for 512 host devices when
imported, which would change jax for every later test in the worker).

Counts are exact: a step traced on the meta device must count the same
FLOPs, bytes and peak memory as the same step on CPU tensors, except
where the two devices run different code, K5 (``ssd_chunk``): the CPU runs
its plain version, whose products the counter sees, and the meta device
books :func:`ssd_chunk_cost` once a call.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jax_roofline, shapes as jax_shapes
from repro.models import init as jax_init
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.kernels.ssd_chunk import ops as ssd_ops, ssd_chunk, ssd_chunk_cost
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
from repro_torch.launch import dryrun, roofline, shapes
from repro_torch.launch.hardware import H100, K5_PRECISION
from repro_torch.models import init as minit
from repro_torch.tree import flatten_with_keys, tree_map

KINDS = ("train", "prefill", "decode")
#: the smoke cells' batch and positions (decode: the cache's length)
SMOKE_B, SMOKE_S = 2, 16

SYNTH_HLO = """
HloModule test
  %x = bf16[8,512]{1,0} parameter(0)
  %ar = bf16[8,512]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[16,1024]{1,0} all-gather(%x), replica_groups=[4,8]<=[32], dimensions={0}
  %rs = f32[4,256]{1,0} reduce-scatter(%ag), replica_groups={{0,1}}, to_apply=%add
  %cp = s8[128]{0} collective-permute(%x), source_target_pairs={{0,1}}
  // %dead = bf16[9999,9999] all-reduce(%x)  (comment: must be ignored)
"""


def jax_keys(tree):
    return ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_same_specs(got, want):
    """Port meta tensors against the reference's ShapeDtypeStructs, leaf for
    leaf by JAX key path: shape and dtype."""
    pairs = list(flatten_with_keys(got))
    assert [k for k, _ in pairs] == jax_keys(want)
    for (key, t), w in zip(pairs, jax.tree_util.tree_leaves(want)):
        assert t.device.type == "meta", key
        assert tuple(t.shape) == tuple(w.shape), key
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), key


# -- the parser copy: the reference's own cases --------------------------------------
class TestCollectiveParser:
    def test_bytes_by_type(self):
        stats = roofline.collective_bytes_from_hlo(SYNTH_HLO)
        assert stats.bytes_by_type["all-reduce"] == 8 * 512 * 2
        assert stats.bytes_by_type["all-gather"] == 16 * 1024 * 4
        assert stats.bytes_by_type["reduce-scatter"] == 4 * 256 * 4
        assert stats.bytes_by_type["collective-permute"] == 128
        assert stats.count_by_type["all-reduce"] == 1

    def test_ring_time_positive(self):
        stats = roofline.collective_bytes_from_hlo(SYNTH_HLO, link_bw=50e9)
        # all-reduce over 4 devices: 2*(3/4)*8192B / 50e9
        assert stats.ring_time_s > 8192 * 1.5 / 50e9

    def test_iota_replica_groups(self):
        stats = roofline.collective_bytes_from_hlo(SYNTH_HLO)
        assert stats.bytes_by_type["all-gather"] > 0  # parsed [4,8]<=[32]

    def test_empty(self):
        stats = roofline.collective_bytes_from_hlo("HloModule empty")
        assert stats.total_bytes == 0 and stats.ring_time_s == 0.0


# -- the terms at the H100's peaks ----------------------------------------------------
def test_terms_sum_over_precisions():
    coll = roofline.CollectiveStats({"all-reduce": 100}, {"all-reduce": 1}, 2e-3)
    one = roofline.RooflineTerms(flops=989e12 * 1e-3, hbm_bytes=3.35e12 * 0.5e-3,
                                 collectives=coll, chips=1)
    assert one.compute_s == pytest.approx(1e-3)          # the reference's case
    assert one.memory_s == pytest.approx(0.5e-3)
    assert one.dominant == "collective"
    assert one.roofline_fraction() == pytest.approx(0.5)
    by = {"bfloat16": 989e12 * 1e-3, "float32": 67e12 * 2e-3,
          K5_PRECISION: 495e12 / 3 * 4e-3}
    split = roofline.RooflineTerms(flops=sum(by.values()), hbm_bytes=0.0,
                                   collectives=coll, chips=1, flops_by_dtype=by)
    assert split.compute_s == pytest.approx(7e-3)
    assert split.dominant == "compute" and split.bound_s == split.compute_s
    want = set(jax_roofline.RooflineTerms(1.0, 1.0, coll, 1).to_dict())
    assert set(split.to_dict()) == want | {"flops_by_dtype"}
    with pytest.raises(KeyError, match="float64"):
        H100.peak("float64")


# -- shapes: the reference's specs for every full config --------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_are_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape in shapes.SHAPES:
        assert_same_specs(shapes.batch_specs(cfg, shape),
                          jax_shapes.batch_specs(jcfg, shape))
        if shapes.SHAPES[shape]["kind"] == "decode":
            assert_same_specs(shapes.cache_specs(cfg, shape),
                              jax_shapes.cache_specs(jcfg, shape))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_are_the_references_eval_shape(arch):
    """``param_shapes`` (named ``param_specs`` until the logical-axis tree
    took that name) is the reference's ``eval_shape(init_params)``."""
    want = jax.eval_shape(lambda: jax_init.init_params(jax_get_config(arch),
                                                       jax.random.PRNGKey(0)))
    assert_same_specs(minit.param_shapes(get_config(arch)), want)


def test_param_specs_are_init_params_without_the_draw():
    cfg = smoke_config("olmoe-1b-7b")
    real = list(flatten_with_keys(minit.init_params(cfg, device="cpu")))
    spec = list(flatten_with_keys(minit.param_shapes(cfg)))
    assert [(k, t.shape, t.dtype) for k, t in real] == \
        [(k, t.shape, t.dtype) for k, t in spec]


# -- counts: meta against the same step on CPU tensors ----------------------------------
def on_cpu(args, seed=0):
    """The meta arguments materialized on the CPU, made with NumPy from a
    seed: floats normal * 0.02, integers token ids; a Python int stays."""
    rng = np.random.default_rng(seed)

    def real(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point:
            return torch.from_numpy(rng.normal(size=t.shape) * 0.02).to(t.dtype)
        return torch.from_numpy(rng.integers(0, 200, t.shape)).to(t.dtype)

    return tree_map(real, args)


def k5_calls(monkeypatch):
    """Record the shape of every plain K5 call the CPU makes."""
    calls = []
    plain = ssd_ops.ssd_chunk_ref

    def recording(x, b, c, la):
        calls.append((tuple(x.shape), tuple(b.shape)))
        return plain(x, b, c, la)

    monkeypatch.setattr(ssd_ops, "ssd_chunk_ref", recording)
    return calls


def plain_k5_flops(x_shape, b_shape):
    """FLOPs that ``torch.utils.flop_counter`` sees in one plain K5 call."""
    ops = [torch.zeros(s) for s in (x_shape, b_shape, b_shape, x_shape[:-1])]
    with FlopCounterMode(display=False) as fc:
        ssd_chunk_ref(*ops)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_meta_count_is_the_cpu_count(arch, kind, monkeypatch):
    """FLOPs of a smoke step on the meta device equal the same step's on
    CPU tensors (which equal ``FlopCounterMode``'s there), and so do the
    bytes where both devices run the same code.  Where K5 runs (mamba2's
    train and prefill) the identity is

        meta = cpu - sum over K5 calls of plain_k5_flops(call)
                   + sum over K5 calls of ssd_chunk_cost(call)

    (under remat the recompute calls K5 again on both devices)."""
    cfg = smoke_config(arch)
    step, args = dryrun.cell_step(cfg, kind, SMOKE_B, SMOKE_S)
    meta = dryrun.count_cell(cfg, kind, SMOKE_B, SMOKE_S)
    calls = k5_calls(monkeypatch)
    with FlopCounterMode(display=False) as fc:
        _, cpu = roofline.count_step(step, *on_cpu(args))
    assert cpu.devices == {"cpu"} and meta.devices == {"meta"}
    assert cpu.flops == fc.get_total_flops() > 0
    plain = sum(plain_k5_flops(x, b) for x, b in calls)
    cost = 0
    for x, b in calls:
        g, q, h, p = (1,) * (4 - len(x)) + x
        cost += ssd_chunk_cost(g, q, h, p, b[-1], b[-2])[0]
    assert meta.flops == cpu.flops - plain + cost
    assert meta.flops_by_dtype.get(K5_PRECISION, 0) == cost
    assert bool(calls) == (cfg.ssm is not None and kind != "decode")
    if not calls:
        assert meta.flops_by_dtype == cpu.flops_by_dtype
        assert meta.hbm_bytes == cpu.hbm_bytes


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if a != "mamba2-130m"])
def test_meta_peak_is_the_cpu_peak(arch):
    """MemTracker's peak of a smoke train step, with the arguments tracked
    from before the step: meta and CPU give the same bytes.  (mamba2's CPU
    step runs K5's plain version and its f64 backward sums, which the card
    and the meta device do not.)"""
    cfg = smoke_config(arch)
    step, args = dryrun.cell_step(cfg, "train", SMOKE_B, SMOKE_S)
    meta = dryrun.count_cell(cfg, "train", SMOKE_B, SMOKE_S)
    _, cpu = roofline.count_step(step, *on_cpu(args))
    assert meta.peak_bytes == cpu.peak_bytes
    assert meta.argument_bytes == cpu.argument_bytes
    assert meta.output_bytes == cpu.output_bytes
    assert meta.peak_bytes >= meta.argument_bytes + meta.output_bytes


@pytest.mark.parametrize("arch,kind", [("mamba2-130m", "train"),
                                       ("mamba2-130m", "prefill"),
                                       ("qwen3-8b", "train"),
                                       ("qwen3-8b", "prefill"),
                                       ("recurrentgemma-2b", "decode")])
def test_extrapolation_is_the_direct_count(arch, kind):
    """The reference's affine fit through 1 and 2 block periods, at a depth
    of whole periods, gives the FLOPs the port counts layer by layer, and
    its bytes in prefill and decode.  A train step's bytes grow faster than
    the depth: the gradient of each layer's slice of the stacked
    parameters (``select_backward``) writes, and the sum of them adds, a
    zero-padded tensor of the whole stack, so the fit falls short."""
    cfg = smoke_config(arch)
    period = len(cfg.block_pattern)
    cfg = dataclasses.replace(cfg, n_layers=3 * period)
    direct = roofline.analyze(dryrun.count_cell(cfg, kind, SMOKE_B, SMOKE_S))
    fit = dryrun.extrapolated_terms(cfg, kind, SMOKE_B, SMOKE_S)
    assert fit.flops == direct.flops and fit.flops_by_dtype == direct.flops_by_dtype
    assert fit.compute_s == direct.compute_s and fit.collective_s == 0.0
    if kind == "train":
        assert fit.hbm_bytes < direct.hbm_bytes
    else:
        assert fit.hbm_bytes == direct.hbm_bytes


def test_full_width_trace_stays_on_meta():
    """mamba2-130m x train_4k at full width: every tensor of the trace is
    on the meta device, K5 is booked once a forward and once a recompute,
    and the peak is the record's."""
    cfg = get_config("mamba2-130m")
    count = dryrun.count_cell(cfg, "train", 256, 4096)
    assert count.devices == {"meta"}
    chunks = 256 * 4096 // cfg.ssm.chunk
    h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    k5 = ssd_chunk_cost(chunks, cfg.ssm.chunk, h, cfg.ssm.head_dim,
                        cfg.ssm.d_state, cfg.ssm.n_groups)[0]
    assert count.flops_by_dtype[K5_PRECISION] == 2 * cfg.n_layers * k5
    assert count.peak_bytes > H100.hbm_bytes      # 256 x 4096 does not fit


def test_a_trace_off_the_meta_device_is_an_error(monkeypatch):
    """A CPU tensor with elements fails the cell; an empty one (torch
    2.11's activation checkpointing makes such a placeholder) holds no
    data and does not."""
    def empty_step(params, batch):
        return torch.empty(0), batch["tokens"] + 1

    def cpu_step(params, batch):
        return torch.ones(3) + 1

    cfg = smoke_config("llama3.2-3b")
    monkeypatch.setattr(dryrun.S, "make_prefill_step", lambda cfg, seq: empty_step)
    assert dryrun.count_cell(cfg, "prefill", 1, 8).devices == {"meta"}
    monkeypatch.setattr(dryrun.S, "make_prefill_step", lambda cfg, seq: cpu_step)
    with pytest.raises(RuntimeError, match="cpu"):
        dryrun.count_cell(cfg, "prefill", 1, 8)


# -- K5's meta route -------------------------------------------------------------------
def test_k5_meta_route_gives_shapes_and_launches_nothing():
    f32 = torch.float32
    meta = lambda *s: torch.empty(s, dtype=f32, device="meta")
    before = dict(ssd_ops.LAUNCHES)
    with FlopCounterMode(display=False) as fc:
        y, state = ssd_chunk(meta(3, 8, 4, 5), meta(3, 8, 2, 6), meta(3, 8, 2, 6),
                             meta(3, 8, 4))
    assert y.shape == (3, 8, 4, 5) and state.shape == (3, 4, 6, 5)
    assert y.device.type == state.device.type == "meta" and state.dtype == f32
    assert fc.get_total_flops() == ssd_chunk_cost(3, 8, 4, 5, 6, 2)[0]
    y1, s1 = ssd_chunk(meta(8, 4, 5), meta(8, 4, 6), meta(8, 4, 6), meta(8, 4))
    assert y1.shape == (8, 4, 5) and s1.shape == (4, 6, 5)
    assert ssd_ops.LAUNCHES == before
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(*(torch.empty(s, dtype=torch.bfloat16, device="meta")
                    for s in ((8, 4, 5), (8, 4, 6), (8, 4, 6), (8, 4))))


def test_k5_cost_is_the_count_of_its_products():
    """The scores once a group over j <= i, the decayed scores times X a
    head, and the state: 2 FLOPs a multiply-add; bytes once each."""
    g, q, h, p, n, hg = 2, 4, 6, 3, 5, 2
    flops, n_bytes = ssd_chunk_cost(g, q, h, p, n, hg)
    assert flops == g * (hg * 10 * 2 * n + h * (10 * 2 * p + 2 * q * n * p))
    assert n_bytes == 4 * (2 * g * q * h * p + 2 * g * q * hg * n + g * q * h
                           + g * h * n * p)


# -- run_cell and the CLI ---------------------------------------------------------------
def test_record_keeps_the_references_keys(tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                 "--out", str(out), "--no-extrapolate"])
    assert "dry-run: 1 ok, 0 skipped, 0 errors" in capsys.readouterr().out
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    coll = jax_roofline.CollectiveStats({}, {}, 0.0)
    want = ({"arch", "shape", "mesh", "kind", "variant", "status", "chips",
             "compile_s", "memory_analysis", "tokens_per_step", "active_params",
             "model_flops", "model_flops_ratio", "raw_scan_flops", "terms_source"}
            | set(jax_roofline.RooflineTerms(1.0, 1.0, coll, 1).to_dict()))
    assert want | {"flops_by_dtype", "fits_one_card"} == set(rec)
    # --mesh single: one rank of the reference's 16 x 16 mesh
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["terms_source"] == "counted_every_layer"
    assert rec["collective_s"] > 0.0 and rec["fits_one_card"] is True
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "peak_bytes", "fits_one_card"}
    jcfg = jax_get_config("mamba2-130m")
    assert rec["tokens_per_step"] == jax_shapes.tokens_per_step(jcfg, "long_500k")
    assert rec["active_params"] == jcfg.active_param_count()
    assert rec["model_flops"] == 2.0 * rec["active_params"] * rec["tokens_per_step"]
    assert rec["model_flops_ratio"] == (rec["model_flops"] / rec["chips"]
                                        / rec["flops_per_device"])
    assert rec["flops_per_device"] == sum(rec["flops_by_dtype"].values())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_skips_are_the_references(arch):
    """The sweep skips exactly where the reference's shape_applicable says."""
    jcfg = jax_get_config(arch)
    rec = dryrun.run_cell(arch, "long_500k", verbose=False)
    want = jax_shapes.shape_applicable(jcfg, "long_500k")
    if want is None:
        assert rec["status"] == "ok" and rec["fits_one_card"] in (True, False)
    else:
        assert rec == {"arch": arch, "shape": "long_500k", "mesh": "single",
                       "kind": "decode", "variant": "baseline",
                       "status": "skipped", "reason": want}


def test_opt_dispatch_and_loss_chunk_reach_the_config(monkeypatch):
    seen = []
    monkeypatch.setattr(dryrun, "count_cell",
                        lambda cfg, *a: seen.append(cfg) or (_ for _ in ()).throw(
                            ValueError("stop")))
    rec = dryrun.run_cell("olmoe-1b-7b", "train_4k", opt=True, dispatch="onehot",
                          loss_chunk=256, verbose=False)
    assert rec["status"] == "error" and rec["variant"] == "opt"
    (cfg,) = seen
    assert cfg.moe.dispatch == "onehot" and cfg.loss_chunk == 256
    assert not cfg.attn_f32 and not cfg.norm_f32 and cfg.grad_bf16
