"""The language models' sharding trees against the reference's, with no
devices; DTensor's block order against ``local_slices``; and the helpers
the multi-rank LM files share.

* ``models.init.param_specs`` is the reference's tree of logical axes for
  all ten archs, leaf for leaf.
* ``launch.steps``' four sharding trees (``param_shardings``,
  ``opt_shardings``, ``batch_shardings``, ``cache_shardings``) give, leaf
  for leaf, the spec that the reference's ``spec_for_shape`` gives over
  the reference's logical trees and shapes, on meshes 16 x 16, 2 x 16 x 16
  and 2 x 2, under ``make_rules`` with and without ``fsdp``, ``seq_axis``
  and ``kv_seq_shard``.  Both sides take a mesh that is only its axis
  sizes (the reference's rules read nothing else of it).
* DTensor's blocks of a dim split over ``("pod", "data")`` are the blocks
  ``local_slices`` (and JAX's ``devices_indices_map``) give: pod-major.

The multi-rank files (``tests/test_torch_lm_mesh_{mamba2,moe,dense,
compressed}.py``) run the sharded train, prefill and decode steps of the
port on four gloo ranks and of the reference on four forced host devices,
through :func:`port_case` and :func:`reference_case`, on the same weights
and batches (:func:`case_inputs`).
"""
import dataclasses
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

import repro.distributed.sharding as RS
import repro_torch.distributed.sharding as PS
from repro.configs import get_config as jax_get_config, smoke_config as jax_smoke_config
from repro.launch import shapes as jax_shapes, steps as jax_steps
from repro.models import init as jax_init
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.launch import steps
from repro_torch.launch.mesh import fake_world
from repro_torch.models import init as minit
from repro_torch.tree import flatten_with_keys

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
RULES = [dict(), dict(fsdp=True), dict(seq_axis="model"), dict(kv_seq_shard=True),
         dict(fsdp=True, seq_axis="data", kv_seq_shard=True)]


class SizesOnly:
    """A mesh that is only its axis sizes (what the rules read)."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


def ref_specs(logical_tree, shape_tree, rules, mesh):
    """The reference's spec for every leaf, as tuples, in JAX's leaf order."""
    return [tuple(RS.spec_for_shape(axes, rules, sds.shape, mesh))
            for axes, sds in zip(
                jax.tree.leaves(logical_tree, is_leaf=lambda x: isinstance(x, tuple)),
                jax.tree.leaves(shape_tree))]


def flat(tree, is_leaf):
    """(key, leaf) in JAX's order (dict keys sorted), stopping at
    ``is_leaf``."""
    if is_leaf(tree):
        return [("", tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("", tree)]
    return [(f"{k}/{kk}" if kk else k, leaf)
            for k, v in items for kk, leaf in flat(v, is_leaf)]


def port_specs(tree):
    return [tuple(s.spec) for _, s in flat(
        tree, lambda x: isinstance(x, PS.NamedSharding))]


# -- the logical tree -----------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_are_the_references(arch):
    want = jax_init.param_specs(jax_get_config(arch))
    got = minit.param_specs(get_config(arch))
    assert got == want
    # and the same tree as param_shapes, leaf for leaf
    shapes = dict(flatten_with_keys(minit.param_shapes(get_config(arch))))
    axes = dict(flat(got, lambda x: isinstance(x, tuple)))
    assert axes.keys() == shapes.keys()
    assert all(len(axes[k]) == shapes[k].ndim for k in axes)


# -- the four sharding trees ------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_sharding_trees_are_the_references(arch, mesh):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sizes = MESHES[mesh]
    jmesh = SizesOnly(sizes)
    multi = "pod" in sizes
    pshapes = jax.eval_shape(lambda: jax_init.init_params(jcfg, jax.random.PRNGKey(0)))
    for kw in RULES:
        if "seq_axis" in kw and kw["seq_axis"] not in sizes:
            continue
        rules = PS.make_rules(multi_pod=multi, **kw)
        assert rules == RS.make_rules(multi_pod=multi, **kw)
        want_p = ref_specs(jax_init.param_specs(jcfg), pshapes, rules, jmesh)
        got_p = steps.param_shardings(cfg, sizes, rules)
        assert port_specs(got_p) == want_p
        opt = steps.opt_shardings(cfg, sizes, rules)
        assert tuple(opt.step.spec) == () and opt.m == got_p and opt.v == got_p
        for shape in jax_shapes.SHAPES:
            b_specs = jax_shapes.batch_specs(jcfg, shape)
            got_b = steps.batch_shardings(cfg, sizes, rules, shape)
            assert got_b.keys() == b_specs.keys()
            for k, sds in b_specs.items():
                want = RS.spec_for_shape(steps.BATCH_AXES[k], rules, sds.shape, jmesh)
                assert tuple(got_b[k].spec) == tuple(want), (shape, k)
            if jax_shapes.SHAPES[shape]["kind"] == "decode":
                want_c = ref_specs(jax_steps.cache_logical_specs(jcfg),
                                   jax_shapes.cache_specs(jcfg, shape), rules, jmesh)
                got_c = steps.cache_shardings(cfg, sizes, rules, shape)
                assert port_specs(got_c) == want_c, shape


def test_rule_variants_move_the_specs():
    """What each rule variant changes, on qwen3-8b over 16 x 16: fsdp splits
    the embed axis over data; kv_seq_shard the caches' positions over model;
    seq_axis the embeds' sequence axis (the audio arch)."""
    cfg, sizes = get_config("qwen3-8b"), MESHES["16x16"]
    base = steps.param_shardings(cfg, sizes, PS.make_rules())
    fsdp = steps.param_shardings(cfg, sizes, PS.make_rules(fsdp=True))
    assert tuple(base["tok_embed"].spec) == ("model", None)
    assert tuple(fsdp["tok_embed"].spec) == ("model", "data")
    c0 = steps.cache_shardings(cfg, sizes, PS.make_rules(), "decode_32k")
    c1 = steps.cache_shardings(cfg, sizes, PS.make_rules(kv_seq_shard=True), "decode_32k")
    assert tuple(c0[0][0]["k"].spec) == (None, "data", None, None, None)
    assert tuple(c1[0][0]["k"].spec) == (None, "data", "model", None, None)
    audio = get_config("musicgen-large")
    b = steps.batch_shardings(audio, sizes, PS.make_rules(seq_axis="model"), "train_4k")
    assert tuple(b["embeds"].spec) == ("data", "model", None)


# -- DTensor's blocks --------------------------------------------------------------------
@pytest.mark.parametrize("spec", [(("pod", "data"), None), (("pod", "data"), "model"),
                                  ("data", ("pod", "model")), (None, "pod")])
def test_dtensor_blocks_are_local_slices(spec):
    """On a fake 2 x 2 x 2 world, each rank's DTensor block of a (16, 8)
    tensor under the spec is ``local_slices``' block at its coordinate:
    axes listed together split major to minor (pod first)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape = (16, 8)
    sizes = {"pod": 2, "data": 2, "model": 2}
    for rank in range(8):
        with fake_world(8, rank=rank):
            mesh = PS._device_mesh(range(8), (2, 2, 2), ("pod", "data", "model"))
            sh = PS.NamedSharding(mesh, PS.P(*spec))
            local, offset = compute_local_shape_and_global_offset(
                shape, mesh, sh.placements)
            coord = PS.mesh_coordinate(mesh)
            want = PS.local_slices(spec, shape, sizes, coord)
            assert tuple(slice(o, o + n) for o, n in zip(offset, local)) == want
            t = torch.arange(128.).reshape(shape)
            block = PS.shard_leaf(t, sh)
            torch.testing.assert_close(block.to_local(), t[want])


def test_placements_refuse_an_order_against_the_mesh():
    with fake_world(8):
        mesh = PS._device_mesh(range(8), (2, 2, 2), ("pod", "data", "model"))
        with pytest.raises(ValueError, match="out of the mesh's order"):
            PS.NamedSharding(mesh, PS.P(("data", "pod"), None)).placements


# -- the multi-rank LM cases ----------------------------------------------------------
#: batch, prompt and cache length of every case; mamba2's chunk is 16, so the
#: prompt's three chunks end in a padded one
B, S, CACHE_LEN, DECODE_STEPS = 4, 40, 44, 2
#: tolerances: the loss; gradients and updated parameters of the leaf's
#: scale (the port's GRAD_TOL); logits and caches (tests/test_torch_lm.py)
LOSS_RTOL, GRAD_TOL, TOL = 1e-5, 1e-4, dict(rtol=1e-4, atol=1e-5)

#: name -> (arch, (data, model), config changes, rule changes)
CASES = {
    "mamba2 2x2": ("mamba2-130m", (2, 2), {}, {}),
    "mamba2 4x1": ("mamba2-130m", (4, 1), {}, {}),
    "mamba2 1x4": ("mamba2-130m", (1, 4), {}, {}),
    "mamba2 2x2 fsdp": ("mamba2-130m", (2, 2), {"fsdp": True}, {}),
    "olmoe sort 2x2": ("olmoe-1b-7b", (2, 2), {}, {}),
    "olmoe sort 2x2 constraints": ("olmoe-1b-7b", (2, 2),
                                   {"moe_shard_constraints": True}, {}),
    "olmoe local 2x2": ("olmoe-1b-7b", (2, 2), {"dispatch": "local"}, {}),
    "olmoe local 4x1": ("olmoe-1b-7b", (4, 1), {"dispatch": "local"}, {}),
    "olmoe local 1x4": ("olmoe-1b-7b", (1, 4), {"dispatch": "local"}, {}),
    "recurrentgemma 2x2": ("recurrentgemma-2b", (2, 2), {}, {}),
    "qwen3 2x2": ("qwen3-8b", (2, 2), {}, {}),
    "qwen3 2x2 kv_seq_shard": ("qwen3-8b", (2, 2), {}, {"kv_seq_shard": True}),
    "qwen3 2x2 seq_axis": ("qwen3-8b", (2, 2), {}, {"seq_axis": "model"}),
}


def case_config(name, smoke):
    """The case's smoke config in one package (MoE capacity 8: no drops)."""
    arch, _mesh, changes, _rules = CASES[name]
    cfg = smoke(arch)
    changes = dict(changes)
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=8.0, dispatch=changes.pop("dispatch", "sort"))
    return dataclasses.replace(cfg, **changes)


def case_rules(name, mod):
    _arch, _mesh, changes, rule_kw = CASES[name]
    return mod.make_rules(fsdp=changes.get("fsdp", False), **rule_kw)


def case_inputs(name):
    """NumPy weights (the port's init, seed 0), the batch, and the decode
    tokens of a case: the same in both packages."""
    from repro_torch.tree import tree_map

    cfg = case_config(name, smoke_config)
    params = tree_map(lambda t: t.numpy(), minit.init_params(cfg, device="cpu"))
    rng = np.random.default_rng(len(name))
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    decode = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
              for _ in range(DECODE_STEPS)]
    return params, batch, decode


def reference_case(name) -> dict:
    """The reference's jitted steps on four host devices under
    ``sharding_ctx``, on a mesh with Auto axes (``jax.sharding.Mesh``:
    ``jax.make_mesh``'s Explicit axes fail ``with_sharding_constraint``,
    ROADMAP §3)."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.models import model as JM
    from repro.optim import AdamWConfig, init_state

    jcfg = case_config(name, jax_smoke_config)
    rules = case_rules(name, RS)
    mesh = Mesh(np.array(jax.devices()).reshape(CASES[name][1]), ("data", "model"))
    params, batch, decode = case_inputs(name)
    params = jax.tree.map(jnp.asarray, params)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    p_sh = jax_steps.param_shardings(jcfg, mesh, rules)
    o_sh = jax_steps.opt_shardings(jcfg, mesh, rules)
    sh = lambda axes, shape: NamedSharding(mesh, RS.spec_for_shape(axes, rules, shape, mesh))
    b_sh = {k: sh(steps.BATCH_AXES[k], v.shape) for k, v in batch.items()}
    caches0 = JM.init_caches(jcfg, B, CACHE_LEN)
    c_sh = RS.tree_shardings(jax_steps.cache_logical_specs(jcfg), caches0, mesh, rules)
    tok_sh = sh(("batch", None), (B, 1))
    host = lambda tree: [np.asarray(x) for x in jax.tree.leaves(tree)]
    out = {}
    with RS.sharding_ctx(mesh, rules):
        vg = jax.jit(lambda p, b: jax.value_and_grad(JM.train_loss)(p, jcfg, b),
                     in_shardings=(p_sh, b_sh), out_shardings=(None, p_sh))
        loss, grads = vg(params, batch)
        out["loss"], out["grads"] = float(loss), host(grads)
        train = jax.jit(jax_steps.make_train_step(jcfg, AdamWConfig()),
                        in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None))
        p2, o2, met = train(params, init_state(params), batch)
        out["train"] = host((p2, o2.m, o2.v)) + [np.asarray(met["loss"])]
        prefill = jax.jit(jax_steps.make_prefill_step(jcfg, CACHE_LEN),
                          in_shardings=(p_sh, b_sh), out_shardings=(None, c_sh))
        logits, caches = prefill(params, batch)
        out["prefill"] = [np.asarray(logits)] + host(caches)
        serve = jax.jit(jax_steps.make_serve_step(jcfg, CACHE_LEN),
                        in_shardings=(p_sh, c_sh, tok_sh, None), out_shardings=(None, c_sh))
        out["decode"] = []
        for i, tok in enumerate(decode):
            logits, caches = serve(params, caches, jnp.asarray(tok), jnp.int32(S + i))
            out["decode"].append(np.asarray(logits))
        out["decode"] += host(caches)
    return out


def port_case(name) -> dict:
    """The port's steps on this rank's DTensor blocks (four gloo ranks),
    gathered: every rank returns the whole outputs."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as PM
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.tree import leaves, tree_map

    cfg = case_config(name, smoke_config)
    rules = case_rules(name, PS)
    d, m = CASES[name][1]
    mesh = make_host_mesh(m)
    assert tuple(mesh.shape) == (d, m)
    params, batch, decode = case_inputs(name)
    params = tree_map(torch.from_numpy, params)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    sh = lambda axes, shape: PS.NamedSharding(mesh, PS.spec_for_shape(axes, rules, shape, mesh))
    b_sh = {k: sh(steps.BATCH_AXES[k], v.shape) for k, v in batch.items()}
    dp = PS.shard_tree(params, steps.param_shardings(cfg, mesh, rules))
    db = PS.shard_tree(batch, b_sh)
    caches0 = PM.init_caches(cfg, B, CACHE_LEN, device="cpu")
    c_sh = PS.tree_shardings(steps.cache_logical_specs(cfg), caches0, mesh, rules)
    host = lambda tree: [t.numpy() for t in leaves(PS.gather_tree(tree))]
    out = {}
    with PS.sharding_ctx(mesh, rules):
        loss, grads = PM.value_and_grad(dp, cfg, db)
        out["loss"], out["grads"] = float(PS.gather_tree(loss)), host(grads)
        st = PS.shard_tree(init_state(params), steps.opt_shardings(cfg, mesh, rules))
        p2, o2, met = steps.make_train_step(cfg, AdamWConfig())(dp, st, db)
        out["train"] = host((p2, o2.m, o2.v)) + [PS.gather_tree(met["loss"]).numpy()]
        logits, caches = steps.make_prefill_step(cfg, CACHE_LEN)(dp, db)
        out["prefill"] = [PS.gather_tree(logits).numpy()] + host(caches)
        # the reference's out_shardings: the caches in their sharding tree
        caches = PS.shard_tree(PS.gather_tree(caches), c_sh)
        serve = steps.make_serve_step(cfg, CACHE_LEN)
        out["decode"] = []
        for i, tok in enumerate(decode):
            dtok = PS.shard_leaf(torch.from_numpy(tok), sh(("batch", None), tok.shape))
            logits, caches = serve(dp, caches, dtok, S + i)
            out["decode"].append(PS.gather_tree(logits).numpy())
        out["decode"] += host(caches)
    return out


def leaf_close(got, want, tol=GRAD_TOL):
    """Each leaf within ``tol`` of its largest reference magnitude, + 1e-7."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        diff = np.abs(g.astype(np.float64) - w)
        assert (diff <= tol * np.abs(w).max() + 1e-7).all(), (diff.max(), np.abs(w).max())


def assert_case(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    leaf_close(got["grads"], want["grads"])
    leaf_close(got["train"], want["train"])
    for key in ("prefill", "decode"):
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g, w, **TOL)


def reference_main(out, *names):
    """Every named case of the reference, pickled to ``out/ref.pkl``."""
    with open(f"{out}/ref.pkl", "wb") as fh:
        pickle.dump({n: reference_case(n) for n in names}, fh)


def rank_main(argv, names, extra=None):
    """One gloo rank: every named case (and ``extra(rank)``'s results),
    pickled to ``out/rank<r>.pkl``."""
    from test_torch_mesh_rules import init_rank

    rank, _world, out = init_rank(argv)
    res = {n: port_case(n) for n in names}
    if extra is not None:
        res.update(extra(rank))
    with open(out / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(res, fh)


def run_cases(tmp, test_file, names):
    """Start the four ranks of ``test_file`` and the reference's process
    for ``names``; returns (the ranks' results, the reference's)."""
    from test_torch_mesh_rules import WORLD, finish, start_ranks, start_reference

    started = start_ranks(test_file, tmp)
    started.append(start_reference("test_torch_lm_mesh_specs", "reference_main",
                                   tmp, *names))
    finish(started)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    with open(tmp / "ref.pkl", "rb") as fh:
        return ranks, pickle.load(fh)
