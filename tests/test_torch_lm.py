"""The port's attention, RG-LRU and MoE serving slice against the reference
package, on the CPU.

Every arch of the registry is served by ``repro_torch.models`` and held to
``repro.models`` on the same weights, carried over with
``convert.lm_params_from_numpy``: the blocks' pieces (``rope``, attention
streamed over Q blocks, the MLPs, both MoE dispatches, the RG-LRU scan),
one layer of each of ``attn`` and ``rglru`` at recurrentgemma-2b's full
widths, and each smoke config's prefill then three greedy decode steps.
Every input is made with NumPy from a seed.

Tolerances: both packages run in float32 and differ only in summation
order and in the last bit of ``pow``/``cos``/``sin``: logits and caches
within ``rtol = 1e-4, atol = 1e-5`` (as ``tests/test_torch_ssd.py``),
greedy tokens equal.  Measured: about 2e-7 on the smoke logits (scale
0.4-0.6).  The RG-LRU scan, which uses the reference's own recursion, is
held bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import blocks as jax_blocks
from repro.models import init as jax_init
from repro.models import model as jax_model
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import blocks, init as minit, model as M

TOL = dict(rtol=1e-4, atol=1e-5)


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def to_torch(tree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def smoke_pair(arch):
    """The arch's smoke config in both packages, at the reference's smoke
    settings (``tests/test_models_smoke.py``): MoE capacity 8.0."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    if cfg.moe is not None:
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=8.0)) for c in (cfg, jcfg))
    return cfg, jcfg


def make_batch(cfg, b, s, seed):
    """Tokens, and the stub frontends' embeddings as the reference's smoke
    tests draw them (NumPy arrays)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (rng.normal(
            size=(b, cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.frontend == "audio":
        batch = {"embeds": (rng.normal(size=(b, s, cfg.d_model)) * 0.02
                            ).astype(np.float32)}
    return batch


def assert_trees_close(got, want):
    got_leaves = jax.tree.leaves(got, is_leaf=torch.is_tensor)
    want_leaves = jax.tree.leaves(want)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got, is_leaf=torch.is_tensor))
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape
        close(g, w)


# -- the blocks' pieces ----------------------------------------------------------
@pytest.mark.parametrize("theta,hd,start", [(10000.0, 16, 0), (500000.0, 256, 1000)])
def test_rope_matches_jax(theta, hd, start):
    x = np.random.default_rng(hd).normal(size=(2, 9, 3, hd)).astype(np.float32)
    want = jax_blocks.rope(jnp.asarray(x), jnp.arange(start, start + 9), theta)
    got = blocks.rope(torch.from_numpy(x), torch.arange(start, start + 9), theta)
    close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window,q_block", [(None, 512), (None, 16), (8, 16), (8, 7)])
@pytest.mark.parametrize("attn_f32", [True, False])
def test_attention_seq_matches_jax(window, q_block, attn_f32):
    """GQA (4 query heads on 2 KV heads) over 40 positions, in one Q block
    or streamed over several (the last one short), with and without a
    window; ``attn_f32=False`` on bf16 operands (its f32 accumulation)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 40, h, 16)).astype(np.float32) for h in (4, 2, 2))
    dt = jnp.float32 if attn_f32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, dt) for a in (q, k, v))
    want = jax_blocks.attention_seq(jq, jk, jv, window=window, q_block=q_block,
                                    attn_f32=attn_f32)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dt.dtype.name)) for a in (jq, jk, jv))
    got = blocks.attention_seq(tq, tk, tv, window=window, q_block=q_block,
                               attn_f32=attn_f32)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL if attn_f32 else dict(rtol=1e-2, atol=1e-2)
    close(got.float(), want.astype(jnp.float32), **tol)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_forward_matches_jax(act):
    """gelu is jax.nn.gelu's default: the tanh approximation."""
    cfg = dataclasses.replace(smoke_config("llama3.2-3b"), act=act)
    jcfg = dataclasses.replace(jax_smoke_config("llama3.2-3b"), act=act)
    rng = np.random.default_rng(1)
    p = {"w_gate": rng.normal(size=(64, 128)), "w_up": rng.normal(size=(64, 128)),
         "w_down": rng.normal(size=(128, 64)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    want = jax_blocks.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), jcfg)
    got = blocks.mlp_forward({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg)
    close(got, want)


def moe_pair(arch, **moe):
    """The arch's smoke config in both packages with ``moe`` changed, and
    the reference's first layer's MoE weights in both."""
    cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
                 for c in (smoke_config(arch), jax_smoke_config(arch)))
    p = jax_init.init_params(jcfg, jax.random.PRNGKey(5))["groups"][0][0]
    ffn = {k.split(".", 1)[1]: v[0] for k, v in p.items() if k.startswith("ffn.")}
    return cfg, jcfg, ffn, to_torch(ffn)


@pytest.mark.parametrize("capacity", [1.25, 8.0])
@pytest.mark.parametrize("dispatch", ["sort", "onehot", "local"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_moe_forward_matches_jax(arch, dispatch, capacity):
    """Both dispatches against the reference's at the published capacity
    (1.25: pairs are dropped, in the stable sort's order) and at 8.0; the
    port's ``local`` is the reference's own fallback with no sharding
    context (the sort), so it is held to the sort only."""
    cfg, jcfg, jp, tp = moe_pair(arch, capacity_factor=capacity, dispatch=dispatch)
    x = np.random.default_rng(3).normal(size=(2, 24, 64)).astype(np.float32)
    jfn = {"sort": jax_blocks.moe_forward_sort, "local": jax_blocks.moe_forward_sort,
           "onehot": jax_blocks.moe_forward_onehot}[dispatch]
    want = jfn(jp, jnp.asarray(x), jcfg)
    got = blocks.ffn_forward(tp, torch.from_numpy(x), cfg)
    close(got, want)
    if dispatch == "sort" and capacity == 8.0:
        # the reference's test_moe_dispatch_paths_agree, on the port
        onehot = blocks.moe_forward_onehot(tp, torch.from_numpy(x), cfg)
        close(got, onehot.numpy())


def test_moe_drops_follow_the_stable_order():
    """At capacity 1.25 some routed pairs are dropped: the port drops the
    same ones (its output differs from the no-drop output exactly where
    the reference's does)."""
    lo, jlo, jp, tp = moe_pair("olmoe-1b-7b", capacity_factor=1.25)
    hi, jhi, _, _ = moe_pair("olmoe-1b-7b", capacity_factor=8.0)
    x = np.random.default_rng(4).normal(size=(2, 24, 64)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    # a token that lost a pair moves by far more than the rounding of
    # another capacity's buffer shapes
    j_dropped = np.abs(np.asarray(jax_blocks.moe_forward_sort(jp, jx, jlo)
                                  - jax_blocks.moe_forward_sort(jp, jx, jhi))).max(-1) > 1e-5
    t_dropped = (blocks.moe_forward_sort(tp, tx, lo) - blocks.moe_forward_sort(tp, tx, hi)
                 ).abs().amax(-1).numpy() > 1e-5
    assert j_dropped.any()
    np.testing.assert_array_equal(t_dropped, j_dropped)


def test_routing_ties_go_to_the_lower_index():
    """jax.lax.top_k keeps the lower expert index among equal probabilities."""
    m = smoke_config("olmoe-1b-7b").moe                    # 8 experts, top 2
    router = np.zeros((4, 8), np.float32)
    router[0, [1, 5, 6]] = 1.0                             # a three-way tie
    router[1, [0, 7]] = 1.0
    router[2, 3] = 1.0                                     # one, then a 7-way tie
    xf = np.eye(4, dtype=np.float32)
    probs = jax.nn.softmax(jnp.asarray(xf @ router), axis=-1)
    want_w, want_e = jax.lax.top_k(probs, m.top_k)
    got_w, got_e = blocks._route(torch.from_numpy(router), torch.from_numpy(xf), m)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    close(got_w, want_w / want_w.sum(-1, keepdims=True), rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 33, 300])
def test_associative_scan_is_the_references_bitwise(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.9, 1.0, (2, n, 7)).astype(np.float32)
    b = rng.normal(size=(2, n, 7)).astype(np.float32)

    def combine(e1, e2):
        return e2[0] * e1[0], e2[0] * e1[1] + e2[1]

    wa, wb = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ga, gb = blocks._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))


# -- one layer at recurrentgemma-2b's full widths ---------------------------------
@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("btype", ["attn", "rglru"])
def test_full_width_layer_matches_jax(btype, mode):
    """d 2560, 10 heads on 1 KV head of 256, window 2048, d_ff 7680, d_rnn
    2560; b = 2, s = 600 (two Q blocks of 512, the second short), then one
    decode step from the prefill's cache."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), dtype="float32",
                              n_layers=1, block_pattern=(btype,))
    jcfg = dataclasses.replace(jax_get_config("recurrentgemma-2b"), dtype="float32",
                               n_layers=1, block_pattern=(btype,), vocab=256)
    jp = jax.tree.map(lambda a: a[0], jax_init.init_params(
        jcfg, jax.random.PRNGKey(2))["groups"][0][0])
    tp = to_torch(jp)
    rng = np.random.default_rng(6)
    s, cache_len = 600, 608
    x = (rng.normal(size=(2, s, 2560)) * 0.5).astype(np.float32)
    jfwd = getattr(jax_blocks, f"{btype}_forward")
    kw = {"pos": 0, "cache_len": cache_len} if btype == "attn" else {}
    jy, jc = jfwd(jp, jnp.asarray(x), jcfg, mode=mode, cache=None, **kw)
    ty, tc = getattr(blocks, f"{btype}_forward")(tp, torch.from_numpy(x), cfg,
                                                 mode=mode, cache=None, **kw)
    close(ty, jy)
    if mode == "train":
        assert jc is None and tc is None
        return
    assert_trees_close(tc, jc)
    tok = (rng.normal(size=(2, 1, 2560)) * 0.5).astype(np.float32)
    kw = {"pos": s, "cache_len": cache_len} if btype == "attn" else {}
    jy, jc = jfwd(jp, jnp.asarray(tok), jcfg, mode="decode", cache=jc, **kw)
    ty, tc = getattr(blocks, f"{btype}_forward")(tp, torch.from_numpy(tok), cfg,
                                                 mode="decode", cache=tc, **kw)
    close(ty, jy)
    assert_trees_close(tc, jc)


# -- every arch's smoke model ----------------------------------------------------
def serve_both(arch, seq, steps=3, seed=0):
    """Prefill a b = 2 prompt of ``seq`` tokens then ``steps`` greedy decode
    steps in both packages on the reference's weights; every step's logits
    and caches are compared, and the greedy tokens must agree."""
    cfg, jcfg = smoke_pair(arch)
    jp = jax_init.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = to_torch(jp)
    batch = make_batch(cfg, 2, seq, seed)
    cache_len = 16 if seq == 12 else seq + 4 + cfg.n_frontend_tokens
    jl, jc = jax_model.prefill(jp, jcfg, jax.tree.map(jnp.asarray, batch), cache_len)
    tl, tc = M.prefill(tp, cfg, jax.tree.map(torch.from_numpy, batch), cache_len)
    assert tl.shape == (2, 1, cfg.vocab)
    close(tl, jl)
    assert_trees_close(tc, jc)
    pos = seq + cfg.n_frontend_tokens
    toks = []
    for step in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0])
        toks.append(tok)
        jl, jc = jax_model.decode_step(jp, jcfg, jnp.asarray(tok),
                                       jnp.int32(pos + step), jc, cache_len)
        tl, tc = M.decode_step(tp, cfg, torch.from_numpy(tok), pos + step, tc,
                               cache_len)
        close(tl, jl)
        assert_trees_close(tc, jc)
    return cfg, tp, batch, cache_len, np.concatenate(toks, 1), tl


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_model_prefill_and_decode_match_jax(arch):
    """b 2, s 12, cache 16 (the reference's smoke settings; for the vision
    arch the 8 patch tokens put the prompt past the cache, which the
    reference's ring handles as it does a window)."""
    serve_both(arch, 12)


@pytest.mark.parametrize("seq", [32, 40])
def test_window_ring_offset_matches_the_reference(seq):
    """recurrentgemma's smoke window is 32.  Prefill keeps position p at
    ring slot p - (s - w) and decode writes slot pos % w: the two agree
    when w divides s (s = 32), and at s = 40 decode attends over the wrong
    keys.  The port reproduces the reference's decode either way (held in
    ``serve_both``), so it differs from a prefill of the prompt plus the
    token exactly as much as the reference does."""
    cfg, tp, batch, cache_len, toks, tl = serve_both("recurrentgemma-2b", seq,
                                                     steps=1)
    full = {"tokens": np.concatenate([batch["tokens"], toks], 1)}
    want, _ = M.prefill(tp, cfg, jax.tree.map(torch.from_numpy, full), cache_len)
    fault = float((tl - want).abs().max())
    if seq % 32 == 0:
        assert fault < 1e-5
    else:
        assert fault > 1e-3                  # 1.8e-2 at logits of scale 0.5


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_params_follow_the_reference_rules(arch):
    cfg = smoke_config(arch)
    tp = minit.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    shapes = jax.eval_shape(lambda: jax_init.init_params(
        jax_smoke_config(arch), jax.random.PRNGKey(0)))
    assert jax.tree.structure(shapes) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp, is_leaf=torch.is_tensor))
    for g, w in zip(jax.tree.leaves(tp, is_leaf=torch.is_tensor),
                    jax.tree.leaves(shapes)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    # every leaf against the reference's own rule: a leaf that two keys
    # draw alike is a constant (ones, zeros, the A_log and lam ramps) and
    # must be the reference's; the others are normal at the rule's scale
    jp0, jp1 = (jax_init.init_params(jax_smoke_config(arch), jax.random.PRNGKey(k))
                for k in (0, 1))
    other = minit.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    deep = 0.02 / (2 * cfg.n_layers) ** 0.5
    for gi, group in enumerate(tp["groups"]):
        for ti, blk in enumerate(group):
            for name, leaf in blk.items():
                want = np.asarray(jp0["groups"][gi][ti][name])
                if np.array_equal(want, np.asarray(jp1["groups"][gi][ti][name])):
                    np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-6,
                                               err_msg=name)
                    continue
                assert not torch.equal(leaf, other["groups"][gi][ti][name]), name
                scale = (deep if name.split(".")[-1] in
                         ("wo", "w_down", "out_proj", "w_out") else 0.02)
                assert abs(float(leaf.std()) - scale) < 0.2 * scale, name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_caches_match_the_reference(arch):
    cfg = smoke_config(arch)
    got = M.init_caches(cfg, 3, 20, device="cpu")
    want = jax_model.init_caches(jax_smoke_config(arch), 3, 20)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got, is_leaf=torch.is_tensor))
    for g, w in zip(jax.tree.leaves(got, is_leaf=torch.is_tensor),
                    jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_lm_params_from_numpy_carries_every_leaf(arch):
    """Every leaf of the arch's tree (``ffn.*``, the MoE's 3-D expert
    stacks, ``q_norm``/``k_norm``, the RG-LRU gates) in the published
    bf16, bit for bit."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="bfloat16")
    jp = jax_init.init_params(jcfg, jax.random.PRNGKey(1))
    tp = to_torch(jp)
    want = jax.tree.leaves(jp)
    got = jax.tree.leaves(tp, is_leaf=torch.is_tensor)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))


# -- the launcher ----------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_main_smoke_on_cpu(arch, capsys, monkeypatch):
    """Every arch at ``--smoke --device cpu``; the prompt and the frontends'
    embeddings are the reference launcher's draws for the seed."""
    seen = {}
    prefill = M.prefill

    def spy(params, cfg, batch, cache_len):
        seen.update(batch)
        return prefill(params, cfg, batch, cache_len)

    monkeypatch.setattr(serve.M, "prefill", spy)
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "10", "--gen", "3", "--seed", "4"])
    assert set(out) == {"prefill_s", "decode_tok_per_s", "tokens"}
    assert out["tokens"].shape == (2, 3)
    assert ((0 <= out["tokens"]) & (out["tokens"] < 256)).all()
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"arch={arch}-smoke batch=2: prefill ")
    # the reference's draws (src/repro/launch/serve.py), seed 4
    cfg = smoke_config(arch)
    rng = np.random.default_rng(4)
    want = {"tokens": rng.integers(0, cfg.vocab, (2, 10))}
    if cfg.frontend == "vision":
        want["patch_embeds"] = jnp.asarray(
            rng.normal(size=(2, cfg.n_frontend_tokens, cfg.d_model)) * 0.02, jnp.float32)
    if cfg.frontend == "audio":
        want = {"embeds": jnp.asarray(
            rng.normal(size=(2, 10, cfg.d_model)) * 0.02, jnp.float32)}
    assert seen.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(seen[k].numpy(), np.asarray(want[k]))


def test_serve_embeddings_round_like_the_reference_in_bf16():
    """The published dtype: float64 draws rounded once to bf16, as
    ``jnp.asarray(..., bfloat16)`` rounds them."""
    draws = np.random.default_rng(0).normal(size=(4, 576, 64)) * 0.02
    want = np.asarray(jnp.asarray(draws, jnp.bfloat16)).view(np.int16)
    got = torch.as_tensor(draws).to("cpu", torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_defaults_to_the_references_arch(capsys):
    serve.main(["--smoke", "--device", "cpu", "--batch", "1", "--prompt-len", "5",
                "--gen", "2"])
    assert capsys.readouterr().out.startswith("arch=recurrentgemma-2b-smoke batch=1")
