"""The port's mamba2 serving slice against the reference package, on the CPU.

K5's plain version (what the wrapper runs on CPU tensors) is held to the
reference's Pallas kernel in interpret mode and to its jnp oracle at the
shapes of ``tests/test_kernels.py::TestSSDChunk``, and to the sequential
recurrence; the mamba2 block (whose intra-chunk part goes through K5) and
the whole smoke model (prefill, then decode) are held to the reference's
inline math on the same weights, carried over with
``convert.lm_params_from_numpy``.  Every input is made with NumPy from a
seed.

Tolerances: K5 ``rtol = atol = 1e-4``, the reference's own.  The block and
the model run in float32 in both packages and differ only in summation
order: logits and the conv cache within ``atol = 1e-5, rtol = 1e-4``, the
SSD state cache (values near 1e-4) within ``atol = 1e-8, rtol = 1e-4``;
greedy tokens equal.  Measured: about 3e-7 on the smoke logits and 3e-6
(of 3.4) on a full-width layer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.ssd_chunk import ssd_chunk as jax_ssd_chunk
from repro.kernels.ssd_chunk import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models import blocks as jax_blocks
from repro.models import init as jax_init
from repro.models import model as jax_model
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import launch_counts
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref
from repro_torch.launch import serve
from repro_torch.models import blocks, init as minit, model as M

#: TestSSDChunk's shapes (Q, H, P, N): mamba2-130m's chunk first
SSD_SHAPES = [(256, 24, 64, 128), (64, 3, 16, 32), (16, 1, 8, 8), (128, 5, 32, 64)]
TOL = dict(rtol=1e-4, atol=1e-4)


def ssd_operands(shape, seed, lead=()):
    """TestSSDChunk's draws: normal x, b, c; la = -|normal * 0.1|."""
    q, h, p, n = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (q, h, p)).astype(np.float32)
    b = rng.normal(size=lead + (q, h, n)).astype(np.float32)
    c = rng.normal(size=lead + (q, h, n)).astype(np.float32)
    la = -np.abs(rng.normal(size=lead + (q, h)) * 0.1).astype(np.float32)
    return x, b, c, la


def port_ssd(*arrays):
    y, s = ssd_chunk(*(torch.from_numpy(a) for a in arrays))
    return y.numpy(), s.numpy()


# -- K5: the SSD intra-chunk block ---------------------------------------------
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_chunk_matches_jax_kernel_and_ref(shape):
    ops = ssd_operands(shape, seed=shape[0] + shape[3])
    y, s = port_ssd(*ops)
    assert y.shape == ops[0].shape and s.shape == (shape[1], shape[3], shape[2])
    jx = [jnp.asarray(a) for a in ops]
    yk, sk = jax_ssd_chunk(*jx, interpret=True)
    yr, sr = jax_ssd_chunk_ref(*jx)
    for want_y, want_s in ((yk, sk), (yr, sr)):
        np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
        np.testing.assert_allclose(s, np.asarray(want_s), **TOL)


def test_ssd_chunk_batched_equals_per_chunk_jax():
    """G = 3 chunks in one call equal the reference's single-chunk calls."""
    ops = ssd_operands((64, 3, 16, 32), seed=5, lead=(3,))
    y, s = port_ssd(*ops)
    assert y.shape == (3, 64, 3, 16) and s.shape == (3, 3, 32, 16)
    for gi in range(3):
        yk, sk = jax_ssd_chunk(*(jnp.asarray(a[gi]) for a in ops), interpret=True)
        np.testing.assert_allclose(y[gi], np.asarray(yk), **TOL)
        np.testing.assert_allclose(s[gi], np.asarray(sk), **TOL)
    # the single-chunk call of the port is the batched one's slice
    y1, s1 = port_ssd(*(a[1] for a in ops))
    np.testing.assert_array_equal(y1, y[1])
    np.testing.assert_array_equal(s1, s[1])


#: a fresh interpreter's first K5 call on the CPU, on operands saved by the test
FIRST_CALL = """
import sys
import numpy as np, torch
from repro_torch.kernels.ssd_chunk import ssd_chunk
ops = [torch.from_numpy(np.load(f"{sys.argv[1]}/{k}.npy")) for k in "xbcl"]
y, s = ssd_chunk(*ops)
np.save(f"{sys.argv[2]}_y.npy", y.numpy())
np.save(f"{sys.argv[2]}_s.npy", s.numpy())
"""


def test_ssd_chunk_first_call_reproducible_across_processes(tmp_path):
    """The first call in each of six fresh processes, all started at once
    while this one runs the reference's kernel, gives the same bits as this
    process's call, within the reference's tolerance of its kernel."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    import repro_torch

    shape = SSD_SHAPES[0]
    ops = ssd_operands(shape, seed=shape[0] + shape[3])
    for k, a in zip("xbcl", ops):
        np.save(tmp_path / f"{k}.npy", a)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(repro_torch.__file__).resolve().parents[1])
    procs = [subprocess.Popen([sys.executable, "-c", FIRST_CALL, str(tmp_path),
                               str(tmp_path / f"p{i}")], env=env)
             for i in range(6)]
    yk, sk = jax_ssd_chunk(*(jnp.asarray(a) for a in ops), interpret=True)
    y, s = port_ssd(*ops)
    assert [p.wait(timeout=300) for p in procs] == [0] * 6
    for i in range(6):
        np.testing.assert_array_equal(np.load(tmp_path / f"p{i}_y.npy"), y)
        np.testing.assert_array_equal(np.load(tmp_path / f"p{i}_s.npy"), s)
    np.testing.assert_allclose(y, np.asarray(yk), **TOL)
    np.testing.assert_allclose(s, np.asarray(sk), **TOL)


#: (Q, H, P, N): a ragged shape and a mamba2 chunk's widths at few heads
GROUPED_SHAPES = [(64, 4, 16, 32), (100, 6, 20, 36)]


@pytest.mark.parametrize("shape", GROUPED_SHAPES)
@pytest.mark.parametrize("hg", ["1", "2", "H"])
def test_ssd_chunk_grouped_matches_jax_kernel(shape, hg):
    """B and C once per group of heads (``Hg`` of them) against the
    reference's kernel (interpret mode) and its jnp oracle, which get the
    same arrays repeated for every head, as the mamba2 block builds them."""
    q, h, p, n = shape
    groups = h if hg == "H" else int(hg)
    x, _, _, la = ssd_operands(shape, seed=q + groups)
    rng = np.random.default_rng(groups)
    b, c = (rng.normal(size=(q, groups, n)).astype(np.float32) for _ in range(2))
    y, s = port_ssd(x, b, c, la)
    per_head = [jnp.asarray(np.repeat(a, h // groups, axis=1)) for a in (b, c)]
    jx, jla = jnp.asarray(x), jnp.asarray(la)
    for want_y, want_s in (jax_ssd_chunk(jx, *per_head, jla, interpret=True),
                           jax_ssd_chunk_ref(jx, *per_head, jla)):
        np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
        np.testing.assert_allclose(s, np.asarray(want_s), **TOL)
    # and G = 2 chunks in one call: each the single-chunk call's result
    y2, s2 = port_ssd(*(np.stack([a, a]) for a in (x, b, c, la)))
    for gi in range(2):
        np.testing.assert_array_equal(y2[gi], y)
        np.testing.assert_array_equal(s2[gi], s)


def _sequential(x, b, c, la):
    """s_t = exp(la_t) s_{t-1} + b_t x_t^T;  y_t = c_t . s_t  (float64)."""
    q, h, p = x.shape
    n = b.shape[-1]
    y = np.zeros((q, h, p))
    s = np.zeros((h, n, p))
    for t in range(q):
        for hh in range(h):
            s[hh] = np.exp(la[t, hh]) * s[hh] + np.outer(b[t, hh], x[t, hh])
            y[t, hh] = c[t, hh] @ s[hh]
    return y, s


@pytest.mark.parametrize("decay", ["test", "mamba2"])
def test_ssd_chunk_matches_sequential_recurrence(decay):
    """test_matches_model_ssd_math's oracle; and a mamba2 layer's decays
    (dt ~ 0.69 times A in [-16, -1]), under which the reference's
    exp-then-mask takes exp of differences up to +700."""
    rng = np.random.default_rng(11)
    q, h, p, n = (12, 2, 4, 6) if decay == "test" else (64, 4, 4, 6)
    x = rng.normal(size=(q, h, p)).astype(np.float32)
    b = rng.normal(size=(q, h, n)).astype(np.float32)
    c = rng.normal(size=(q, h, n)).astype(np.float32)
    if decay == "test":
        la = -np.abs(rng.normal(size=(q, h)) * 0.1).astype(np.float32)
    else:
        la = (-0.69 * np.linspace(1.0, 16.0, h)[None, :]
              * rng.uniform(0.8, 1.2, (q, h))).astype(np.float32)
    y, s = port_ssd(x, b, c, la)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    y_seq, s_seq = _sequential(x, b, c, la)
    np.testing.assert_allclose(y, y_seq, **TOL)
    np.testing.assert_allclose(s, s_seq, **TOL)


def test_ssd_chunk_wrapper_shapes_and_plain_path():
    x, b, c, la = (torch.from_numpy(a) for a in ssd_operands((16, 1, 8, 8), 0))
    before = launch_counts()["ssd_chunk"]
    y, s = ssd_chunk(x, b, c, la)
    assert launch_counts()["ssd_chunk"] == before      # CPU: no kernel launch
    yr, sr = ssd_chunk_ref(x, b, c, la)
    assert torch.equal(y, yr) and torch.equal(s, sr)
    with pytest.raises(ValueError, match=r"\(Q, H, P\)"):
        ssd_chunk(x[0], b, c, la)
    with pytest.raises(ValueError, match="la"):
        ssd_chunk(x, b, c, la[:, :0])
    with pytest.raises(ValueError, match="b and c"):
        ssd_chunk(x, b, c[..., :4], la)


@pytest.mark.parametrize("bad", ["groups", "b", "c"])
def test_ssd_chunk_wrapper_refuses_on_either_device(bad):
    """H % Hg != 0, and a non-contiguous b or c, are refused before the
    device is looked at, so the plain path refuses what the kernel would."""
    x, b, c, la = (torch.from_numpy(a) for a in ssd_operands((16, 6, 8, 8), 0))
    if bad == "groups":
        b, c = b[:, :4].contiguous(), c[:, :4].contiguous()
        match = "multiple"
    else:
        t = {"b": b, "c": c}[bad].transpose(0, 1).contiguous().transpose(0, 1)
        b, c = (t, c) if bad == "b" else (b, t)
        match = f"{bad} must be contiguous"
    with pytest.raises(ValueError, match=match):
        ssd_chunk(x, b, c, la)


# -- the mamba2 block and model ------------------------------------------------
@pytest.mark.parametrize("f32_stats", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype, f32_stats):
    """Both statistics modes; in bf16 the reference casts back to x's dtype
    before the weight multiplies, so the port must too (bf16 results equal,
    f32 within 1e-6)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    want = np.asarray(jax_blocks.rms_norm(jx, jw, 1e-6, f32_stats).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    got = blocks.rms_norm(tx, tw, 1e-6, f32_stats)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16" and f32_stats:
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:   # bf16 without f32 stats rounds the rsqrt to bf16 in both
        tol = 1e-6 if dtype == "float32" else 8e-3
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _jax_tree(cfg, seed):
    params = jax_init.init_params(cfg, jax.random.PRNGKey(seed))
    return params, lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_mamba2_layer_full_width_matches_jax(mode):
    """One mamba2-130m layer at full width (d 768, H 24, N 128, P 64) on
    b = 2, s = 300: two chunks of 256, the second padded."""
    cfg = dataclasses.replace(get_config("mamba2-130m"), dtype="float32",
                              n_layers=1)
    # a small vocab: the layer's own widths are untouched
    jcfg = dataclasses.replace(jax_get_config("mamba2-130m"), dtype="float32",
                               n_layers=1, vocab=256)
    jp = jax.tree.map(lambda a: a[0], jax_init.init_params(
        jcfg, jax.random.PRNGKey(1))["groups"][0][0])
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = (np.random.default_rng(0).normal(size=(2, 300, 768)) * 0.5).astype(np.float32)
    jy, jcache = jax_blocks.mamba2_forward(jp, jnp.asarray(x), jcfg, mode=mode,
                                           cache=None)
    ty, tcache = blocks.mamba2_forward(tp, torch.from_numpy(x), cfg, mode=mode,
                                       cache=None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    if mode == "train":
        assert jcache is None and tcache is None
        return
    np.testing.assert_allclose(tcache["conv"].numpy(), np.asarray(jcache["conv"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tcache["ssd"].numpy(), np.asarray(jcache["ssd"]),
                               rtol=1e-4, atol=1e-8)


def test_mamba2_layer_with_two_groups_matches_jax():
    """A mamba2 layer with n_groups = 2 (12 heads a group), the case
    between one group and one per head: K5 gets B and C per group and
    the y_off einsum reads C with the heads as (groups, heads a group)."""
    ssm = dataclasses.replace(get_config("mamba2-130m").ssm, n_groups=2,
                              d_state=32, chunk=64)
    cfg = dataclasses.replace(get_config("mamba2-130m"), dtype="float32",
                              n_layers=1, ssm=ssm)
    jcfg = dataclasses.replace(
        jax_get_config("mamba2-130m"), dtype="float32", n_layers=1, vocab=256,
        ssm=dataclasses.replace(jax_get_config("mamba2-130m").ssm, n_groups=2,
                                d_state=32, chunk=64))
    jp = jax.tree.map(lambda a: a[0], jax_init.init_params(
        jcfg, jax.random.PRNGKey(3))["groups"][0][0])
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = (np.random.default_rng(4).normal(size=(2, 100, 768)) * 0.5).astype(np.float32)
    jy, jcache = jax_blocks.mamba2_forward(jp, jnp.asarray(x), jcfg,
                                           mode="prefill", cache=None)
    ty, tcache = blocks.mamba2_forward(tp, torch.from_numpy(x), cfg,
                                       mode="prefill", cache=None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tcache["ssd"].numpy(), np.asarray(jcache["ssd"]),
                               rtol=1e-4, atol=1e-8)
    tok = (np.random.default_rng(5).normal(size=(2, 1, 768)) * 0.5).astype(np.float32)
    jy, _ = jax_blocks.mamba2_forward(jp, jnp.asarray(tok), jcfg, mode="decode",
                                      cache=jcache)
    ty, _ = blocks.mamba2_forward(tp, torch.from_numpy(tok), cfg, mode="decode",
                                  cache=tcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)


def _assert_caches(tc, jc):
    (got,), (want,) = tc, jc             # one group of one mamba2 block
    got, want = got[0], want[0]
    assert set(got) == set(want) == {"conv", "ssd"}
    np.testing.assert_allclose(got["conv"].numpy(), np.asarray(want["conv"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["ssd"].numpy(), np.asarray(want["ssd"]),
                               rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("seq", [12, 40])
def test_smoke_model_prefill_and_decode_match_jax(seq):
    """smoke_config("mamba2-130m") in f32: prefill at s = 12 (one short
    chunk) and s = 40 (three chunks of 16, the last padded), then three
    greedy decode steps; logits, both caches and tokens."""
    cfg, jcfg = smoke_config("mamba2-130m"), jax_smoke_config("mamba2-130m")
    jp, tp = _jax_tree(jcfg, seed=0)
    toks = np.random.default_rng(seq).integers(0, cfg.vocab, (2, seq)).astype(np.int32)
    cache_len = seq + 4
    jl, jc = jax_model.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, cache_len)
    tl, tc = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, cache_len)
    assert tl.shape == (2, 1, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    _assert_caches(tc, jc)
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0])
        jl, jc = jax_model.decode_step(jp, jcfg, jnp.asarray(tok),
                                       jnp.int32(seq + step), jc, cache_len)
        tl, tc = M.decode_step(tp, cfg, torch.from_numpy(tok), seq + step, tc,
                               cache_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
        _assert_caches(tc, jc)


def test_init_caches_match_jax_tree():
    cfg, jcfg = smoke_config("mamba2-130m"), jax_smoke_config("mamba2-130m")
    got = M.init_caches(cfg, 3, 20, device="cpu")
    want = jax_model.init_caches(jcfg, 3, 20)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got, is_leaf=torch.is_tensor))
    for g, w in zip(jax.tree.leaves(got, is_leaf=torch.is_tensor),
                    jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


# -- parameters, configs, launcher ---------------------------------------------
def test_init_params_follow_the_reference_rules():
    cfg = smoke_config("mamba2-130m")
    tp = minit.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    jshapes = jax.eval_shape(lambda: jax_init.init_params(
        jax_smoke_config("mamba2-130m"), jax.random.PRNGKey(0)))
    assert jax.tree.structure(jshapes) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp, is_leaf=torch.is_tensor))
    for g, w in zip(jax.tree.leaves(tp, is_leaf=torch.is_tensor),
                    jax.tree.leaves(jshapes)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    blk = tp["groups"][0][0]
    h = blk["A_log"].shape[-1]
    for layer in range(cfg.n_layers):
        np.testing.assert_allclose(blk["A_log"][layer].numpy(),
                                   np.log(np.linspace(1.0, 16.0, h)), rtol=1e-6)
    assert (blk["ln"] == 1).all() and (blk["gn"] == 1).all()
    assert (blk["D_skip"] == 1).all() and not blk["dt_bias"].any()
    assert not blk["conv_b"].any() and (tp["final_norm"] == 1).all()
    assert abs(float(blk["in_proj"].std()) - 0.02) < 0.002
    want = 0.02 / (2 * cfg.n_layers) ** 0.5
    assert abs(float(blk["out_proj"].std()) - want) < 0.1 * want
    again = minit.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again["lm_head"], tp["lm_head"])


def test_other_block_types_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        minit.init_params(smoke_config("llama3.2-3b"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_caches(smoke_config("recurrentgemma-2b"), 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        blocks.block_forward("rglru", {}, torch.zeros(1, 1, 4),
                             smoke_config("recurrentgemma-2b"), mode="train",
                             pos=0, cache=None)


def test_registry_copy_is_pinned_to_the_reference():
    assert ARCH_NAMES == JAX_ARCHS
    for arch in ARCH_NAMES:
        for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                             (smoke_config(arch), jax_smoke_config(arch))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), arch
        assert get_config(arch).param_count() == jax_get_config(arch).param_count()
    assert get_config("mamba2-130m").param_count() == 167_598_528


def test_lm_params_from_numpy_keeps_bf16_bits():
    jcfg = dataclasses.replace(jax_smoke_config("mamba2-130m"), dtype="bfloat16")
    jp = jax_init.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    for g, w in zip(jax.tree.leaves(tp, is_leaf=torch.is_tensor),
                    jax.tree.leaves(jp)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))


@pytest.mark.parametrize("temperature", ["0", "1.0"])
def test_serve_main_on_cpu_returns_the_reference_keys(capsys, temperature):
    args = ["--arch", "mamba2-130m", "--smoke", "--device", "cpu", "--batch",
            "2", "--prompt-len", "20", "--gen", "4", "--temperature", temperature]
    out = serve.main(args)
    assert set(out) == {"prefill_s", "decode_tok_per_s", "tokens"}
    assert out["tokens"].shape == (2, 4)
    assert ((0 <= out["tokens"]) & (out["tokens"] < 256)).all()
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("arch=mamba2-130m-smoke batch=2: prefill ")
    assert lines[1].startswith("sample:")
    np.testing.assert_array_equal(serve.main(args)["tokens"], out["tokens"])
