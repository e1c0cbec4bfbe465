"""The port's training path against the reference package, on the CPU.

``repro_torch.models.model.train_loss`` and its gradients
(``value_and_grad``) against ``jax.value_and_grad`` of the reference's
``train_loss`` on the same weights (carried over with
``convert.lm_params_from_numpy``) for every arch's smoke config, with
activation checkpointing; and K5's gradient (``SSDChunk``) by ``gradcheck``, against autograd
through its plain version and against the exact (f64) gradient of a
full-width layer.  Every input is made with NumPy from a seed.  The
chunked loss, the bf16 gradient barrier, AdamW, the train step,
checkpoints and the launcher are in ``tests/test_torch_train_loop.py``.

Tolerances: both packages run in float32 and differ in summation order.
The loss within ``rtol = 1e-5``; each gradient leaf within ``1e-4`` of the
leaf's largest reference magnitude plus ``1e-7`` (the largest measured
share is about 1e-5, in mamba2's ``A_log`` and ``dt_bias``, which sum
over every position).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import init as jax_init
from repro.models import model as jax_model
from repro_torch.configs import ARCH_NAMES, smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.ssd_chunk import SSDChunk, ops as ssd_ops, ssd_chunk, ssd_chunk_ref
from repro_torch.models import blocks, model as M
from repro_torch.tree import leaves

GRAD_TOL = 1e-4
MOE_ARCHS = [a for a in ARCH_NAMES if smoke_config(a).moe is not None]


def to_torch(tree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def configs(arch, capacity=8.0, **changes):
    """The arch's smoke config in both packages, MoE capacity set."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(cfg.moe, capacity_factor=capacity)
    return (dataclasses.replace(cfg, **changes),
            dataclasses.replace(jcfg, **changes))


def make_batch(cfg, b=2, s=40, seed=0):
    """As the reference's smoke tests draw it: the audio arch hands over
    frame embeddings and labels, the vision arch adds patch embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"embeds": (rng.normal(size=(b, s, cfg.d_model)) * 0.02
                           ).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (rng.normal(
            size=(b, cfg.n_frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def both_grads(cfg, jcfg, batch, seed=0):
    """(port loss, port grads, reference loss, reference grads, port params)."""
    jp = jax_init.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = to_torch(jp)
    jl, jg = jax.value_and_grad(jax_model.train_loss)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = M.value_and_grad(tp, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    return tl, tg, jl, jg, tp


def grad_share(got, want, tol=GRAD_TOL) -> float:
    """The largest |got - want| of any leaf over that leaf's max |want|;
    asserts the trees have the same leaves and shapes, and every leaf
    within ``tol`` of its scale (+ 1e-7)."""
    got_l, want_l = leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    worst = 0.0
    for g, w in zip(got_l, want_l):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        diff = np.abs(g.float().numpy() - w)
        scale = np.abs(w).max()
        assert (diff <= tol * scale + 1e-7).all(), (diff.max(), scale)
        worst = max(worst, float(diff.max() / max(scale, 1e-30)))
    return worst


# -- train_loss and its gradients -------------------------------------------------
@pytest.mark.parametrize("arch,capacity", [(a, 8.0) for a in ARCH_NAMES]
                         + [(a, 1.25) for a in MOE_ARCHS])
def test_train_loss_and_grads_match_jax(arch, capacity):
    """Batch 2 x 40 (three mamba2 chunks of 16, the last padded); capacity
    1.25 drops routed pairs, 8.0 none."""
    cfg, jcfg = configs(arch, capacity)
    tl, tg, jl, jg, _ = both_grads(cfg, jcfg, make_batch(cfg))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert grad_share(tg, jg) < GRAD_TOL
    # every leaf has a gradient: the audio arch's unread tok_embed is zeros
    if cfg.frontend == "audio":
        assert not tg["tok_embed"].any()


class ForwardCount:
    """Counts K5's forward calls (the launches on the card) by device."""

    def __init__(self, monkeypatch):
        self.n = 0
        forward = ssd_ops._forward

        def counted(*args):
            self.n += 1
            return forward(*args)

        monkeypatch.setattr(ssd_ops, "_forward", counted)


@pytest.mark.parametrize("arch,n_layers", [("mamba2-130m", 2), ("recurrentgemma-2b", 4)])
def test_remat_gives_the_gradients_of_no_remat(arch, n_layers, monkeypatch):
    """Bit for bit expected, held at 1e-6 of scale (the CPU's GEMM path may
    change under load).  recurrentgemma at 4 layers has two groups (its
    pattern of 3, then one rglru layer), each layer's body rerun in the
    backward with its own block types.  Under remat every mamba2 layer's
    K5 runs twice a step (the recompute), without it once; mamba2 with
    remat is also held to the reference with remat."""
    cfg, jcfg = configs(arch, n_layers=n_layers, remat=True)
    batch = make_batch(cfg)
    count = ForwardCount(monkeypatch)
    if arch == "mamba2-130m":
        tl, tg, jl, jg, tp = both_grads(cfg, jcfg, batch)
        grad_share(tg, jg)
    else:
        tp = to_torch(jax_init.init_params(jcfg, jax.random.PRNGKey(0)))
        tl, tg = M.value_and_grad(tp, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    mamba = n_layers if "mamba2" in cfg.block_pattern else 0
    assert count.n == 2 * mamba
    count.n = 0
    ul, ug = M.value_and_grad(tp, dataclasses.replace(cfg, remat=False),
                              {k: torch.from_numpy(v) for k, v in batch.items()})
    assert count.n == mamba
    assert float(tl) == pytest.approx(float(ul), rel=1e-6)
    for a, b in zip(leaves(tg), leaves(ug)):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()) + 1e-12


# -- K5's gradient ----------------------------------------------------------------
def ssd_operands(g, q, h, hg, p, n, seed, dtype=torch.float32, decay=2.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, q, h, p))
    b, c = rng.normal(size=(2, g, q, hg, n))
    la = -rng.random((g, q, h)) * decay
    return [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (x, b, c, la)]


def test_ssd_chunk_gradcheck():
    ops = ssd_operands(2, 8, 4, 2, 3, 5, seed=1, dtype=torch.float64)
    assert torch.autograd.gradcheck(ssd_chunk, ops)
    single = [t[0].detach().requires_grad_() for t in ops]
    assert torch.autograd.gradcheck(ssd_chunk, single)


@pytest.mark.parametrize("shape", [
    (6, 16, 8, 1, 16, 16),       # the smoke config: 2 x 3 chunks, one group
    (1, 256, 24, 1, 64, 128),    # one full-width mamba2 layer at s 256
    (3, 64, 6, 2, 16, 32),       # two groups of three heads
])
def test_ssd_chunk_backward_matches_autograd_of_the_plain_version(shape):
    """Random cotangents for y and the state; the log decays of a mamba2
    layer (cs falls by up to ~11 a step at the full-width init)."""
    ops = ssd_operands(*shape, seed=2, decay=11.0)
    y, state = ssd_chunk(*ops)
    assert type(y.grad_fn) is SSDChunk._backward_cls
    rng = np.random.default_rng(3)
    gy, gs = (torch.tensor(rng.normal(size=t.shape), dtype=torch.float32)
              for t in (y, state))
    got = torch.autograd.grad([y, state], ops, [gy, gs])
    ref = [t.detach().clone().requires_grad_() for t in ops]
    want = torch.autograd.grad(list(ssd_chunk_ref(*ref)), ref, [gy, gs])
    for name, a, b in zip(("x", "b", "c", "la"), got, want):
        assert torch.isfinite(a).all(), name
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale + 1e-7, name


def test_full_width_mamba2_layer_grads_through_k5_match_the_exact_gradient(monkeypatch):
    """One mamba2-130m layer (d 768) at s 256 in f32: the parameter
    gradients through SSDChunk, and through autograd of ssd_chunk_ref,
    against the layer's gradient in f64.  ``A_log`` and ``dt_bias`` sum
    ``dt * a * gla`` over every position and head, where the f32 forward's
    running sum ``cs`` (an ulp of |cs| up to ~20 a step) shows: measured
    over three seeds 5.4e-5 to 2.0e-4 of scale through SSDChunk and 3.0e-5
    to 1.3e-4 through the plain version's autograd; every other leaf
    within 1e-6 of scale."""
    from repro_torch.configs import get_config
    from repro_torch.models import init as minit

    cfg = dataclasses.replace(get_config("mamba2-130m"), n_layers=1, dtype="float32")
    params = minit.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    x = torch.tensor(np.random.default_rng(6).normal(size=(1, 256, 768)))

    def grads(dtype):
        lp = {k: v[0].detach().to(dtype).requires_grad_()
              for k, v in params["groups"][0][0].items()}
        out, _ = blocks.mamba2_forward(lp, x.to(dtype), cfg, mode="train", cache=None)
        return dict(zip(lp, torch.autograd.grad(out.square().sum(), list(lp.values()))))

    got = grads(torch.float32)
    monkeypatch.setattr(blocks, "ssd_chunk", ssd_chunk_ref)
    plain, exact = grads(torch.float32), grads(torch.float64)
    for name, want in exact.items():
        tol = 5e-4 if name in ("A_log", "dt_bias") else 1e-5
        for a in (got[name], plain[name]):
            err = float((a.double() - want).abs().max())
            assert err <= tol * float(want.abs().max()), (name, err)
