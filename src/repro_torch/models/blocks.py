"""Block forwards (the port of ``repro.models.blocks``): GQA attention,
SwiGLU/GELU MLP, MoE, Mamba-2 SSD, RG-LRU.

Pure functions over param dicts, in the reference's three modes:

* train   — full sequence, no cache (differentiable: the mamba2 block's K5
  call carries its own gradient, :class:`repro_torch.kernels.ssd_chunk.SSDChunk`)
* prefill — full sequence, returns the decode cache
* decode  — one new token against the cache

Attention, the MLP, the MoE dispatch and the RG-LRU scan are plain
PyTorch, as the reference computes them outside any Pallas kernel
(``jnp.einsum``, ``jax.lax.associative_scan``, ``jax.lax.top_k``,
``jnp.argsort``, scatter-adds).  Where the reference's primitive fixes an
order or a rounding, the port keeps it:

* attention streams over Q blocks of 512 (the (B, H, S, S) scores are never
  formed), with f32 scores when ``attn_f32`` is set, masked with ``-1e30``
  (not ``-inf``) before the softmax, in ``torch.einsum`` products that must
  not run in TF32 (:func:`repro_torch.device.require_full_f32`);
* ``jax.nn.gelu`` is the tanh approximation (``approximate="tanh"``);
* ``jax.lax.top_k`` breaks ties toward the lower index and ``jnp.argsort``
  is stable (the capacity drops depend on that order): both are stable
  sorts here;
* the RG-LRU scan is ``associative_scan``'s own odd/even recursion
  (:func:`_associative_scan`), about 2·log2(S) elementwise levels.

The reference's decode writes attention ring slot ``pos % w`` while its
prefill keeps position ``p`` at slot ``p - (s - w)``: after a prompt of
``s > w`` with ``s % w != 0`` decode attends over the wrong keys.  The
port reproduces that on purpose (ROADMAP §3).

One difference from the reference, by design: the reference evaluates the
mamba2 intra-chunk block (``y_diag`` and the chunk ``states``,
``blocks.py`` 452-463) inline with ``jnp.einsum`` and never calls its own
SSD kernel.  The port routes that same function through K5
(:func:`repro_torch.kernels.ssd_chunk.ssd_chunk`), the kernel the reference
built for exactly this chunk, once per layer over all ``B * C`` chunks.
B and C go to K5 once per group (``n_groups``), not repeated per head:
the kernel reads group ``h // (heads / groups)`` for head ``h``.  The
tests hold the block and the whole model to the reference's inline
math.  The reference's ``_segsum`` has no counterpart here: the kernel's
plain version (:mod:`repro_torch.kernels.ssd_chunk.ref`) forms the same
masked decay logs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.ssd_chunk import ssd_chunk
from .config import ModelConfig

f32 = torch.float32


def rms_norm(x, w, eps=1e-6, f32_stats=True):
    """The reference's order: normalise in f32, cast back to ``x.dtype``,
    then multiply by ``w`` (in bf16 the cast comes before the weight)."""
    if f32_stats:
        xf = x.to(f32)
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w
    var = x.to(f32).square().sum(dim=-1, keepdim=True) / x.shape[-1]
    return x * torch.rsqrt(var + eps).to(x.dtype) * w


def _causal_depthwise_conv(u, w, b):
    """u: (B, S, C); w: (C, K) depthwise causal conv along S.

    Written as K shifted multiply-adds accumulated in f32, not
    ``F.conv1d``: on the card a float32 convolution goes through cuDNN in
    TF32 by default.  The sum is cast to ``u.dtype`` before the bias is
    added, as the reference's conv output is."""
    k = w.shape[1]
    s = u.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0)).to(f32)                  # (B, S+K-1, C)
    wf = w.to(f32)
    out = up[:, 0:s] * wf[:, 0]
    for i in range(1, k):
        out = out + up[:, i:i + s] * wf[:, i]
    return out.to(u.dtype) + b


def _conv_tail(u, k: int):
    """The decode conv state after a prefill: the last ``k - 1`` inputs of
    ``u`` (B, S, C) as (B, C, k - 1), zero-padded in front when S is shorter."""
    tail = u.transpose(1, 2)[:, :, -(k - 1):]
    pad = (k - 1) - tail.shape[2]
    if pad > 0:
        tail = F.pad(tail, (pad, 0))
    return tail.contiguous()


def _conv_step(conv_state, w, b, dtype):
    """The reference's decode conv ``einsum("bck,ck->bc") + b``, accumulated
    in f32 and cast to ``dtype`` before the bias."""
    acc = (conv_state.to(f32) * w.to(f32)).sum(dim=-1)
    return acc.to(dtype) + b


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (S,) integers."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=f32, device=x.device) / half))
    ang = positions.to(f32)[:, None] * freqs[None, :]        # (S, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, mask, scale, *, attn_f32: bool = True):
    """q: (B, Qb, Hq, hd); k,v: (B, Skv, Hkv, hd); mask: (Qb, Skv) bool.

    attn_f32=False is the reference's bf16 operands with f32 accumulation:
    a product of two bf16 values is exact in f32, so the f32 product of the
    upcast operands is that sum; only the probabilities round to ``q.dtype``
    before the value product.
    """
    b, qb, hq, hd = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, qb, hkv, rep, hd)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg.to(f32), k.to(f32)) * scale
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if not attn_f32:
        probs = probs.to(q.dtype).to(f32)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v.to(f32))
    return out.reshape(b, qb, hq, hd).to(q.dtype)


def attention_seq(q, k, v, *, window: Optional[int], q_block: int = 512,
                  attn_f32: bool = True):
    """Causal (optionally windowed) attention, streamed over Q blocks.

    q, k, v: (B, S, H, hd) with aligned positions 0..S-1.  The reference
    pads the last block to ``q_block`` rows and drops them; the port runs
    it short.
    """
    b, s, hq, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qb = min(q_block, s)
    kv_pos = torch.arange(s, device=q.device)
    outs = []
    for q0 in range(0, s, qb):
        q_pos = torch.arange(q0, min(q0 + qb, s), device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= kv_pos[None, :] > (q_pos[:, None] - window)
        outs.append(_attend_block(q[:, q0:q0 + qb], k, v, mask, scale,
                                  attn_f32=attn_f32))
    return torch.cat(outs, dim=1)


def _ffn_params(p: dict) -> dict:
    return {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith("ffn.")}


def attn_forward(
    p: dict,
    x: torch.Tensor,                     # (B, S, D)
    cfg: ModelConfig,
    *,
    mode: str,                           # train | prefill | decode
    pos: int,                            # position of x[:, 0]
    cache: Optional[dict],
    cache_len: int = 0,
):
    b, s, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["ln1"], cfg.norm_eps, cfg.norm_f32)
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, cfg.norm_f32)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, cfg.norm_f32)
    positions = torch.arange(pos, pos + s, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode in ("train", "prefill"):
        out = attention_seq(q, k, v, window=cfg.attn_window,
                            attn_f32=cfg.attn_f32)
        if mode == "prefill":
            w = min(cfg.attn_window or cache_len, cache_len)
            # keep the last `w` keys/values (ring starts full for s >= w)
            if s >= w:
                ks, vs = k[:, -w:], v[:, -w:]
            else:
                ks, vs = (F.pad(t, (0, 0, 0, 0, 0, w - s)) for t in (k, v))
            new_cache = {"k": ks, "v": vs}
    else:  # decode: s == 1
        w = cache["k"].shape[1]
        slot = pos % w
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[:, slot:slot + 1] = k
        cv[:, slot:slot + 1] = v
        kv_pos = torch.arange(w, device=x.device)
        # ring: entry is valid if its age (0 = newest) has been written
        age = (slot - kv_pos) % w
        mask = (age <= min(pos, w - 1))[None, :]
        scale = 1.0 / math.sqrt(hd)
        out = _attend_block(q, ck, cv, mask, scale, attn_f32=cfg.attn_f32)
        new_cache = {"k": ck, "v": cv}

    out = out.reshape(b, s, hq * hd) @ p["wo"]
    x = x + out
    # FFN half of the block
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps, cfg.norm_f32)
    x = x + ffn_forward(_ffn_params(p), h2, cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# FFN / MoE
# ---------------------------------------------------------------------------

def mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig):
    if cfg.act == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def _route(router, xf, m):
    """Top-k routing weights (T, K), renormalised, and experts (T, K).
    ``jax.lax.top_k`` returns the k largest in descending order, ties to the
    lower index: a stable descending sort gives exactly that."""
    probs = torch.softmax((xf @ router).to(f32), dim=-1)      # (T, E)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :m.top_k], top_e[:, :m.top_k]
    return top_w / top_w.sum(dim=-1, keepdim=True), top_e


def moe_forward_sort(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Gather-dispatch MoE (the 'serial paradigm' analogue).

    Sort tokens by expert (stably), pack to per-expert capacity slots,
    grouped matmul over stacked expert weights, weighted combine.  The
    reference's sharding constraints (``moe_shard_constraints``) are the
    identity on one card.  The combine adds ``x.dtype`` expert outputs
    times f32 weights, so, as in the reference's promoting scatter, it sums
    in f32 and rounds once to ``x.dtype``; on the card ``index_add_`` sums
    a token's K contributions in a varying order.
    """
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    top_w, top_e = _route(p["router"], xf, m)

    cap = int(math.ceil(t * m.top_k / m.n_experts * m.capacity_factor))
    eid = top_e.reshape(-1)                                   # (T*K,)
    tid = torch.arange(t, device=dev).repeat_interleave(m.top_k)
    order = torch.argsort(eid, stable=True)
    eid_s, tid_s = eid[order], tid[order]
    # position of each routed pair within its expert
    e_start = torch.searchsorted(eid_s, torch.arange(m.n_experts, device=dev))
    pos_in_e = torch.arange(eid_s.numel(), device=dev) - e_start[eid_s]
    keep = pos_in_e < cap
    slot = eid_s * cap + torch.where(keep, pos_in_e, 0)

    buf = torch.zeros((m.n_experts * cap, d), dtype=x.dtype, device=dev)
    buf.index_add_(0, slot, torch.where(keep[:, None], xf[tid_s], 0))
    xe = buf.reshape(m.n_experts, cap, d)
    hg = torch.bmm(xe, p["w_gate"])                           # "ecd,edf->ecf"
    hu = torch.bmm(xe, p["w_up"])
    ye = torch.bmm(F.silu(hg) * hu, p["w_down"]).reshape(m.n_experts * cap, d)

    # combine: route each kept pair's expert output back to its token
    pair_w = top_w.reshape(-1)[order]                         # (T*K,)
    contrib = torch.where(keep[:, None], ye[slot] * pair_w[:, None], 0)
    y = torch.zeros((t, d), dtype=contrib.dtype, device=dev)
    y.index_add_(0, tid_s, contrib)
    return y.to(x.dtype).reshape(b, s, d)


def moe_forward_onehot(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Dense one-hot dispatch (the 'parallel paradigm' analogue): every
    expert on every token, combined with the routing weights."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    top_w, top_e = _route(p["router"], xf, m)
    combine = torch.zeros((t, m.n_experts), dtype=f32, device=x.device)
    combine.scatter_add_(1, top_e, top_w)
    hg = torch.einsum("td,edf->tef", xf, p["w_gate"])
    hu = torch.einsum("td,edf->tef", xf, p["w_up"])
    ye = torch.einsum("tef,efd->ted", F.silu(hg) * hu, p["w_down"])
    y = torch.einsum("ted,te->td", ye.to(f32), combine).to(x.dtype)
    return y.reshape(b, s, d)


def ffn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig):
    if cfg.moe is not None:
        if cfg.moe.dispatch == "onehot":
            return moe_forward_onehot(p, x, cfg)
        # "local" with no sharding context set, always so on one card, is
        # the reference's own fallback to the global sort
        return moe_forward_sort(p, x, cfg)
    return mlp_forward(p, x, cfg)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_forward(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,
    cache: Optional[dict],
):
    s_cfg = cfg.ssm
    b, s, d = x.shape
    d_in = s_cfg.expand * d
    hdim = s_cfg.head_dim
    nh = d_in // hdim
    g, n = s_cfg.n_groups, s_cfg.d_state
    conv_dim = d_in + 2 * g * n

    h = rms_norm(x, p["ln"], cfg.norm_eps, cfg.norm_f32)
    proj = h @ p["in_proj"]                                # (B,S, 2*d_in + 2GN + H)
    z, xbc, dt = torch.split(proj, [d_in, conv_dim, nh], dim=-1)

    new_cache = {}
    if mode == "decode":
        conv_state = torch.cat([cache["conv"], xbc.transpose(1, 2)], dim=2)
        new_cache["conv"] = conv_state[:, :, 1:]
        xbc = F.silu(_conv_step(conv_state, p["conv_w"], p["conv_b"],
                                x.dtype))[:, None, :]
    else:
        if mode == "prefill":
            new_cache["conv"] = _conv_tail(xbc, s_cfg.d_conv)
        xbc = F.silu(_causal_depthwise_conv(xbc, p["conv_w"], p["conv_b"]))

    xs, bmat, cmat = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    xs = xs.reshape(b, -1, nh, hdim)
    bmat = bmat.reshape(b, -1, g, n)                       # per group, not head
    cmat = cmat.reshape(b, -1, g, n)
    # jax.nn.softplus is exact everywhere; F.softplus returns its input
    # above 20, where the two differ by under 2.1e-9: below half an f32 ulp
    # of 20, so the f32 results are equal
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))     # (B,S,H)
    a = -torch.exp(p["A_log"].to(f32))                     # (H,)
    la = dt * a[None, None, :]                             # log decay

    if mode == "decode":
        h_state = cache["ssd"]                                        # (B,H,P,N)
        dec = torch.exp(la[:, 0, :])                                  # (B,H)
        b_t = bmat[:, 0].repeat_interleave(nh // g, dim=1)            # (B,H,N)
        c_t = cmat[:, 0].repeat_interleave(nh // g, dim=1)
        # "bh,bhn,bhp->bhpn"
        dbx = (dt[:, 0, :, None, None] * xs[:, 0].to(f32)[..., :, None]
               * b_t.to(f32)[..., None, :])
        h_state = dec[:, :, None, None] * h_state + dbx
        y = torch.einsum("bhn,bhpn->bhp", c_t.to(f32), h_state)
        y = y + p["D_skip"].to(f32)[None, :, None] * xs[:, 0].to(f32)
        y = y.reshape(b, 1, d_in)
        new_cache["ssd"] = h_state
    else:
        q = min(s_cfg.chunk, s)
        pad = (-s) % q
        if pad:
            # zero inputs and zero log decay (decay 1) past the sequence
            def padfn(u):
                return F.pad(u, (0, 0) * (u.ndim - 2) + (0, pad))
            xs, bmat, cmat, la, dt = map(padfn, (xs, bmat, cmat, la, dt))
        nc = xs.shape[1] // q
        xc = xs.reshape(b, nc, q, nh, hdim)
        lac = la.reshape(b, nc, q, nh)
        xdt = xc.to(f32) * dt.reshape(b, nc, q, nh)[..., None]       # (B,C,Q,H,P)
        cc = cmat.to(f32).reshape(b, nc, q, g, n).contiguous()       # (B,C,Q,G,N)
        # the intra-chunk block, y_diag and the chunk states: K5 over B*C
        # chunks; B and C go in once per group, contiguous (in f32 without
        # padding they are views of the split, so this copies (B,S,G,N))
        y_diag, states = ssd_chunk(
            xdt.reshape(b * nc, q, nh, hdim).contiguous(),
            bmat.to(f32).reshape(b * nc, q, g, n).contiguous(),
            cc.reshape(b * nc, q, g, n),
            lac.reshape(b * nc, q, nh).contiguous(),
        )
        y_diag = y_diag.reshape(b, nc, q, nh, hdim)
        states = states.reshape(b, nc, nh, n, hdim)
        cs = torch.cumsum(lac, dim=2)                                  # (B,C,Q,H)
        chunk_dec = torch.exp(cs[:, :, -1, :])                         # (B,C,H)

        # the inter-chunk recurrence (the reference's lax.scan over chunks)
        hcur = (
            cache["ssd"].transpose(2, 3).to(f32)   # (B,H,N,P)
            if (cache and "ssd" in cache)
            else torch.zeros((b, nh, n, hdim), dtype=f32, device=x.device)
        )
        hprevs = []
        for ci in range(nc):
            hprevs.append(hcur)
            hcur = chunk_dec[:, ci, :, None, None] * hcur + states[:, ci]
        hprevs = torch.stack(hprevs, dim=1)                           # (B,C,H,N,P)
        dec_from_start = torch.exp(cs)                                # (B,C,Q,H)
        # "bcqhn,bchnp,bcqh->bcqhp" with C read per group: heads as
        # (groups, heads per group)
        y_off = torch.einsum(
            "bcqgn,bcgknp->bcqgkp", cc,
            hprevs.reshape(b, nc, g, nh // g, n, hdim),
        ).reshape(b, nc, q, nh, hdim) * dec_from_start[..., None]
        y = (y_diag + y_off).reshape(b, nc * q, nh, hdim)[:, :s]
        y = y + p["D_skip"].to(f32)[None, None, :, None] * xs[:, :s].to(f32)
        y = y.reshape(b, s, d_in)
        if mode == "prefill":
            new_cache["ssd"] = hcur.transpose(2, 3).contiguous()       # (B,H,P,N)

    y = rms_norm(y * F.silu(z[:, : y.shape[1]].to(f32)), p["gn"],
                 cfg.norm_eps, cfg.norm_f32)
    out = y.to(x.dtype) @ p["out_proj"]
    return x + out, (new_cache or None)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

def _combine(a1, b1, a2, b2):
    """The linear recurrence's operator: (a1, b1) then (a2, b2)."""
    return a2 * a1, a2 * b1 + b2


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along axis 1 (``even`` as long as
    ``odd`` or one longer)."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a, b):
    """``jax.lax.associative_scan(combine, (a, b), axis=1)`` by its own
    recursion, so each prefix is formed by the same products in the same
    order: combine adjacent pairs, scan those, combine each odd prefix with
    the next even element, interleave.  About 2·log2(S) elementwise levels,
    not S sequential steps."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_forward(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    mode: str,
    cache: Optional[dict],
):
    b, s, d = x.shape
    c_const = cfg.rglru.c
    h = rms_norm(x, p["ln1"], cfg.norm_eps, cfg.norm_f32)
    u = h @ p["w_x"]                                   # (B,S,R)
    g = F.gelu(h @ p["w_g"], approximate="tanh")

    new_cache = {}
    if mode == "decode":
        conv_state = torch.cat([cache["conv"], u.transpose(1, 2)], dim=2)
        new_cache["conv"] = conv_state[:, :, 1:]
        u = _conv_step(conv_state, p["conv_w"], p["conv_b"], x.dtype)[:, None, :]
    else:
        if mode == "prefill":
            new_cache["conv"] = _conv_tail(u, cfg.rglru.d_conv)
        u = _causal_depthwise_conv(u, p["conv_w"], p["conv_b"])

    uf = u.to(f32)
    rgate = torch.sigmoid(p["w_a"].to(f32) * uf + p["b_a"].to(f32))
    igate = torch.sigmoid(p["w_i"].to(f32) * uf + p["b_i"].to(f32))
    log_a = -c_const * F.softplus(p["lam"].to(f32)) * rgate
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    v = beta * (igate * uf)

    if mode == "decode":
        h_new = a[:, 0] * cache["h"] + v[:, 0]
        hs = h_new[:, None, :]
        new_cache["h"] = h_new
    else:
        a_sc, b_sc = _associative_scan(a, v)
        if cache is not None and "h" in cache:
            hs = a_sc * cache["h"][:, None, :] + b_sc
        else:
            hs = b_sc
        if mode == "prefill":
            new_cache["h"] = hs[:, -1]

    out = (hs.to(x.dtype) * g) @ p["w_out"]
    x = x + out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps, cfg.norm_f32)
    x = x + ffn_forward(_ffn_params(p), h2, cfg)
    return x, (new_cache or None)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def block_forward(btype: str, p, x, cfg, *, mode, pos, cache, cache_len=0):
    if btype == "attn":
        return attn_forward(p, x, cfg, mode=mode, pos=pos, cache=cache,
                            cache_len=cache_len)
    if btype == "mamba2":
        return mamba2_forward(p, x, cfg, mode=mode, cache=cache)
    if btype == "rglru":
        return rglru_forward(p, x, cfg, mode=mode, cache=cache)
    raise ValueError(btype)
