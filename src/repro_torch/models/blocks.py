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

Over a mesh (DTensor operands, :mod:`repro_torch.distributed.sharding`)
the blocks run unchanged, DTensor inserting the collectives, except where
a kernel or a data-dependent dispatch must see plain tensors:

* K5 gets each rank's block through ``local_map`` (:func:`_ssd_chunk`):
  its chunks split as the batch is, its heads split where B and C are one
  group, whole otherwise; ``SSDChunk``'s gradient flows through the map;
* the streamed attention runs on each rank's block of batch and heads,
  or of batch and queries where the KV heads do not split
  (:func:`_attention_seq`), one map instead of a dozen DTensor ops a query
  block;
* a reshape that splits or merges a split axis (a GQA projection over
  more ranks than KV heads) first makes whole what DTensor cannot carry
  through it, in the forward and in the gradient (:func:`_unflatten`,
  :func:`_merge`);
* ``moe_forward_local`` is the reference's ``shard_map`` dispatch: each
  batch shard routes only its own tokens, each ``model`` shard computes
  only its own experts, and the outputs are summed over ``model``;
* ``moe_shard_constraints`` pins the sort path's dispatch and combine
  buffers to the expert sharding, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import constrain, current_ctx
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


def _is_dt(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _pad(t, pad, value=0.0):
    """``F.pad``; on a DTensor on each rank's block, every padded axis made
    whole first (DTensor's own padding rule is not reliable across torch
    versions)."""
    if not _is_dt(t):
        return F.pad(t, pad, value=value)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    dims = {t.ndim - 1 - i // 2 for i, n in enumerate(pad) if n}
    lay = [Replicate() if p.is_partial() or (p.is_shard() and p.dim % t.ndim in dims)
           else p for p in t.placements]
    mesh = t.device_mesh
    return local_map(lambda u: F.pad(u, pad, value=value), lay, in_placements=(lay,),
                     device_mesh=mesh)(t.redistribute(mesh, lay))


def _cumsum(t, dim: int):
    """``torch.cumsum``; on a DTensor on each rank's block, ``dim`` made
    whole first (torch 2.11's DTensor has no rule for the ``flip`` of its
    gradient)."""
    if not _is_dt(t):
        return torch.cumsum(t, dim=dim)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    lay = [Replicate() if p.is_partial() or (p.is_shard() and p.dim % t.ndim == dim)
           else p for p in t.placements]
    mesh = t.device_mesh
    return local_map(lambda u: torch.cumsum(u, dim=dim), lay, in_placements=(lay,),
                     device_mesh=mesh)(t.redistribute(mesh, lay))


def _whole_map(fn, *ts, n_out: int = 1):
    """``fn(*ts)`` (``n_out`` results); on DTensors on whole tensors on
    every rank, the results whole too: gathers and scatters by an index
    that every rank holds whole, and integer index math that DTensor has
    no rule for (``searchsorted``)."""
    if not any(_is_dt(t) for t in ts):
        return fn(*ts)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from torch.distributed.tensor import DTensor

    mesh = next(t for t in ts if _is_dt(t)).device_mesh
    whole = [Replicate()] * mesh.ndim
    # a plain operand (a zero buffer made in the step) is the same on every rank
    ts = [t.redistribute(mesh, whole) if _is_dt(t)
          else DTensor.from_local(t, mesh, whole, run_check=False) for t in ts]
    out = whole if n_out == 1 else tuple(whole for _ in range(n_out))
    return local_map(fn, out, in_placements=tuple(whole for _ in ts),
                     device_mesh=mesh)(*ts)


def _take(src, idx):
    """``src[idx]``: rows of ``src`` by an index."""
    return _whole_map(lambda a, i: a[i], src, idx)


def _index_add(dst, idx, src):
    """``dst.index_add(0, idx, src)``, out of place."""
    return _whole_map(lambda d, i, a: d.index_add(0, i, a), dst, idx, src)


def _causal_depthwise_conv(u, w, b):
    """u: (B, S, C); w: (C, K) depthwise causal conv along S.

    Written as K shifted multiply-adds accumulated in f32, not
    ``F.conv1d``: on the card a float32 convolution goes through cuDNN in
    TF32 by default.  The sum is cast to ``u.dtype`` before the bias is
    added, as the reference's conv output is."""
    k = w.shape[1]
    s = u.shape[1]
    up = _pad(u, (0, 0, k - 1, 0)).to(f32)                   # (B, S+K-1, C)
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
        tail = _pad(tail, (pad, 0))
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


def _whole_on(t, dims):
    """The DTensor ``t`` with every split of an axis in ``dims`` undone."""
    from torch.distributed.tensor import Replicate

    pls = t.placements
    if not any(p.is_shard() and p.dim in dims for p in pls):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_shard() and p.dim in dims else p for p in pls])


def _unflatten_dt(t, dim, sizes):
    # DTensor splits only the leading factor of an axis it unflattens, and
    # only where the ranks divide it
    split = [i for i, p in enumerate(t.placements) if p.is_shard(dim)]
    if sizes[0] % math.prod(t.device_mesh.size(i) for i in split):
        t = _whole_on(t, (dim,))
    return t.reshape(t.shape[:dim] + tuple(sizes) + t.shape[dim + 1:])


def _merge_dt(t, dim, count):
    # DTensor keeps a split of the leading axis of a merge, no other
    t = _whole_on(t, range(dim + 1, dim + count))
    return t.reshape(t.shape[:dim] + (-1,) + t.shape[dim + count:])


class _Reshape(torch.autograd.Function):
    """An unflatten or a merge of DTensor axes whose gradient, the inverse
    reshape, first undoes the splits that DTensor cannot carry through it
    (a gradient arrives split as the layers after it split it)."""

    @staticmethod
    def forward(ctx, t, dim, sizes):
        ctx.dim, ctx.sizes = dim, sizes
        if isinstance(sizes, int):                        # merge `sizes` axes
            ctx.back = tuple(t.shape[dim:dim + sizes])
            return _merge_dt(t, dim, sizes)
        return _unflatten_dt(t, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        if isinstance(ctx.sizes, int):
            return _unflatten_dt(g, ctx.dim, ctx.back), None, None
        return _merge_dt(g, ctx.dim, len(ctx.sizes)), None, None


def _unflatten(t, dim: int, sizes):
    """``t`` with axis ``dim`` split into ``sizes`` (a reshape).  Over a
    mesh whose split of that axis does not divide ``sizes[0]`` (8 KV heads
    of a projection split 16 ways), the axis is made whole first."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return _Reshape.apply(t, dim, tuple(sizes))
    return t.unflatten(dim, sizes)


def _merge(t, dim: int, count: int):
    """``t`` with axes ``dim .. dim + count - 1`` merged into one (a
    reshape); over a mesh, a split of any but the first is undone first."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return _Reshape.apply(t, dim, count)
    return t.flatten(dim, dim + count - 1)


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
    qg = _unflatten(q, 2, (hkv, rep))
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg.to(f32), k.to(f32)) * scale
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if not attn_f32:
        probs = probs.to(q.dtype).to(f32)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v.to(f32))
    return _merge(out, 2, 2).to(q.dtype)


def attention_seq(q, k, v, *, window: Optional[int], q_block: int = 512,
                  attn_f32: bool = True, q_offset: int = 0):
    """Causal (optionally windowed) attention, streamed over Q blocks.

    q: (B, Sq, H, hd) at positions ``q_offset .. q_offset + Sq - 1``; k, v:
    (B, S, H, hd) at positions 0..S-1 (aligned with q when Sq = S, the
    reference's only case; a rank's block of queries over a mesh starts
    later).  The reference pads the last block to ``q_block`` rows and
    drops them; the port runs it short.
    """
    b, s, hq, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    qb = min(q_block, s)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for q0 in range(0, s, qb):
        q_pos = torch.arange(q_offset + q0, q_offset + min(q0 + qb, s),
                             device=q.device)
        mask = kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= kv_pos[None, :] > (q_pos[:, None] - window)
        outs.append(_attend_block(q[:, q0:q0 + qb], k, v, mask, scale,
                                  attn_f32=attn_f32))
    return torch.cat(outs, dim=1)


def _attention_seq(q, k, v, *, window, attn_f32):
    """:func:`attention_seq`; on DTensors, on each rank's block
    (``local_map``).  The batch stays split as q's is.  Where q arrives
    split another way on a mesh axis, the heads stay split if the ranks
    divide the KV heads too (every local query head then finds its KV
    head); else the queries split over that axis instead, in contiguous
    blocks, against all the keys (the mask reads every key's position).
    Every other axis is whole.  The output comes back in q's layout.  One
    map instead of the ~12 DTensor ops of each of the S / 512 query
    blocks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(q, DTensor):
        return attention_seq(q, k, v, window=window, attn_f32=attn_f32)
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    lq, lkv = [], []
    q_split = 1                                  # ranks that split the queries
    q_index = 0                                  # this rank's query block
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        if pl.is_shard(0):
            lq.append(Shard(0)), lkv.append(Shard(0))
        elif pl.is_shard(2) and k.shape[2] % n == 0:
            lq.append(Shard(2)), lkv.append(Shard(2))
        elif pl.is_shard() and q.shape[1] % (q_split * n) == 0:
            lq.append(Shard(1)), lkv.append(Replicate())
            q_split, q_index = q_split * n, q_index * n + mesh.get_local_rank(i)
        else:
            lq.append(Replicate()), lkv.append(Replicate())
    q_offset = q_index * (q.shape[1] // q_split)
    args = [q.redistribute(mesh, lq), k.redistribute(mesh, lkv),
            v.redistribute(mesh, lkv)]

    def blocks(qb, kb, vb):
        return attention_seq(qb, kb, vb, window=window, attn_f32=attn_f32,
                             q_offset=q_offset)

    g_kv = _grad_placements(lkv, lq)
    out = local_map(blocks, lq, in_placements=(lq, lkv, lkv),
                    in_grad_placements=(lq, g_kv, g_kv), device_mesh=mesh)(*args)
    # back in q's layout: the layers after see what they would without the map
    return out.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                   for pl in q.placements])


def _batch_heads_layout(t, heads_dim: int, n_heads: int):
    """One placement a mesh axis for a local map over batch and heads:
    the batch (axis 0) split as ``t``'s is, ``heads_dim`` split where
    ``t``'s is and the ranks divide ``n_heads``, every other axis whole."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = t.device_mesh
    return [Shard(0) if p.is_shard(0) else
            Shard(heads_dim) if p.is_shard(heads_dim) and n_heads % mesh.size(i) == 0
            else Replicate() for i, p in enumerate(t.placements)]


def _back_to(out, t):
    """``out`` in ``t``'s placements (pending sums of ``t`` made whole)."""
    from torch.distributed.tensor import Replicate

    return out.redistribute(out.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in t.placements])


def _attend_decode(q, k, v, mask, scale, *, attn_f32):
    """:func:`_attend_block` for one new token against the ring; on
    DTensors on each rank's block of batch and heads (every cache position
    whole: the softmax reads them all)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return _attend_block(q, k, v, mask, scale, attn_f32=attn_f32)
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    lay = _batch_heads_layout(q, 2, k.shape[2])
    args = [t.redistribute(mesh, lay) for t in (q, k, v)]
    out = local_map(lambda a, b, c: _attend_block(a, b, c, mask, scale,
                                                  attn_f32=attn_f32),
                    lay, in_placements=(lay, lay, lay), device_mesh=mesh)(*args)
    return _back_to(out, q)


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
    q = _unflatten(q, 2, (hq, hd))
    k = _unflatten(k, 2, (hkv, hd))
    v = _unflatten(v, 2, (hkv, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, cfg.norm_f32)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, cfg.norm_f32)
    positions = torch.arange(pos, pos + s, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode in ("train", "prefill"):
        out = _attention_seq(q, k, v, window=cfg.attn_window,
                             attn_f32=cfg.attn_f32)
        if mode == "prefill":
            w = min(cfg.attn_window or cache_len, cache_len)
            # keep the last `w` keys/values (ring starts full for s >= w)
            if s >= w:
                ks, vs = k[:, -w:], v[:, -w:]
            else:
                ks, vs = (_pad(t, (0, 0, 0, 0, 0, w - s)) for t in (k, v))
            new_cache = {"k": ks, "v": vs}
    else:  # decode: s == 1
        w = cache["k"].shape[1]
        slot = pos % w
        kv_pos = torch.arange(w, device=x.device)
        # the ring write as a select, not a slice assignment: over a mesh
        # that splits the cache's positions (kv_seq), every rank writes
        # only if it holds the slot
        hit = (kv_pos == slot)[None, :, None, None]
        ck = torch.where(hit, k, cache["k"])
        cv = torch.where(hit, v, cache["v"])
        # ring: entry is valid if its age (0 = newest) has been written
        age = (slot - kv_pos) % w
        mask = (age <= min(pos, w - 1))[None, :]
        scale = 1.0 / math.sqrt(hd)
        out = _attend_decode(q, ck, cv, mask, scale, attn_f32=cfg.attn_f32)
        new_cache = {"k": ck, "v": cv}

    out = _merge(out, 2, 2) @ p["wo"]
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


def _sort_slots(top_e, m, cap: int):
    """The global sort's dispatch: the routed pairs (T*K) in stable expert
    order, their tokens, whether each fits its expert's ``cap`` slots, and
    its slot in the (E * cap) buffer."""
    dev = top_e.device
    eid = top_e.reshape(-1)                                   # (T*K,)
    tid = torch.arange(top_e.shape[0], device=dev).repeat_interleave(m.top_k)
    order = torch.argsort(eid, stable=True)
    eid_s, tid_s = eid[order], tid[order]
    # position of each routed pair within its expert
    e_start = torch.searchsorted(eid_s, torch.arange(m.n_experts, device=dev))
    pos_in_e = torch.arange(eid_s.numel(), device=dev) - e_start[eid_s]
    keep = pos_in_e < cap
    slot = eid_s * cap + torch.where(keep, pos_in_e, 0)
    return order, tid_s, keep, slot


def moe_forward_sort(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Gather-dispatch MoE (the 'serial paradigm' analogue).

    Sort tokens by expert (stably), pack to per-expert capacity slots,
    grouped matmul over stacked expert weights, weighted combine.  With
    ``moe_shard_constraints`` the dispatch and combine buffers are pinned
    to the expert sharding (the identity outside a sharding context).  The
    combine adds ``x.dtype`` expert outputs
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
    order, tid_s, keep, slot = _whole_map(lambda e: _sort_slots(e, m, cap),
                                          top_e, n_out=4)

    # out of place: over a mesh the zero buffer is a replicated operand,
    # and every gather and scatter by a pair's index reads whole rows
    buf = torch.zeros((m.n_experts * cap, d), dtype=x.dtype, device=dev)
    buf = _index_add(buf, slot, torch.where(keep[:, None], _take(xf, tid_s), 0))
    xe = buf.reshape(m.n_experts, cap, d)
    if cfg.moe_shard_constraints:
        xe = constrain(xe, ("expert", None, None))
    hg = torch.bmm(xe, p["w_gate"])                           # "ecd,edf->ecf"
    hu = torch.bmm(xe, p["w_up"])
    ye = torch.bmm(F.silu(hg) * hu, p["w_down"])
    if cfg.moe_shard_constraints:
        ye = constrain(ye, ("expert", None, None))
    ye = ye.reshape(m.n_experts * cap, d)

    # combine: route each kept pair's expert output back to its token
    pair_w = _take(top_w.reshape(-1), order)                 # (T*K,)
    contrib = torch.where(keep[:, None], _take(ye, slot) * pair_w[:, None], 0)
    y = torch.zeros((t, d), dtype=contrib.dtype, device=dev)
    y = _index_add(y, tid_s, contrib)
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
    combine = combine.scatter_add(1, top_e, top_w)
    hg = torch.einsum("td,edf->tef", xf, p["w_gate"])
    hu = torch.einsum("td,edf->tef", xf, p["w_up"])
    ye = torch.einsum("tef,efd->ted", F.silu(hg) * hu, p["w_down"])
    y = torch.einsum("ted,te->td", ye.to(f32), combine).to(x.dtype)
    return y.reshape(b, s, d)


def _dispatch_local(xb, router, wg, wu, wd, m, e0: int):
    """One shard's part of :func:`moe_forward_local`: route the tokens of
    ``xb`` over all experts (the global sort's order and capacity), keep the
    pairs whose expert is one of this shard's ``e0 .. e0 + E_local``, run
    those experts and combine; the caller sums over the expert shards."""
    bl, sl, d = xb.shape
    t = bl * sl
    dev = xb.device
    xf = xb.reshape(t, d)
    top_w, top_e = _route(router, xf, m)
    cap = int(math.ceil(t * m.top_k / m.n_experts * m.capacity_factor))
    eid = top_e.reshape(-1)
    tid = torch.arange(t, device=dev).repeat_interleave(m.top_k)
    order = torch.argsort(eid, stable=True)
    eid_s, tid_s = eid[order], tid[order]
    e_start = torch.searchsorted(eid_s, torch.arange(m.n_experts, device=dev))
    pos_in_e = torch.arange(eid_s.numel(), device=dev) - e_start[eid_s]
    e_local = wg.shape[0]
    keep = (pos_in_e < cap) & (eid_s >= e0) & (eid_s < e0 + e_local)
    slot = torch.where(keep, (eid_s - e0) * cap + pos_in_e, 0)
    buf = torch.zeros((e_local * cap, d), dtype=xb.dtype, device=dev)
    buf.index_add_(0, slot, torch.where(keep[:, None], xf[tid_s], 0))
    xe = buf.reshape(e_local, cap, d)
    hg = torch.bmm(xe, wg)
    hu = torch.bmm(xe, wu)
    ye = torch.bmm(F.silu(hg) * hu, wd).reshape(e_local * cap, d)
    pair_w = top_w.reshape(-1)[order]
    contrib = torch.where(keep[:, None], ye[slot] * pair_w[:, None], 0)
    y = torch.zeros((t, d), dtype=contrib.dtype, device=dev)
    y.index_add_(0, tid_s, contrib)
    return y.to(xb.dtype).reshape(bl, sl, d)


def moe_forward_local(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Local-dispatch MoE (the reference's ``shard_map`` path, §Perf H5).

    Each batch shard routes only its own tokens, each ``model`` shard
    computes only its own ``n_experts / model`` experts on them (the token
    blocks are whole over ``model``, the expert weights split over it), and
    the shards' outputs are summed over ``model`` (a ``Partial`` DTensor:
    one (T_local, d) all-reduce where it is read).  With no sharding
    context, or experts that the model axis does not divide, it is the
    global sort, as in the reference.  A sort-path capacity drop depends
    on the tokens routed together, so the two agree exactly where nothing
    is dropped."""
    ctx = current_ctx()
    if ctx is None:
        return moe_forward_sort(p, x, cfg)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, rules = ctx
    m = cfg.moe
    names = list(mesh.mesh_dim_names)
    model_axes = tuple(a for a in rules.get("expert", ()) if a)
    if not model_axes or m.n_experts % mesh.size(names.index(model_axes[0])):
        return moe_forward_sort(p, x, cfg)
    batch_axes = tuple(a for a in rules.get("batch", ()) if a)
    if x.shape[0] % math.prod(mesh.size(names.index(a)) for a in batch_axes):
        batch_axes = ()
    mdim = names.index(model_axes[0])
    x_lay = [Shard(0) if a in batch_axes else Replicate() for a in names]
    w_lay = [Shard(0) if i == mdim else Replicate() for i in range(len(names))]
    out_lay = [Partial() if i == mdim else pl for i, pl in enumerate(x_lay)]
    e0 = mesh.get_local_rank(mdim) * (m.n_experts // mesh.size(mdim))
    r_lay = [Replicate()] * len(names)
    args = [x.redistribute(mesh, x_lay), p["router"].redistribute(mesh, r_lay)]
    args += [p[k].redistribute(mesh, w_lay) for k in ("w_gate", "w_up", "w_down")]
    lays = (x_lay, r_lay, w_lay, w_lay, w_lay)
    return local_map(
        lambda xb, r, wg, wu, wd: _dispatch_local(xb, r, wg, wu, wd, m, e0),
        out_lay, in_placements=lays,
        in_grad_placements=tuple(_grad_placements(lay, out_lay) for lay in lays),
        device_mesh=mesh)(*args)


def ffn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig):
    if cfg.moe is not None:
        if cfg.moe.dispatch == "onehot":
            return moe_forward_onehot(p, x, cfg)
        if cfg.moe.dispatch == "local":
            return moe_forward_local(p, x, cfg)
        return moe_forward_sort(p, x, cfg)
    return mlp_forward(p, x, cfg)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def _grad_placements(inp, out):
    """The placements of an input's gradient out of a ``local_map``: where
    the input is whole on a mesh dim but the outputs are split or summed
    there, each rank's gradient is a part of the sum (``Partial``)."""
    from torch.distributed.tensor import Partial

    return [Partial() if pi.is_replicate() and not po.is_replicate() else pi
            for pi, po in zip(inp, out)]


def _state_readout(c, h):
    """``einsum("bhn,bhpn->bhp")``: a decode step's output from its state;
    on DTensors on each rank's block of batch and heads."""
    from torch.distributed.tensor import DTensor

    if not isinstance(h, DTensor):
        return torch.einsum("bhn,bhpn->bhp", c, h)
    from torch.distributed.tensor.experimental import local_map

    mesh = h.device_mesh
    lay = _batch_heads_layout(h, 1, h.shape[1])
    out = local_map(lambda a, b: torch.einsum("bhn,bhpn->bhp", a, b), lay,
                    in_placements=(lay, lay), device_mesh=mesh)(
        c.redistribute(mesh, lay), h.redistribute(mesh, lay))
    return _back_to(out, h)


def _ssd_chunk(x, b, c, la):
    """K5 on tensors; on DTensors, K5 on each rank's block (``local_map``).

    The chunk axis (0) keeps the split the batch gave it; the heads (x's
    and la's axis 2) stay split where B and C are one group (every local
    head reads group 0), else they are made whole; every other split and
    pending sum is resolved first.  ``y`` comes back as x is laid out, the
    states (G, H, N, P) with the chunks' and heads' splits.  The map is
    differentiable: K5's gradient runs on the blocks."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return ssd_chunk(x, b, c, la)
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    one_group = b.shape[2] == 1
    lx, lbc, lst = [], [], []
    for pl in x.placements:
        if pl.is_shard(0):
            lx.append(Shard(0)), lbc.append(Shard(0)), lst.append(Shard(0))
        elif pl.is_shard(2) and one_group:
            lx.append(Shard(2)), lbc.append(Replicate()), lst.append(Shard(1))
        else:
            lx.append(Replicate()), lbc.append(Replicate()), lst.append(Replicate())
    args = (x.redistribute(mesh, lx), b.redistribute(mesh, lbc),
            c.redistribute(mesh, lbc), la.redistribute(mesh, lx))
    # where the heads are split, each rank's B and C gradient is its heads'
    gbc = _grad_placements(lbc, lx)

    def blocks(*ts):
        return ssd_chunk(*(t.contiguous() for t in ts))

    return local_map(blocks, (lx, lst), in_placements=(lx, lbc, lbc, lx),
                     in_grad_placements=(lx, gbc, gbc, lx),
                     device_mesh=mesh)(*args)


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
    xs = _unflatten(xs, 2, (nh, hdim))
    bmat = _unflatten(bmat, 2, (g, n))                     # per group, not head
    cmat = _unflatten(cmat, 2, (g, n))
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
        y = _state_readout(c_t.to(f32), h_state)
        y = y + p["D_skip"].to(f32)[None, :, None] * xs[:, 0].to(f32)
        y = _merge(y, 1, 2)[:, None]
        new_cache["ssd"] = h_state
    else:
        q = min(s_cfg.chunk, s)
        pad = (-s) % q
        if pad:
            # zero inputs and zero log decay (decay 1) past the sequence
            def padfn(u):
                return _pad(u, (0, 0) * (u.ndim - 2) + (0, pad))
            xs, bmat, cmat, la, dt = map(padfn, (xs, bmat, cmat, la, dt))
        nc = xs.shape[1] // q
        xc = xs.reshape(b, nc, q, nh, hdim)
        lac = la.reshape(b, nc, q, nh)
        xdt = xc.to(f32) * dt.reshape(b, nc, q, nh)[..., None]       # (B,C,Q,H,P)
        cc = cmat.to(f32).reshape(b, nc, q, g, n).contiguous()       # (B,C,Q,G,N)
        # the intra-chunk block, y_diag and the chunk states: K5 over B*C
        # chunks; B and C go in once per group, contiguous (in f32 without
        # padding they are views of the split, so this copies (B,S,G,N))
        y_diag, states = _ssd_chunk(
            xdt.reshape(b * nc, q, nh, hdim).contiguous(),
            bmat.to(f32).reshape(b * nc, q, g, n).contiguous(),
            cc.reshape(b * nc, q, g, n),
            lac.reshape(b * nc, q, nh).contiguous(),
        )
        y_diag = y_diag.reshape(b, nc, q, nh, hdim)
        states = states.reshape(b, nc, nh, n, hdim)
        cs = _cumsum(lac, 2)                                           # (B,C,Q,H)
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
            _unflatten(hprevs, 2, (g, nh // g)),
        )
        y_off = _merge(y_off, 3, 2) * dec_from_start[..., None]
        y = _merge(y_diag + y_off, 1, 2)[:, :s]
        y = y + p["D_skip"].to(f32)[None, None, :, None] * xs[:, :s].to(f32)
        y = _merge(y, 2, 2)
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
    ``odd`` or one longer).  Out of place (a stack and a reshape), so that
    DTensor sees every element move."""
    n = odd.shape[1]
    out = _merge(torch.stack([even[:, :n], odd], dim=2), 1, 2)
    if even.shape[1] > n:
        out = torch.cat([out, even[:, n:]], dim=1)
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
