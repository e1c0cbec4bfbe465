"""Model driver (the port of ``repro.models.model``): the training loss
and its gradients, prefill and decode over the stacked layer groups.

The reference scans each group's stacked layers with ``jax.lax.scan``; the
port loops over them in Python and stacks the new caches back into the
reference's tree (``caches[g][t][name]`` with a leading ``layers`` axis).
In train mode each layer's body runs under activation checkpointing when
``cfg.remat`` is set (the reference's ``jax.checkpoint`` of its scan body)
and ends in the bf16 gradient barrier when ``cfg.grad_bf16`` is set.

Over a mesh the same code runs on DTensor trees
(:mod:`repro_torch.distributed.sharding`), with the reference's
``constrain`` pins on the embedded sequence and the logits, and one more
on the residual stream after every block (the reference leaves that to
GSPMD's propagation; DTensor chooses op by op).  The cross
entropy over logits that split the vocabulary over ranks is the
vocabulary-parallel one (:func:`_nll_terms`): each rank reduces its block
of the vocabulary, and only (B, S) maxima and sums cross ranks.
Every float32 product runs in full float32: a call refuses to run on the
card while TF32 is on for matrix products
(:func:`repro_torch.device.require_full_f32`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import require_full_f32, resolve_device
from ..distributed.sharding import constrain, resolve_partial
from .blocks import _grad_placements, _pad, block_forward, rms_norm
from .config import ModelConfig
from .init import group_layers, torch_dtype
from ..tree import leaves, unflatten_like

f32 = torch.float32


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (every leaf indexed on its first axis)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layer(v, i) for v in tree]
    return tree[i]


def _stack(trees):
    """The per-layer trees stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


class _BF16GradBarrier(torch.autograd.Function):
    """Identity with a bf16 cotangent (the reference's §Perf H8): pins the
    gradient of the residual stream to bf16 between layers."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _run_groups(params, cfg: ModelConfig, x, *, mode, pos, caches, cache_len):
    """Each pattern group's layers in order; returns (x, new_caches)."""
    require_full_f32(x.device)
    train = mode == "train"
    new_caches = []
    for gi, (types, repeat) in enumerate(group_layers(cfg)):
        gparams = params["groups"][gi]
        gcache = caches[gi] if caches is not None else None

        def body(x, lp, lc, types=types):
            # types bound now: under remat the body reruns in the backward
            new_lc = []
            for ti, bt in enumerate(types):
                c = lc[ti] if lc is not None else None
                x, nc = block_forward(
                    bt, lp[ti], x, cfg,
                    mode=mode, pos=pos, cache=c, cache_len=cache_len,
                )
                # the residual stream between blocks as it enters the first
                # (the identity outside a sharding context): DTensor picks
                # each op's layout by the least redistribution, and left
                # alone splits the model axis over d_model, then gathers
                # whole weight matrices to meet it
                x = constrain(x, ("batch", "seq", None))
                if cfg.grad_bf16 and train:
                    x = _BF16GradBarrier.apply(x)
                new_lc.append(nc)
            return x, (None if all(c is None for c in new_lc) else new_lc)

        per_layer = []
        for li in range(repeat):
            lp = _layer(gparams, li)
            lc = _layer(gcache, li) if gcache is not None else None
            if cfg.remat and train:
                x, new_lc = checkpoint(body, x, lp, lc, use_reentrant=False)
            else:
                x, new_lc = body(x, lp, lc)
            per_layer.append(new_lc)
        new_caches.append(None if per_layer[0] is None else _stack(per_layer))
    return x, (new_caches if caches is not None or mode == "prefill" else None)


def _embed(params, cfg: ModelConfig, batch):
    """Token / frontend embedding.  Returns (x, labels_or_None).  The
    frontends are the reference's stubs: audio hands over its frame
    embeddings (``embeds``), vision prepends its patch embeddings."""
    dev = params["tok_embed"].device
    if cfg.frontend == "audio" and "embeds" in batch:
        x = torch.as_tensor(batch["embeds"], device=dev).to(torch_dtype(cfg))
        return x, batch.get("labels")
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = _embed_rows(params["tok_embed"], tokens.long())
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = torch.as_tensor(batch["patch_embeds"], device=dev).to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    return x, batch.get("labels")


def _embed_rows(table, tokens):
    """``table[tokens]``.  On DTensors on each rank's block: the tokens as
    the batch splits them, the table's rows as the vocabulary splits them
    (a rank looks up the tokens it holds rows of and the ranks' rows are
    summed), its columns as the embedding splits them where the batch does
    not use that mesh axis (else made whole there, as FSDP gathers a
    weight before its use)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(table, DTensor):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    tokens = resolve_partial(tokens)
    t_lay, k_lay, out = [], [], []
    v_split, v_index = 1, 0
    for i, (pt, pk) in enumerate(zip(table.placements, tokens.placements)):
        if pk.is_shard(0):
            t_lay.append(Replicate()), k_lay.append(Shard(0)), out.append(Shard(0))
        elif pt.is_shard(0):
            t_lay.append(Shard(0)), k_lay.append(Replicate()), out.append(Partial())
            v_split, v_index = v_split * mesh.size(i), v_index * mesh.size(i) + \
                mesh.get_local_rank(i)
        elif pt.is_shard(1):
            t_lay.append(Shard(1)), k_lay.append(Replicate()), out.append(Shard(2))
        else:
            t_lay.append(Replicate()), k_lay.append(Replicate()), out.append(Replicate())
    v0 = v_index * (table.shape[0] // v_split)

    def rows(tab, tok):
        j = tok - v0
        hit = (j >= 0) & (j < tab.shape[0])
        got = tab[torch.where(hit, j, 0)]
        return torch.where(hit[..., None], got, 0) if v_split > 1 else got

    x = local_map(rows, out, in_placements=(t_lay, k_lay),
                  in_grad_placements=(_grad_placements(t_lay, out), k_lay),
                  device_mesh=mesh)(table.redistribute(mesh, t_lay),
                                    tokens.redistribute(mesh, k_lay))
    return resolve_partial(x)


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    head = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(x @ head, ("batch", None, "vocab"))


def _next_token_labels(cfg: ModelConfig, batch, x):
    """``batch["labels"]`` on ``x``'s device, else the token stream shifted
    by one with ``-100`` at the end (and, for the vision arch, in front of
    every patch position)."""
    if batch.get("labels") is not None:
        return torch.as_tensor(batch["labels"], device=x.device)
    tokens = torch.as_tensor(batch["tokens"], device=x.device)
    labels = _pad(tokens[:, 1:], (0, 1), value=-100)
    if cfg.frontend == "vision":
        labels = _pad(labels, (x.shape[1] - tokens.shape[1], 0), value=-100)
    return labels


def label_count(cfg: ModelConfig, batch) -> torch.Tensor:
    """How many positions of ``batch`` carry a label: the divisor of
    :func:`train_loss` (before its ``max(., 1)``)."""
    if batch.get("labels") is not None:
        return (torch.as_tensor(batch["labels"]) >= 0).sum()
    tokens = torch.as_tensor(batch["tokens"])
    return (tokens[:, 1:] >= 0).sum()


def train_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Next-token cross entropy (an f32 scalar).  batch: tokens (B, S)
    [+ labels / embeds / patch_embeds].  The reference's order: logits in
    the model's dtype, then f32, ``logsumexp``, the gold logit, the masked
    sum over positions with a label, divided by ``max(count, 1)``; with
    ``cfg.loss_chunk`` dividing S, the sums run over sequence chunks in
    order (only a (B, chunk, vocab) block of f32 logits at a time)."""
    x, _ = _embed(params, cfg, batch)
    x = constrain(x, ("batch", "seq", None))
    x, _ = _run_groups(params, cfg, x, mode="train", pos=0, caches=None,
                       cache_len=0)
    labels = _next_token_labels(cfg, batch, x)

    def ce(x_blk, labels_blk):
        logits = _logits(params, cfg, x_blk).to(f32)
        mask = labels_blk >= 0
        safe = torch.where(mask, labels_blk, 0).long()
        lse, gold = _nll_terms(logits, safe)
        return ((lse - gold) * mask).sum(), mask.sum()

    s = x.shape[1]
    chunk = cfg.loss_chunk
    if chunk and chunk < s and s % chunk == 0:
        nll_sum = torch.zeros((), dtype=f32, device=x.device)
        n = torch.zeros((), dtype=torch.int64, device=x.device)
        for c0 in range(0, s, chunk):
            nll, cnt = ce(x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
            nll_sum, n = nll_sum + nll, n + cnt
        return nll_sum / torch.clamp(n, min=1)
    nll, cnt = ce(x, labels)
    return nll / torch.clamp(cnt, min=1)


def _vocab_mesh_dim(logits):
    """The mesh dim that splits a DTensor's vocabulary (last) axis, or None
    (a tensor, or a DTensor whose vocabulary is whole on every rank)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(logits, DTensor):
        return None
    dims = [i for i, p in enumerate(logits.placements)
            if p.is_shard(logits.ndim - 1)]
    if len(dims) > 1:
        raise ValueError(f"logits split their vocabulary over mesh dims {dims}")
    return dims[0] if dims else None


def _nll_terms(logits, safe):
    """(``logsumexp`` over the vocabulary, the gold logit) a position.

    On logits whose vocabulary is split over a mesh dim, each rank works on
    its block: the maximum (a ``max`` all-reduce, no gradient: the log-sum
    does not depend on it), the sum of ``exp(logit - max)`` (a sum
    all-reduce), and the gold logit where this rank holds the label (zero
    elsewhere, a sum all-reduce).  ``torch.logsumexp``'s formula, max plus
    the log of the shifted sum, in another summation order."""
    logits = resolve_partial(logits)
    vdim = _vocab_mesh_dim(logits)
    if vdim is None:
        lse = torch.logsumexp(logits, dim=-1)
        return lse, torch.gather(logits, -1, safe[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    lay = [p if p.is_shard() else Replicate() for p in logits.placements]
    logits = logits.redistribute(mesh, lay)
    # (B, S) terms: the logits' batch and sequence splits, whole over vdim
    row = [Replicate() if i == vdim else p for i, p in enumerate(lay)]
    safe = safe.redistribute(mesh, row)
    part = lambda op: [Partial(op) if i == vdim else p for i, p in enumerate(row)]
    v0 = mesh.get_local_rank(vdim) * (logits.shape[-1] // mesh.size(vdim))

    gmax = local_map(lambda lg: lg.detach().amax(dim=-1), part("max"),
                     device_mesh=mesh)(logits).redistribute(mesh, row)
    sumexp = local_map(lambda lg, m: torch.exp(lg - m[..., None]).sum(dim=-1),
                       part("sum"), device_mesh=mesh)(logits, gmax)

    def gold_block(lg, sf):
        j = sf - v0
        here = (j >= 0) & (j < lg.shape[-1])
        g = torch.gather(lg, -1, torch.where(here, j, 0)[..., None])[..., 0]
        return torch.where(here, g, 0.0)

    gold = local_map(gold_block, part("sum"), device_mesh=mesh)(logits, safe)
    return gmax + torch.log(sumexp), gold


def value_and_grad(params, cfg: ModelConfig, batch):
    """(loss, grads): ``train_loss`` and its gradient with respect to every
    leaf of ``params``, as a tree of the same structure (detached).  A leaf
    the loss does not reach (the audio arch's ``tok_embed`` when the batch
    hands over frame embeddings) gets zeros, as ``jax.grad`` gives it."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        loss = train_loss(unflatten_like(params, flat), cfg, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _like_param(g, p)
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten_like(params, grads)


def _like_param(g, p):
    """A DTensor gradient in its parameter's placements (a gradient may come
    back with sums pending over the ranks that split the batch)."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch_size: int, cache_len: int, device=None):
    """Zeroed decode caches, stacked (repeat, ...) per group, on ``device``
    (default: the card, or raise)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    caches = []
    for types, repeat in group_layers(cfg):
        per_type = []
        for bt in types:
            if bt == "attn":
                w = min(cfg.attn_window or cache_len, cache_len)
                kv = (repeat, batch_size, w, cfg.n_kv_heads, cfg.head_dim)
                per_type.append({"k": zeros(*kv), "v": zeros(*kv)})
            elif bt == "mamba2":
                s = cfg.ssm
                d_in = s.expand * cfg.d_model
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                per_type.append({
                    "conv": zeros(repeat, batch_size, conv_dim, s.d_conv - 1),
                    "ssd": zeros(repeat, batch_size, d_in // s.head_dim,
                                 s.head_dim, s.d_state, dtype=f32),
                })
            elif bt == "rglru":
                r = cfg.rglru.d_rnn or cfg.d_model
                per_type.append({
                    "conv": zeros(repeat, batch_size, r, cfg.rglru.d_conv - 1),
                    "h": zeros(repeat, batch_size, r, dtype=f32),
                })
        caches.append(per_type)
    return caches


def prefill(params, cfg: ModelConfig, batch, cache_len: int):
    """Full-sequence forward; returns (last-token logits, caches).  Runs on
    the device the parameters lie on."""
    x, _ = _embed(params, cfg, batch)
    x = constrain(x, ("batch", "seq", None))
    x, caches = _run_groups(params, cfg, x, mode="prefill", pos=0,
                            caches=None, cache_len=cache_len)
    logits = _logits(params, cfg, x[:, -1:, :])
    return logits, caches


def decode_step(params, cfg: ModelConfig, tokens, pos, caches, cache_len: int):
    """One decode step.  tokens: (B, 1) integers; pos: the position."""
    x, _ = _embed(params, cfg, {"tokens": tokens})
    x, new_caches = _run_groups(params, cfg, x, mode="decode", pos=pos,
                                caches=caches, cache_len=cache_len)
    return _logits(params, cfg, x), new_caches
