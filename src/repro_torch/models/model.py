"""Model driver (the port of ``repro.models.model``): prefill and decode
over the stacked layer groups.

The reference scans each group's stacked layers with ``jax.lax.scan``; the
port loops over them in Python and stacks the new caches back into the
reference's tree (``caches[g][t][name]`` with a leading ``layers`` axis).
The reference's ``constrain`` (a sharding constraint, the identity without
a mesh) and its bf16 gradient barrier (the identity in the forward pass)
are dropped.  ``train_loss`` is not ported yet (ROADMAP §1 item 7).
Every float32 product runs in full float32: a call refuses to run on the
card while TF32 is on for matrix products
(:func:`repro_torch.device.require_full_f32`).
"""
from __future__ import annotations

import torch

from ..device import require_full_f32, resolve_device
from .blocks import block_forward, rms_norm
from .config import ModelConfig
from .init import group_layers, torch_dtype

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


def _run_groups(params, cfg: ModelConfig, x, *, mode, pos, caches, cache_len):
    """Each pattern group's layers in order; returns (x, new_caches)."""
    require_full_f32(x.device)
    new_caches = []
    for gi, (types, repeat) in enumerate(group_layers(cfg)):
        gparams = params["groups"][gi]
        gcache = caches[gi] if caches is not None else None
        per_layer = []
        for li in range(repeat):
            lp = _layer(gparams, li)
            lc = _layer(gcache, li) if gcache is not None else None
            new_lc = []
            for ti, bt in enumerate(types):
                c = lc[ti] if lc is not None else None
                x, nc = block_forward(
                    bt, lp[ti], x, cfg,
                    mode=mode, pos=pos, cache=c, cache_len=cache_len,
                )
                new_lc.append(nc)
            per_layer.append(None if all(c is None for c in new_lc) else new_lc)
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
    x = params["tok_embed"][tokens.long()]
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        pe = torch.as_tensor(batch["patch_embeds"], device=dev).to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    return x, batch.get("labels")


def _logits(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    head = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


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
