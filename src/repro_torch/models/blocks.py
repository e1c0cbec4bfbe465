"""Block forwards (the port of ``repro.models.blocks``): the Mamba-2 SSD block.

Pure functions over param dicts, in the reference's three modes:

* train   — full sequence, no cache (forward only: the port has no training
  stack yet)
* prefill — full sequence, returns the decode cache
* decode  — one new token against the cache

Only ``mamba2`` is ported; ``attn`` and ``rglru`` (and the MoE
feed-forwards) raise until ROADMAP §1 item 7 ports them.

One difference from the reference, by design: the reference evaluates the
intra-chunk block (``y_diag`` and the chunk ``states``, ``blocks.py``
452-463) inline with ``jnp.einsum`` and never calls its own SSD kernel.
The port routes that same function through K5
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
        # the reference's einsum "bck,ck->bc", accumulated in f32
        acc = (conv_state.to(f32) * p["conv_w"].to(f32)).sum(dim=-1)
        xbc = F.silu(acc.to(x.dtype) + p["conv_b"])[:, None, :]
    else:
        if mode == "prefill":
            k = s_cfg.d_conv
            tail = xbc.transpose(1, 2)[:, :, -(k - 1):]
            pad = (k - 1) - tail.shape[2]
            if pad > 0:
                tail = F.pad(tail, (pad, 0))
            new_cache["conv"] = tail.contiguous()
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
# dispatch
# ---------------------------------------------------------------------------

def block_forward(btype: str, p, x, cfg, *, mode, pos, cache, cache_len=0):
    if btype == "mamba2":
        return mamba2_forward(p, x, cfg, mode=mode, cache=cache)
    if btype in ("attn", "rglru"):
        raise NotImplementedError(
            f"{btype!r} blocks are not ported yet (ROADMAP.md §1 item 7)"
        )
    raise ValueError(btype)
