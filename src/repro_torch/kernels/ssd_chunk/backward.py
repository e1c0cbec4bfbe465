"""The gradient of the SSD intra-chunk block (K5), in plain PyTorch.

The reference has no backward kernel: its gradient is XLA's autodiff of
the inline einsums (``repro/models/blocks.py`` 452-463).  This is that
gradient written out, one function for both devices, so the CPU tests
check the code the card runs.  Per chunk, with ``cs = cumsum(la)``,
``L[i,j,h] = exp(cs_i - cs_j)`` for ``j <= i`` (else 0),
``S[i,j,k] = c_i . b_j`` over group ``k``, ``M = S * L`` (head ``h``
reading its group) and ``d[j,h] = exp(cs_last - cs_j)``::

    gx[j]   = sum_{i>=j} M[i,j] gy[i] + d[j] (b_j . gstate)
    dM[i,j] = gy[i] . x[j]          dS = sum over a group's heads of dM * L
    gc[i]   = sum_j dS[i,j] b_j
    gb[j]   = sum_i dS[i,j] c_i + sum over the group's heads of d[j] (gstate . x_j)
    gcs     = the decay terms dM * M and gd * d: + to cs_i, - to cs_j
    gla     = the reverse cumulative sum of gcs

The masked entries become ``-inf`` before ``exp``, as in the forward's
plain version, so nothing above the diagonal overflows.  On the CPU the
contractions sum in f64 and round once at the end (any summation order
gives the same f32, as :func:`~.ref.ssd_chunk_ref` does); the card keeps
f32, except for the log-decay gradient's cancelling sums, which run in f64
on both devices.
"""
from __future__ import annotations

import torch


def ssd_chunk_backward(x, b, c, la, gy, gstate):
    """Gradients (gx, gb, gc, gla) of ``y`` and ``state`` of
    ``ssd_chunk(x, b, c, la)`` given their cotangents ``gy`` ([G,] Q, H, P)
    and ``gstate`` ([G,] H, N, P).  Shapes as :func:`~.ops.ssd_chunk`."""
    single = x.ndim == 3
    if single:
        x, b, c, la, gy, gstate = (t[None] for t in (x, b, c, la, gy, gstate))
    g, q, h, p = x.shape
    dtypes = (x.dtype, b.dtype, c.dtype, la.dtype)
    hg, n = b.shape[2:]
    per = h // hg
    cs = torch.cumsum(la, dim=1)                               # (G, Q, H)
    diff = cs[:, :, None, :] - cs[:, None, :, :]               # (G, Qi, Qj, H)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lmat = diff.masked_fill(~causal[None, :, :, None], float("-inf")).exp()
    dec = torch.exp(cs[:, -1:, :] - cs)                        # (G, Q, H)
    wide = torch.float64 if x.device.type == "cpu" else x.dtype
    x, b, c, gy, gstate, lmat, dec = (
        t.to(wide) for t in (x, b, c, gy, gstate, lmat, dec))

    scores = torch.einsum("gikn,gjkn->gijk", c, b)             # S (G, Qi, Qj, Hg)
    m = scores.repeat_interleave(per, dim=3) * lmat            # M (G, Qi, Qj, H)
    b_heads = b.repeat_interleave(per, dim=2)                  # (G, Q, H, N)
    b_gs = torch.einsum("gjhn,ghnp->gjhp", b_heads, gstate)    # b_j . gstate
    gx = torch.einsum("gijh,gihp->gjhp", m, gy) + dec[..., None] * b_gs

    dm = torch.einsum("gihp,gjhp->gijh", gy, x)                # dM
    ds = (dm * lmat).reshape(g, q, q, hg, per).sum(-1)         # dS (G, Qi, Qj, Hg)
    gc = torch.einsum("gijk,gjkn->gikn", ds, b)
    gs_x = torch.einsum("ghnp,gjhp->gjhn", gstate, x)          # gstate . x_j
    gb = (torch.einsum("gijk,gikn->gjkn", ds, c)
          + (dec[..., None] * gs_x).reshape(g, q, hg, per, n).sum(3))

    # the decay terms cancel (only differences of cs matter: gcs sums to 0
    # over a chunk), so their sums and the reverse cumulative sum run in
    # f64 on either device: in f32 on the card they moved mamba2-130m's
    # A_log gradient by 1e-4 of its scale
    f64 = torch.float64
    dmm = dm * m                                               # d loss / d log L
    gdd = ((b_gs * x).sum(-1) * dec).to(f64)                   # d loss / d log d
    gcs = dmm.sum(2, dtype=f64) - dmm.sum(1, dtype=f64) - gdd  # (G, Q, H)
    gcs[:, -1] += gdd.sum(1)
    gla = gcs.flip(1).cumsum(1).flip(1)

    out = tuple(t.to(dt) for t, dt in zip((gx, gb, gc, gla), dtypes))
    return tuple(t[0] for t in out) if single else out
