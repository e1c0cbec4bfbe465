"""Plain PyTorch version of the Mamba-2 SSD intra-chunk block (K5).

One chunk of the state-space-duality computation (arXiv 2405.21060 §6),
as ``repro.kernels.ssd_chunk.ref.ssd_chunk_ref`` states it::

    Y[i, h, p] = sum_{j<=i} C[i,h,:].B[j,h,:] * exp(cs[i,h]-cs[j,h]) * X[j,h,p]
    S[h, n, p] = sum_j B[j,h,n] * exp(cs[last,h]-cs[j,h]) * X[j,h,p]

with ``cs`` the running sum of the log decays ``la`` over the chunk.  Three
extensions over the reference: leading chunk dimension ``G`` (the model
hands every chunk of every sequence to one call), ``B`` and ``C`` given
once per group of heads (``Hg`` groups; head ``h`` reads group
``h // (H / Hg)``, and ``Hg = H`` is the reference's per-head layout), and
``exp`` evaluated only where ``j <= i``.  The reference takes
``exp(cs_i - cs_j)`` everywhere and masks afterwards; above the diagonal
that difference is positive and, with a mamba2 layer's decays (``cs``
falls by up to ~11 a step), overflows to ``inf``.  Here the masked
entries become ``-inf`` before ``exp``, so they are exactly 0.
"""
from __future__ import annotations

import torch


def ssd_chunk_ref(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  la: torch.Tensor):
    """x: ([G,] Q, H, P) inputs pre-scaled by dt; b, c: ([G,] Q, Hg, N)
    with ``H % Hg == 0``; la: ([G,] Q, H) log decays (<= 0).

    Returns ``y`` ([G,] Q, H, P) and the chunk state ([G,] H, N, P), f32.

    ``cs`` is one running sum along Q: on the card ``cumsum`` over a
    dimension that is not the innermost adds in order in f32, as the CUDA
    kernel does (the CPU's adds in order in double).  The decays
    ``exp(cs_i - cs_j)`` take the rounding of ``cs`` (an ulp of up to
    |cs| ~ 20 in the reference's tests) onto terms whose sum may cancel,
    so on the card both versions form ``cs`` alike.
    """
    single = x.ndim == 3
    if single:
        x, b, c, la = x[None], b[None], c[None], la[None]
    q, heads = x.shape[1], x.shape[2]
    per_group = heads // b.shape[2]
    cs = torch.cumsum(la, dim=1)                               # (G, Q, H)
    diff = cs[:, :, None, :] - cs[:, None, :, :]               # (G, Qi, Qj, H)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    lmat = diff.masked_fill(~causal[None, :, :, None], float("-inf")).exp()
    # one score matrix per group, shared by its heads
    scores = torch.einsum("gikn,gjkn->gijk", c, b)             # (G, Qi, Qj, Hg)
    scores = scores.repeat_interleave(per_group, dim=3) * lmat  # (G, Qi, Qj, H)
    y = torch.einsum("gijh,gjhp->gihp", scores, x)
    dec_to_end = torch.exp(cs[:, -1:, :] - cs)                 # (G, Q, H)
    b_heads = b.repeat_interleave(per_group, dim=2)            # (G, Q, H, N)
    state = torch.einsum("gjhn,gjhp->ghnp", b_heads * dec_to_end[..., None], x)
    if single:
        return y[0], state[0]
    return y, state
