"""Parameter shapes, logical sharding axes and initialization (the port
of ``repro.models.init``).

``init_params(cfg, generator, device)`` returns a plain dict tree of
tensors in the reference's layout: ``groups[g][t][name]`` with a leading
``layers`` axis, one group per block pattern (``group_layers``).  The init
rules are the reference's (``_init_leaf``); the random numbers come from a
``torch.Generator`` and so differ from JAX's.  To run both packages on the
same weights, hand the JAX tree over as NumPy arrays
(:func:`repro_torch.convert.lm_params_from_numpy`).

The tables of the three block types (``attn``, ``mamba2``, ``rglru``, each
with its dense or MoE feed-forward leaves ``ffn.*``) are the reference's:
each leaf's shape and the logical name of each of its axes.  They give
:func:`param_specs` (the same tree as ``init_params`` with tuples of
logical axis names as leaves, which ``distributed.sharding`` resolves to a
mesh's specs), :func:`param_shapes` (the tree of ``init_params`` on the
meta device: the reference's ``jax.eval_shape(init_params)``, which the
dry run traces with) and :func:`param_count`.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..device import resolve_device
from .config import ModelConfig

def group_layers(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(block types of one scan body, repeat count), ...]."""
    period = len(cfg.block_pattern)
    full, rem = divmod(cfg.n_layers, period)
    groups: List[Tuple[Tuple[str, ...], int]] = []
    if full:
        groups.append((tuple(cfg.block_pattern), full))
    if rem:
        groups.append((tuple(cfg.block_pattern[:rem]), 1))
    return groups


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# per-block parameter tables: {leaf name: (shape, logical axes)}
# ---------------------------------------------------------------------------

def _ffn_shapes(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.moe is not None:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff
        return {
            "router": ((d, e), (None, "expert")),
            "w_gate": ((e, d, fe), ("expert", "embed", "expert_ff")),
            "w_up": ((e, d, fe), ("expert", "embed", "expert_ff")),
            "w_down": ((e, fe, d), ("expert", "expert_ff", "embed")),
        }
    if cfg.act == "swiglu":
        return {
            "w_gate": ((d, f), ("embed", "mlp")),
            "w_up": ((d, f), ("embed", "mlp")),
            "w_down": ((f, d), ("mlp", "embed")),
        }
    return {
        "w_up": ((d, f), ("embed", "mlp")),
        "w_down": ((f, d), ("mlp", "embed")),
    }


def _attn_shapes(cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    sh = {
        "ln1": ((d,), (None,)),
        "wq": ((d, hq * hd), ("embed", "heads")),
        "wk": ((d, hkv * hd), ("embed", "heads")),
        "wv": ((d, hkv * hd), ("embed", "heads")),
        "wo": ((hq * hd, d), ("heads", "embed")),
        "ln2": ((d,), (None,)),
    }
    if cfg.qkv_bias:
        sh["bq"] = ((hq * hd,), ("heads",))
        sh["bk"] = ((hkv * hd,), ("heads",))
        sh["bv"] = ((hkv * hd,), ("heads",))
    if cfg.qk_norm:
        sh["q_norm"] = ((hd,), (None,))
        sh["k_norm"] = ((hd,), (None,))
    for k, v in _ffn_shapes(cfg).items():
        sh[f"ffn.{k}"] = v
    return sh


def _mamba2_shapes(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    h = d_in // s.head_dim
    g, n = s.n_groups, s.d_state
    conv_dim = d_in + 2 * g * n
    proj_out = 2 * d_in + 2 * g * n + h
    return {
        "ln": ((d,), (None,)),
        "in_proj": ((d, proj_out), ("embed", "heads")),
        "conv_w": ((conv_dim, s.d_conv), ("heads", None)),
        "conv_b": ((conv_dim,), ("heads",)),
        "A_log": ((h,), (None,)),
        "D_skip": ((h,), (None,)),
        "dt_bias": ((h,), (None,)),
        "gn": ((d_in,), ("heads",)),
        "out_proj": ((d_in, d), ("heads", "embed")),
    }


def _rglru_shapes(cfg: ModelConfig):
    d = cfg.d_model
    r = cfg.rglru.d_rnn or d
    sh = {
        "ln1": ((d,), (None,)),
        "w_x": ((d, r), ("embed", "heads")),
        "w_g": ((d, r), ("embed", "heads")),
        "conv_w": ((r, cfg.rglru.d_conv), ("heads", None)),
        "conv_b": ((r,), ("heads",)),
        "lam": ((r,), ("heads",)),
        "w_a": ((r,), ("heads",)),        # diag recurrence-gate weight
        "b_a": ((r,), ("heads",)),
        "w_i": ((r,), ("heads",)),        # diag input-gate weight
        "b_i": ((r,), ("heads",)),
        "w_out": ((r, d), ("heads", "embed")),
        "ln2": ((d,), (None,)),
    }
    for k, v in _ffn_shapes(cfg).items():
        sh[f"ffn.{k}"] = v
    return sh


_BLOCK_SHAPES = {"attn": _attn_shapes, "mamba2": _mamba2_shapes, "rglru": _rglru_shapes}


def block_shapes(cfg: ModelConfig, btype: str) -> dict:
    """{leaf name: shape} of one block of type ``btype`` (no layers axis)."""
    return {k: shape for k, (shape, _axes) in _BLOCK_SHAPES[btype](cfg).items()}


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (embeddings included), from the shape tables."""
    n = cfg.vocab * cfg.d_model + cfg.d_model           # tok_embed, final_norm
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab                      # lm_head
    for types, repeat in group_layers(cfg):
        for bt in types:
            n += repeat * sum(math.prod(s) for s in block_shapes(cfg, bt).values())
    return n


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_leaf(shape, name: str, cfg: ModelConfig, generator: torch.Generator):
    """One leaf of ``shape`` (leading layers axis included) by the
    reference's rules (``repro.models.init._init_leaf``); ``name`` is the
    leaf's last dotted part (``ffn.w_down`` -> ``w_down``).  The rules that
    depend on a width read the last axis, which is the reference's first
    once the layers axis is added."""
    dt = torch_dtype(cfg)
    if name.startswith(("ln", "gn")) or name.endswith("norm") or name == "D_skip":
        return torch.ones(shape, dtype=dt)
    if name == "A_log":
        a = torch.log(torch.linspace(1.0, 16.0, shape[-1]))
        return a.expand(shape).to(dt).clone()
    if name == "lam":
        # Griffin: a in [0.9, 0.999] at init under a = sigmoid(lam)^(c*r)
        return torch.linspace(2.0, 6.0, shape[-1]).expand(shape).to(dt).clone()
    if (name.startswith("b") or name.endswith("_b")
            or name in ("w_a", "w_i", "dt_bias")):
        return torch.zeros(shape, dtype=dt)
    scale = 0.02
    if name in ("wo", "w_down", "out_proj", "w_out"):
        scale = 0.02 / max(1.0, (2 * cfg.n_layers) ** 0.5)
    return (torch.randn(shape, generator=generator) * scale).to(dt)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters of ``cfg`` by the reference's init rules.

    Drawn on the CPU from ``generator`` (default: seed 0), so one seed gives
    the same weights whatever ``device`` they are put on; ``device=None`` is
    the card (or raise).
    """
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dt = torch_dtype(cfg)
    params = {
        "tok_embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen)
                      * 0.02).to(dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab), generator=gen)
                             * 0.02).to(dt)
    groups = []
    for types, repeat in group_layers(cfg):
        groups.append([
            {name: _init_leaf((repeat,) + shape, name.split(".")[-1], cfg, gen)
             for name, shape in block_shapes(cfg, bt).items()}
            for bt in types
        ])
    params["groups"] = groups
    return tree_to(params, dev)


def param_specs(cfg: ModelConfig) -> dict:
    """Same tree as :func:`init_params`, leaves = logical-axis tuples."""
    specs = {"tok_embed": ("vocab", "embed"), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    specs["groups"] = [
        [{name: ("layers",) + axes
          for name, (_shape, axes) in _BLOCK_SHAPES[bt](cfg).items()}
         for bt in types]
        for types, _repeat in group_layers(cfg)
    ]
    return specs


def param_shapes(cfg: ModelConfig, device="meta") -> dict:
    """The tree of :func:`init_params` (keys, shapes and dtypes) with
    nothing drawn: uninitialized tensors on ``device``, by default the meta
    device, which allocates nothing.  The reference's
    ``jax.eval_shape(init_params)``, which the dry run traces with."""
    dt = torch_dtype(cfg)

    def empty(*shape):
        return torch.empty(shape, dtype=dt, device=device)

    params = {"tok_embed": empty(cfg.vocab, cfg.d_model),
              "final_norm": empty(cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = empty(cfg.d_model, cfg.vocab)
    params["groups"] = [
        [{name: empty(repeat, *shape) for name, shape in block_shapes(cfg, bt).items()}
         for bt in types]
        for types, repeat in group_layers(cfg)
    ]
    return params


def tree_to(tree, device):
    """``tree`` with every tensor moved to ``device`` (or cast: anything
    ``Tensor.to`` takes)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)
