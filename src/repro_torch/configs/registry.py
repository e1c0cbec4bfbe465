"""The 10 assigned architectures (exact public configs) + smoke variants.

A host copy of ``repro.configs.registry``: the same entries, field for
field (``tests/test_torch_ssd.py`` pins them).  The port runs all ten.

Every entry is selectable via ``--arch <id>`` in the launchers.  Sources per
the assignment sheet; `[source; tier]` documented inline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.config import ModelConfig, MoEConfig, RGLRUConfig, SSMConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# --- SSM -------------------------------------------------------------------
# mamba2-130m [arXiv:2405.21060]: 24L d768, attn-free, vocab 50280, state 128
register(ModelConfig(
    name="mamba2-130m", n_layers=24, d_model=768, vocab=50280,
    block_pattern=("mamba2",), d_ff=0,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
))

# --- audio (decoder over EnCodec tokens; frontend stubbed) -------------------
# musicgen-large [arXiv:2306.05284]: 48L d2048 32H kv32 ff8192 vocab 2048
register(ModelConfig(
    name="musicgen-large", n_layers=48, d_model=2048, vocab=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, act="gelu",
    frontend="audio",
))

# --- MoE ---------------------------------------------------------------------
# kimi-k2-1t-a32b [arXiv:2501.kimi2]: 61L d7168 64H kv8 moe 384e top-8 ff2048
register(ModelConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, vocab=163840,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=0,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, dispatch="sort"),
    fsdp=True,
))

# olmoe-1b-7b [arXiv:2409.02060]: 16L d2048 16H kv16 moe 64e top-8 ff1024
register(ModelConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, vocab=50304,
    n_heads=16, n_kv_heads=16, d_ff=0,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024, dispatch="sort"),
))

# --- dense -------------------------------------------------------------------
# phi3-medium-14b [arXiv:2404.14219]: 40L d5120 40H kv10 ff17920 vocab 100352
register(ModelConfig(
    name="phi3-medium-14b", n_layers=40, d_model=5120, vocab=100352,
    n_heads=40, n_kv_heads=10, d_ff=17920, fsdp=True,
))

# llama3.2-3b [hf:meta-llama/Llama-3.2]: 28L d3072 24H kv8 ff8192 vocab 128256
register(ModelConfig(
    name="llama3.2-3b", n_layers=28, d_model=3072, vocab=128256,
    n_heads=24, n_kv_heads=8, d_ff=8192, rope_theta=500000.0,
))

# qwen1.5-4b [hf:Qwen/Qwen1.5]: 40L d2560 20H kv20 ff6912 vocab 151936, QKV bias
register(ModelConfig(
    name="qwen1.5-4b", n_layers=40, d_model=2560, vocab=151936,
    n_heads=20, n_kv_heads=20, d_ff=6912, qkv_bias=True,
))

# qwen3-8b [hf:Qwen/Qwen3-8B]: 36L d4096 32H kv8 ff12288, qk_norm, d_head 128
register(ModelConfig(
    name="qwen3-8b", n_layers=36, d_model=4096, vocab=151936,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=12288, qk_norm=True,
    fsdp=True,
))

# --- hybrid ------------------------------------------------------------------
# recurrentgemma-2b [arXiv:2402.19427]: 26L d2560 10H kv1 ff7680 vocab 256000
# RG-LRU + local attention, 1 attn : 2 recurrent, window 2048
register(ModelConfig(
    name="recurrentgemma-2b", n_layers=26, d_model=2560, vocab=256000,
    n_heads=10, n_kv_heads=1, d_head=256, d_ff=7680,
    block_pattern=("rglru", "rglru", "attn"), attn_window=2048,
    rglru=RGLRUConfig(d_rnn=2560, d_conv=4),
))

# --- vlm (CLIP frontend stubbed; phi3-mini backbone) -------------------------
# phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct]:
# 32L d3072 32H kv32 ff8192 vocab 32064 + 576 patch tokens
register(ModelConfig(
    name="phi-3-vision-4.2b", n_layers=32, d_model=3072, vocab=32064,
    n_heads=32, n_kv_heads=32, d_ff=8192,
    frontend="vision", n_frontend_tokens=576,
))

ARCH_NAMES = tuple(_REGISTRY.keys())


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    return _REGISTRY[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers, small
    width, few experts, tiny vocab — structure preserved."""
    cfg = get_config(name)
    d_model = 64
    n_heads = max(2, min(4, cfg.n_heads)) if cfg.n_heads else 0
    n_kv = max(1, min(n_heads, cfg.n_kv_heads)) if cfg.n_kv_heads else 0
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2, 2 * len(cfg.block_pattern)),
        d_model=d_model,
        vocab=256,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        dtype="float32",
        fsdp=False,
        remat=False,
        attn_window=min(cfg.attn_window, 32) if cfg.attn_window else None,
        n_frontend_tokens=8 if cfg.frontend == "vision" else 0,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_ff=32
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk=16
        )
    if cfg.rglru is not None:
        changes["rglru"] = dataclasses.replace(cfg.rglru, d_rnn=d_model)
    return dataclasses.replace(cfg, **changes)
