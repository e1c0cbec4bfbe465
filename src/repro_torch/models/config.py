"""Model configuration (a host copy of ``repro.models.config``).

The reference's docstring follows; only ``param_count`` differs (no JAX).

Model configuration for the 10 assigned architectures + SNN-adjacent stubs.

One :class:`ModelConfig` drives the whole substrate: parameter init,
forward (train / prefill / decode), sharding specs, and the dry-run
input_specs.  Block types:

* ``attn``   — GQA attention (+RoPE/qk-norm/bias/local-window options)
* ``mamba2`` — Mamba-2 SSD block (attention-free)
* ``rglru``  — Griffin RG-LRU recurrent block (hybrid archs)

``block_pattern`` is cycled over ``n_layers`` (e.g. recurrentgemma's
1 attention per 2 recurrent blocks = ("rglru", "rglru", "attn")).
Homogeneous stacks are scanned (jax.lax.scan over stacked params);
hybrid stacks are grouped by pattern period.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden
    dispatch: str = "sort"        # "sort" (gather path) | "onehot" (dense path)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0                # 0 -> d_model
    d_conv: int = 4
    c: float = 8.0                # Griffin's fixed exponent scale


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_window: Optional[int] = None      # local attention window (hybrid)
    # mlp
    d_ff: int = 0
    act: str = "swiglu"                    # "swiglu" | "gelu"
    # blocks
    block_pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # modality frontend (STUB per spec: input_specs provides embeddings)
    frontend: str = "none"                 # "none" | "audio" | "vision"
    n_frontend_tokens: int = 0             # patches/frames occupying the seq front
    # numerics / scale
    dtype: str = "bfloat16"
    fsdp: bool = False                     # shard param "embed" dims over data
    remat: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # dry-run accounting: fully unroll layer scans so XLA cost_analysis sees
    # every layer (while-loop bodies are otherwise counted once; DESIGN.md §7)
    scan_unroll: bool = False
    # cross-entropy computed in sequence chunks of this size (0 = whole seq);
    # bounds the f32 logits temp to (B, chunk, vocab)
    loss_chunk: int = 0
    # --- §Perf hillclimb levers (baseline keeps the defaults) ---------------
    # attention scores/probs in f32 copies (baseline) vs bf16 operands with
    # f32 MXU accumulation (optimized: ~2x less attention HBM traffic)
    attn_f32: bool = True
    # explicit sharding constraints inside the MoE sort-dispatch (keeps the
    # (E*cap, d) dispatch buffers expert-sharded instead of replicated)
    moe_shard_constraints: bool = False
    # rms_norm statistics in f32 with an f32 upcast of x (baseline) vs
    # bf16-native with f32 accumulation (optimized: halves the f32
    # activation-gradient all-reduces XLA otherwise emits)
    norm_f32: bool = True
    # bf16 gradient barrier between layers: pins the residual cotangent
    # chain to bf16 so activation-grad all-reduces run at half width
    grad_bf16: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(1, self.n_heads)

    @property
    def attention_free(self) -> bool:
        return "attn" not in self.block_pattern

    @property
    def sub_quadratic(self) -> bool:
        """Whether long_500k decode is admissible (SSM / hybrid-local only)."""
        return self.attention_free or (
            self.attn_window is not None and "rglru" in self.block_pattern
        )

    def layer_types(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Total parameters (embeddings included), counted from the shape
        tables of :mod:`repro_torch.models.init` (the reference traces its
        ``init_params`` with ``jax.eval_shape``; the count is the same)."""
        from . import init as minit  # lazy; avoids cycle
        return minit.param_count(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        n = self.param_count()
        if self.moe is None:
            return n
        # subtract the inactive expert fraction of the expert weights
        expert_params = (
            self.n_layers * self.moe.n_experts * 3 * self.d_model * self.moe.d_ff
        )
        active = expert_params * self.moe.top_k / self.moe.n_experts
        return int(n - expert_params + active)
