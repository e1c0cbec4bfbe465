"""Step functions (train / prefill / serve): the port of
``repro.launch.steps``.

``make_train_step`` is the reference's: the loss and its gradients
(:func:`repro_torch.models.model.value_and_grad`), then one AdamW update,
all on the parameters' device.  The sharding trees and the compressed
cross-pod step place a model over a mesh of cards; they raise
:class:`NotImplementedError` until the language models' half of
multi-card placement is ported
(:data:`repro_torch.distributed.MULTI_CARD_ITEM`).
"""
from __future__ import annotations

from ..distributed.sharding import MULTI_CARD_ITEM
from ..models import model as M
from ..models.config import ModelConfig
from ..models.init import group_layers
from ..optim import AdamWConfig, apply_updates


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    def train_step(params, opt_state, batch):
        loss, grads = M.value_and_grad(params, cfg, batch)
        params, opt_state, metrics = apply_updates(params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, cache_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig, cache_len: int):
    def serve_step(params, caches, tokens, pos):
        return M.decode_step(params, cfg, tokens, pos, caches, cache_len)

    return serve_step


def make_opt_cfg(**kw) -> AdamWConfig:
    return AdamWConfig(**kw)


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------

def cache_logical_specs(cfg: ModelConfig):
    """Logical axes mirroring models.model.init_caches structure."""
    groups = []
    for types, _repeat in group_layers(cfg):
        per_type = []
        for bt in types:
            if bt == "attn":
                per_type.append({
                    "k": ("layers", "batch", "kv_seq", "heads", None),
                    "v": ("layers", "batch", "kv_seq", "heads", None),
                })
            elif bt == "mamba2":
                per_type.append({
                    "conv": ("layers", "batch", "heads", None),
                    "ssd": ("layers", "batch", "heads", None, None),
                })
            elif bt == "rglru":
                per_type.append({
                    "conv": ("layers", "batch", "heads", None),
                    "h": ("layers", "batch", "heads"),
                })
        groups.append(per_type)
    return groups


def _multi_card(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"launch.steps.{name}: {MULTI_CARD_ITEM}")

    refuse.__name__ = refuse.__qualname__ = name
    refuse.__doc__ = f"The reference's ``{name}`` (a mesh of cards): not ported yet."
    return refuse


param_shardings = _multi_card("param_shardings")
opt_shardings = _multi_card("opt_shardings")
batch_shardings = _multi_card("batch_shardings")
cache_shardings = _multi_card("cache_shardings")
make_train_step_compressed = _multi_card("make_train_step_compressed")
