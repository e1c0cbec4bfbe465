"""Assigned input shapes and per-(arch x shape) input specs (the port of
``repro.launch.shapes``).

LM transformer shapes (seq_len x global_batch):

* train_4k     — 4,096 x 256   (training;   traces train_step)
* prefill_32k  — 32,768 x 32   (inference;  traces prefill_step)
* decode_32k   — 32,768 x 128  (inference;  traces serve_step: ONE new token
                                against a seq_len KV cache)
* long_500k    — 524,288 x 1   (long-context decode; sub-quadratic archs only)

``SHAPES``, ``Cell``, ``shape_applicable`` and ``tokens_per_step`` are
the reference's.  ``batch_specs`` and ``cache_specs`` return tensors on
the meta device (shapes and dtypes, no storage) where the reference
returns ``jax.ShapeDtypeStruct``s: zero allocation either way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..models.init import torch_dtype

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str

    @property
    def kind(self) -> str:
        return SHAPES[self.shape]["kind"]


def shape_applicable(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if runnable; else the skip reason (recorded in EXPERIMENTS.md)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return (
            "pure full-attention arch: 524k-token decode KV cache is the "
            "quadratic-family artifact this shape excludes (DESIGN.md §5)"
        )
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def step_batch_specs(cfg: ModelConfig, kind: str, b: int,
                     s: int) -> Dict[str, torch.Tensor]:
    """The batch of one ``kind`` step over ``b`` sequences of ``s``
    positions, on the meta device (:func:`batch_specs` at any size)."""
    if kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32)}
    if cfg.frontend == "audio":
        return {
            "embeds": _meta((b, s, cfg.d_model), torch_dtype(cfg)),
            "labels": _meta((b, s), torch.int32),
        }
    specs = {"tokens": _meta((b, s - cfg.n_frontend_tokens), torch.int32)}
    if cfg.frontend == "vision":
        specs["patch_embeds"] = _meta(
            (b, cfg.n_frontend_tokens, cfg.d_model), torch_dtype(cfg)
        )
        specs["labels"] = _meta((b, s), torch.int32)
    return specs


def batch_specs(cfg: ModelConfig, shape: str) -> Dict[str, torch.Tensor]:
    info = SHAPES[shape]
    return step_batch_specs(cfg, info["kind"], info["global_batch"],
                            info["seq_len"])


def cache_specs(cfg: ModelConfig, shape: str):
    info = SHAPES[shape]
    s, b = info["seq_len"], info["global_batch"]
    return M.init_caches(cfg, b, s, device="meta")


def tokens_per_step(cfg: ModelConfig, shape: str) -> int:
    info = SHAPES[shape]
    if info["kind"] == "decode":
        return info["global_batch"]          # one new token per sequence
    return info["global_batch"] * info["seq_len"]
