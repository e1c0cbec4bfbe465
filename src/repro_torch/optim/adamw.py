"""AdamW with decoupled weight decay, cosine schedule, global-norm clip
(the port of ``repro.optim.adamw``).

Functions on trees of tensors, under ``torch.no_grad()``, with the
reference's rounding: the moments in f32 whatever the parameter's dtype;
the clip ``min(1, clip / (gnorm + 1e-9))`` scales ``g`` before the
moments; the bias corrections ``1 - b**step`` in f32; ``delta = mh /
(sqrt(vh) + eps) + wd * p`` and ``p - lr * delta`` in f32, cast to the
leaf's dtype.  ``torch.optim.AdamW`` is not this function: it decays
``p`` in a separate step, adds ``eps`` after ``sqrt(v) / sqrt(b2c)`` and
has no global-norm clip.  The step counter and the schedule are tensors
on the parameters' device, so a step reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..tree import leaves, tree_map, unflatten_like

f32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_state(params) -> AdamWState:
    """Step 0 (int32, on the first leaf's device) and zero f32 moments."""
    device = leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=f32, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; an f32 tensor
    on ``step``'s device (a Python int is a CPU step)."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, in leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(f32)))
                          for leaf in leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig) -> tuple:
    """Returns (new_params, new_state, metrics); the inputs are not changed."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    b1c = 1 - torch.pow(cfg.b1, step.to(f32))
    b2c = 1 - torch.pow(cfg.b2, step.to(f32))

    def upd(p, g, m, v):
        g = g.to(f32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_new / b1c
        vh = v_new / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(f32)
        p_new = (p.to(f32) - lr * delta).to(p.dtype)
        return p_new, m_new, v_new

    out = [upd(*ls) for ls in zip(leaves(params), leaves(grads),
                                   leaves(state.m), leaves(state.v))]
    new_p, new_m, new_v = ([o[i] for o in out] for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (unflatten_like(params, new_p),
            AdamWState(step=step, m=unflatten_like(params, new_m),
                       v=unflatten_like(params, new_v)),
            metrics)
