"""Deterministic synthetic token pipeline, host-sharded.

A production run swaps ``SyntheticLM`` for a file-backed source; everything
downstream (host sharding, epoch bookkeeping, checkpointable cursor) is the
real pipeline.  Sequences are generated from a seeded Markov-ish mixture so
the loss actually decreases during the train example (unlike uniform noise).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Seeded synthetic corpus with learnable bigram structure."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # sparse-ish bigram transition table: each token strongly predicts
        # a handful of successors (so CE can fall well below ln(vocab))
        k = 4
        self._succ = rng.integers(0, cfg.vocab, size=(cfg.vocab, k))
        self._step = 0

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.cfg.n_hosts

    def state_dict(self) -> dict:
        return {"step": self._step}

    def load_state_dict(self, state: dict) -> None:
        self._step = int(state["step"])

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a given step (restart-safe)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id)
        )
        b, s = self.local_batch, cfg.seq_len
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, b)
        choices = rng.integers(0, self._succ.shape[1], (b, s))
        noise = rng.random((b, s)) < 0.1
        rand_tok = rng.integers(0, cfg.vocab, (b, s))
        for t in range(1, s):
            nxt = self._succ[toks[:, t - 1], choices[:, t]]
            toks[:, t] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.batch_at(self._step)
            self._step += 1
