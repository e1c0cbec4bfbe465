"""Traffic: a traffic file's parameters and a seed in, a fixed schedule of
requests and their spike payloads out.

The traffic file names its generator, ``traffic/<generator>.py``, found
by that name: a new arrival process is a new file.  A generator gives
``LOOP`` (``"open"``: arrivals on a schedule; ``"closed"``: clients that
send their next request on their reply), ``count(traffic, seconds)``,
the requests a run makes, and ``arrivals(traffic, n, permute)``, when
each is due and whose it is.  What every mix shares is drawn here.

Every seed gets the same multiset of sizes, widths, tenants, classes and
inter-arrival gaps, in another order: the seed permutes them and draws
the spikes.  So two seeds offer the same work in another arrangement,
and a run's numbers move with the arrangement alone.

Parameters every traffic file has:

* ``generator``: the arrival process (its own parameters beside these);
* ``steps``: ``[lo, hi]``, request lengths spread evenly over the range;
* ``widths``: shares of the model's input a request carries (the rest of
  the input is silent), spread evenly; default ``[1.0]``;
* ``input_rate``: spike probability a step of every input column, or
  ``"config"``: each input population at its configuration's ``rate``;
* ``tenants``: model name -> share; ``classes``: ``[{"share",
  "priority", "deadline_ms"}]``;
* ``engine``: the serving engine's settings; ``check``: which replies the
  run compares (``every``: each client's every n-th, ``max``: at most).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List

import numpy as np
import torch

from snnbench.graph import input_slices, n_input
from snnbench.lookup import load_module

BASE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Schedule:
    steps: np.ndarray          # (n,) true steps a request
    width: np.ndarray          # (n,) input columns it carries
    tenant: List[str]          # (n,) model it goes to
    priority: np.ndarray       # (n,)
    deadline_ms: List          # (n,) float or None
    due_s: np.ndarray          # (n,) open loop: when it is due, from the start
    client: np.ndarray         # (n,) closed loop: whose it is (-1: open loop)
    rows: np.ndarray           # (n + 1,) its first payload row (packed rows)
    packed: np.ndarray         # (rows, ceil(n_input / 8)) uint8, bit-packed
    n_input: int
    loop: str                  # "open" | "closed"

    def __len__(self) -> int:
        return len(self.steps)

    def payload(self, i: int) -> np.ndarray:
        """Request ``i``'s ``(steps, width)`` 0/1 uint8 spikes."""
        bits = np.unpackbits(self.packed[self.rows[i]:self.rows[i + 1]], axis=1,
                             count=self.n_input)
        return bits[:, : self.width[i]]


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, stream])


def permutation(seed: int):
    """``permute(stream, values)``: ``values`` in the seed's order for
    ``stream`` (each stream its own draw)."""
    return lambda k, a: np.asarray(a)[_rng(seed, k).permutation(len(a))]


def generator(traffic: dict, base: Path = BASE):
    """The traffic file's arrival process, ``traffic/<generator>.py``."""
    return load_module(base / "traffic" / f"{traffic['generator']}.py", "traffic")


def _spread(n: int, values) -> np.ndarray:
    """``n`` values spread evenly over ``values`` (in order), unshuffled."""
    values = list(values)
    return np.array([values[(k * len(values)) // n] for k in range(n)])


def _shares(n: int, shares: dict) -> list:
    """``n`` labels in the given shares, the k-th by where (k + 0.5) / n
    falls in the shares' running sum."""
    names, cum = list(shares), np.cumsum(list(shares.values()))
    cum = cum / cum[-1]
    return [names[int(np.searchsorted(cum, (k + 0.5) / n))] for k in range(n)]


def column_rates(traffic: dict, cfg: dict, graph: dict) -> np.ndarray:
    rate = traffic["input_rate"]
    width = n_input(graph)
    if rate != "config":
        return np.full(width, float(rate), np.float32)
    by_name = {p["name"]: p["rate"] for p in cfg["recipe"]["populations"]}
    out = np.zeros(width, np.float32)
    for k, (a, b) in input_slices(graph):
        out[a:b] = by_name[graph["populations"][k]["name"]]
    return out


def make(traffic: dict, cfg: dict, graph: dict, seed: int, seconds: float,
         device, base: Path = BASE) -> Schedule:
    gen = generator(traffic, base)
    n = gen.count(traffic, seconds)
    width = n_input(graph)
    lo, hi = traffic["steps"]
    perm = permutation(seed)
    steps = perm(1, _spread(n, range(lo, hi + 1))).astype(np.int64)
    shares = traffic.get("widths", [1.0])
    widths = perm(2, _spread(n, [max(1, int(round(s * width))) for s in shares]))
    tenant = list(perm(3, _shares(n, traffic["tenants"])))
    classes = traffic["classes"]
    cls = perm(4, _shares(n, {k: c["share"] for k, c in enumerate(classes)}))
    priority = np.array([classes[c]["priority"] for c in cls], np.int64)
    deadline = [classes[c]["deadline_ms"] for c in cls]
    due, client = gen.arrivals(traffic, n, perm)
    rows = np.zeros(n + 1, np.int64)
    np.cumsum(steps, out=rows[1:])
    packed = spikes(int(rows[-1]), column_rates(traffic, cfg, graph), seed, device)
    return Schedule(steps, widths.astype(np.int64), tenant, priority, deadline,
                    np.asarray(due, np.float64), np.asarray(client), rows, packed,
                    width, gen.LOOP)


def spikes(n_rows: int, rates: np.ndarray, seed: int, device) -> np.ndarray:
    """``n_rows`` rows of Bernoulli(rates) spikes, bit-packed on the host;
    drawn on ``device`` from the seed in a few large calls."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**63)
    width = len(rates)
    padded = -(-width // 8) * 8
    p = torch.zeros(padded, device=dev)
    p[:width] = torch.as_tensor(rates, device=dev)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=dev,
                           dtype=torch.int32)
    out = np.empty((n_rows, padded // 8), np.uint8)
    chunk = max(1, (1 << 27) // padded)
    for r0 in range(0, n_rows, chunk):
        r1 = min(n_rows, r0 + chunk)
        bits = torch.rand((r1 - r0, padded), generator=gen, device=dev) < p
        packed = (bits.view(r1 - r0, padded // 8, 8).to(torch.int32)
                  * weights).sum(-1).to(torch.uint8)
        out[r0:r1] = packed.cpu().numpy()
    return out
