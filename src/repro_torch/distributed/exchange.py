"""The exact collectives the port's SPMD paths run between ranks.

The reference runs one controller over all devices: GSPMD inserts the
collectives a sharded operand needs, and a value placed on one device is
read on another without being asked for.  The port runs one process a
card over ``torch.distributed``, so it says what moves, and this module
holds all of it:

* :func:`all_gather_cat` completes a slab: every rank of ``group`` holds
  one block of a result along ``dim`` (a row slab of a current, a batch
  slice of a train), and each gets the whole;
* :func:`all_reduce` sums (or maxes) over ``group``: a serial edge's
  update from a slab of its synaptic rows, a fixed point's pass counts;
* :func:`send` and :func:`recv` move one spike row (or train) from the
  rank that computed it to the rank that needs it: a placement's halo;
* :func:`broadcast` gives every rank one rank's tensor;
* :func:`ring_shift` sends to the next rank of a ring and receives from
  the previous one (the int8 ring all-reduce).

A group of one rank runs no collective: each function is then the
identity, and counts nothing.  NCCL carries CUDA tensors; the other
backends (gloo) do not carry them for every operation, so where the
group's backend is not NCCL and a tensor is on the card, the exchange
copies it through a host buffer.  That choice is read from
``dist.get_backend(group)``; :func:`transport` names it.

Every collective counts its calls and elements in :data:`COUNTS`, read
with :func:`exchange_counts` as ``kernels.launch_counts()`` reads the
kernels'.  The elements are those that reach this rank: the whole result
of a gather, the reduced tensor, the payload sent or received.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

#: op -> [calls, elements] since the last reset
COUNTS: Dict[str, List[int]] = {
    op: [0, 0] for op in
    ("all_gather", "all_reduce", "send", "recv", "broadcast", "ring_shift")
}


def exchange_counts() -> dict:
    """``{op: {"calls": n, "elements": n}}`` since the last reset."""
    return {op: {"calls": c, "elements": e} for op, (c, e) in COUNTS.items()}


def reset_exchange_counts() -> None:
    for v in COUNTS.values():
        v[0] = v[1] = 0


def _count(op: str, elements: int) -> None:
    COUNTS[op][0] += 1
    COUNTS[op][1] += int(elements)


def group_size(group=None) -> int:
    """Ranks in ``group`` (the world when None); 1 with no process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) != "nccl"


def transport(group=None, device="cuda") -> str:
    """The backend that carries a tensor on ``device`` over ``group``, and
    whether it goes through a host buffer."""
    backend = dist.get_backend(group)
    staged = torch.device(device).type == "cuda" and backend != "nccl"
    return f"{backend}, host-staged" if staged else backend


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the backend carries it: contiguous, on the host if staged."""
    return t.cpu() if _staged(t, group) else t.contiguous()


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in the
    group's rank order."""
    n = group_size(group)
    if n == 1:
        return t
    w = _wire(t, group)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    _count("all_gather", w.numel() * n)
    return torch.cat(parts, dim).to(t.device)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` (a new tensor on ``t``'s device)."""
    if group_size(group) == 1:
        return t
    w = _wire(t, group)
    if w is t:
        w = t.clone()
    dist.all_reduce(w, op=op, group=group)
    _count("all_reduce", w.numel())
    return w.to(t.device)


def send(t: torch.Tensor, dst: int) -> None:
    """``t`` to global rank ``dst`` (blocks until it is handed over)."""
    dist.send(_wire(t, None), dst)
    _count("send", t.numel())


def recv(out: torch.Tensor, src: int) -> torch.Tensor:
    """Receive from global rank ``src`` into the contiguous ``out``;
    returns ``out``."""
    if _staged(out, None):
        w = torch.empty(out.shape, dtype=out.dtype)
        dist.recv(w, src)
        out.copy_(w)
    else:
        dist.recv(out, src)
    _count("recv", out.numel())
    return out


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Global rank ``src``'s ``t`` on every rank of ``group``, written into
    ``t`` (which must have the shape and dtype on every rank)."""
    if group_size(group) == 1:
        return t
    w = _wire(t, group)
    dist.broadcast(w, src, group=group)
    if w is not t:
        t.copy_(w)
    _count("broadcast", t.numel())
    return t


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """Send ``t`` to the next rank of ``group``'s ring, return what the
    previous rank sent (group rank ``i`` sends to ``(i + 1) % n``)."""
    n = group_size(group)
    if n == 1:
        return t
    group = dist.group.WORLD if group is None else group
    me = dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    w = _wire(t, group)
    got = torch.empty_like(w)
    if w.device.type == "meta":
        # the dry run's trace on a fake world, which batches no meta ops
        reqs = [dist.isend(w, nxt, group=group), dist.irecv(got, prv, group=group)]
    else:
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, w, nxt, group=group),
                                       dist.P2POp(dist.irecv, got, prv, group=group)])
    for req in reqs:
        req.wait()
    _count("ring_shift", got.numel())
    return got.to(t.device)


__all__ = [
    "COUNTS", "all_gather_cat", "all_reduce", "broadcast", "exchange_counts",
    "group_size", "recv", "reset_exchange_counts", "ring_shift", "send",
    "transport",
]
