"""Plain PyTorch versions of the fused LIF neural-update step (Eq. 1) and of
the population step built around it."""
from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch


def lif_update_ref(
    i_t: torch.Tensor,    # f32 input current, any shape
    v: torch.Tensor,      # f32 membrane potential, same shape
    z: torch.Tensor,      # f32 previous spikes (0/1), same shape
    *,
    alpha: float,
    v_th: float,
):
    """``v' = i + alpha*v - z*v_th``; ``z' = [v' >= v_th]``.

    Each operation is one separately rounded f32 op with the scalars
    rounded to f32 once, as in the reference's elementwise expression."""
    v_new = i_t + alpha * v - z * v_th
    z_new = (v_new >= v_th).to(torch.float32)
    return v_new, z_new


class CurrentEdge(NamedTuple):
    """An in-edge that hands the population its ``(B, N)`` f32 current (a
    parallel projection's output), read through its strides."""

    i: torch.Tensor


class RingEdge(NamedTuple):
    """An in-edge with a delay ring (a serial projection): ``upd`` is its
    ``(d_slots, B, N)`` f32 update (any strides), which lands ``shift``
    slots on in the contiguous ``(d_slots, B, N)`` f32 ``ring``; the ring
    is updated in place and its slot ``t mod d_slots`` is the current."""

    ring: torch.Tensor
    upd: torch.Tensor
    shift: int


Edge = Union[CurrentEdge, RingEdge]


def ring_deliver_ref(
    ring: torch.Tensor, upd: torch.Tensor, shift: int, t: int
) -> torch.Tensor:
    """``ring += roll(upd, shift)`` over the slot axis, then copy out slot
    ``t mod d_slots`` and zero it in place; returns the copied current.

    ``roll`` by ``shift`` lands ``upd[d]`` in slot ``(d + shift) mod
    d_slots`` (a floor-mod, as Python's ``%``)."""
    d_slots = ring.shape[0]
    shift %= d_slots
    ring += torch.roll(upd, shift, 0) if shift else upd
    slot = t % d_slots
    i_t = ring[slot].clone()
    ring[slot] = 0.0
    return i_t


def lif_step_ref(
    edges: Sequence[Edge],
    v: torch.Tensor,      # (B, N) f32 membrane carry, updated in place
    z: torch.Tensor,      # (B, N) int8 spike carry, updated in place
    out: torch.Tensor,    # (B, N) f32 spike row the step writes
    t: int,
    *,
    alpha: float,
    v_th: float,
) -> torch.Tensor:
    """One population's step: deliver each in-edge's current (in order),
    sum them, fire, and write the carry and the spike row in place.

    Op for op the executor's route before the fused kernel: each ring edge
    through :func:`ring_deliver_ref`, the currents summed left to right,
    the int8 spikes cast to f32, :func:`lif_update_ref`, the new spikes
    cast back to int8.  A population with no in-edge gets a zero current.
    Returns ``out``."""
    i = None
    for e in edges:
        i_e = (ring_deliver_ref(e.ring, e.upd, e.shift, t)
               if isinstance(e, RingEdge) else e.i)
        i = i_e if i is None else i + i_e
    if i is None:
        i = torch.zeros_like(v)
    v_new, z_new = lif_update_ref(i, v, z.to(torch.float32),
                                  alpha=alpha, v_th=v_th)
    v.copy_(v_new)
    z.copy_(z_new)             # the 0/1 spikes cast to int8, exactly
    out.copy_(z_new)
    return out
