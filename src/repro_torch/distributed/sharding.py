"""The SNN executor's placement primitives on CUDA cards.

What :meth:`~repro_torch.core.runtime.NetworkExecutable.shard` and the
placement engine (:mod:`repro_torch.placement.partition`) need, and
nothing else:

* :func:`placement_put` pins a tensor to one device by index — the
  primitive that realizes a placement's
  :class:`~repro_torch.placement.DeviceAssignment`.  With one device of
  the tensor's type visible it is the identity, so a one-card (or CPU)
  run drives the whole placement path with no data movement.
* :func:`snn_rules` is the logical-axis rules table of the SNN runtime.
* :func:`snn_mesh` is ``None`` on one card: the identity fallback.  A
  mesh over several cards is not ported yet (``ROADMAP.md`` §1 item 2,
  multi-card placement).
"""
from __future__ import annotations

import torch

#: Where the multi-card placement stands: the queue item that ports it.
MULTI_CARD_ITEM = (
    "multi-card shard(mesh=) and placement-driven put are not ported yet "
    "(ROADMAP.md §1 item 2: multi-card placement); the port runs on one "
    "card"
)


def visible_cards() -> int:
    """The number of visible CUDA cards; raises when there is none."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        raise RuntimeError(
            "no CUDA device is visible; pass n_devices= to plan a placement "
            "without a card"
        )
    return torch.cuda.device_count()


def placement_put(t: torch.Tensor, device_index: int) -> torch.Tensor:
    """Pin ``t`` to device ``device_index`` of its type.

    The identity when only one device of the tensor's type is visible
    (the same fallback contract as :func:`snn_mesh` returning ``None``);
    otherwise ``t.to(that device)``.
    """
    n = torch.cuda.device_count() if t.device.type == "cuda" else 1
    if n <= 1:
        return t
    if not 0 <= device_index < n:
        raise ValueError(f"device index {device_index} outside 0..{n - 1}")
    return t.to(torch.device(t.device.type, device_index))


def snn_rules() -> dict:
    """Logical-axis rules for the SNN runtime's fused executor.

    The SNN runtime names its dimensions after the paper's structures and
    maps them onto the standard 2-axis ``("data", "model")`` mesh:

        batch   -> "data"     # DP over requests (the micro-batch axis)
        neurons -> "model"    # TP of a layer's target population (the
                              # WDM's n_target rows — "subordinate PEs")
        rows    -> "model"    # serial synaptic rows split like the paper
                              # splits dense matrices across adjacent PEs
        steps   -> None       # the loop axis is never sharded
        cols    -> None       # WDM stacked-input columns stay whole so the
                              # ring gather needs no collective
    """
    return {
        "batch": ("data",),
        "neurons": ("model",),
        "rows": ("model",),
        "steps": (),
        "cols": (),
        None: (),
    }


def snn_mesh():
    """``None`` when one card (or none) is visible: the identity fallback.

    More visible cards raise :class:`NotImplementedError`.
    """
    if not torch.cuda.is_available() or torch.cuda.device_count() <= 1:
        return None
    raise NotImplementedError(MULTI_CARD_ITEM)
