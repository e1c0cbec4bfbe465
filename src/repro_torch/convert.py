"""Carry lowered weights across from the reference package.

The reference executable keeps one operand tuple per projection, in the
layout of its ``_layer_params``: ``(row_weight, row_delay, row_src,
row_tgt)`` for a serial projection, ``(wdm_stack, col_source, col_delay)``
for a parallel one.  Handed over as NumPy arrays::

    ops = [tuple(np.asarray(a) for a in p) for p in jax_exe.params]

:func:`executable_from_operands` builds the port's
:class:`~repro_torch.core.runtime.executor.NetworkExecutable` on exactly
those operands, with the graph plan taken from the port's own copy of the
network.  Both packages then run literally the same lowered weights.

:func:`lm_params_from_numpy` does the same for a language model's
parameter tree (``jax.tree.map(np.asarray, params)``).  This module imports
nothing of the reference; it only reads arrays.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .core.layer import SNNNetwork
from .core.runtime.executor import NetworkExecutable, _graph_plan, _layer_meta
from .core.switching import CompileReport
from .device import resolve_device

_DTYPES = {
    "serial": (np.float32, np.int32, np.int32, np.int32),
    "parallel": (np.int8, np.int32, np.int32),
}


def _check_ranges(i: int, paradigm: str, arrays, layer) -> None:
    """Refuse operands whose indices the kernels would read out of bounds
    (the gather kernel does not check them on the card)."""
    if paradigm == "serial":
        weight, delay, src, tgt = arrays
        if not weight.size == delay.size == src.size == tgt.size:
            raise ValueError(f"projection {i}: row arrays differ in length")
        limits = {"row_delay": (delay, 1, layer.delay_range),
                  "row_src": (src, 0, layer.n_source - 1),
                  "row_tgt": (tgt, 0, layer.n_target - 1)}
    else:
        wdm, src, delay = arrays
        if wdm.shape != (layer.n_target, src.size) or delay.size != src.size:
            raise ValueError(f"projection {i}: WDM {wdm.shape} does not "
                             f"match {layer.n_target} targets x {src.size} columns")
        limits = {"col_source": (src, 0, layer.n_source - 1),
                  "col_delay": (delay, 1, max(1, layer.delay_range))}
    for name, (a, lo, hi) in limits.items():
        if a.size and (a.min() < lo or a.max() > hi):
            raise ValueError(f"projection {i}: {name} outside [{lo}, {hi}]")


def executable_from_operands(
    net: SNNNetwork,
    operands: Sequence[Tuple[np.ndarray, ...]],
    *,
    report: CompileReport | None = None,
    device=None,
) -> NetworkExecutable:
    """The port's executable for ``net`` on the given per-projection operands.

    A 4-tuple is a serial projection, a 3-tuple a parallel one.  ``report``
    (optional) only receives the launches' ``serial_forms`` record.
    """
    if len(operands) != len(net.layers):
        raise ValueError(
            f"{len(operands)} operand tuples for {len(net.layers)} projections"
        )
    dev = resolve_device(device)
    plan = _graph_plan(net)
    metas, params = [], []
    for i, (layer, ops) in enumerate(zip(net.layers, operands)):
        paradigm = {4: "serial", 3: "parallel"}.get(len(ops))
        if paradigm is None:
            raise ValueError(f"projection {i}: {len(ops)} operands")
        # np.array copies: the reference hands over read-only buffers
        arrays = [np.array(a, dt) for a, dt in zip(ops, _DTYPES[paradigm])]
        _check_ranges(i, paradigm, arrays, layer)
        params.append(tuple(torch.as_tensor(a, device=dev) for a in arrays))
        metas.append(_layer_meta(plan, i, layer, params[-1]))
    return NetworkExecutable(
        tuple(metas), params, name=getattr(net, "name", "snn"),
        plan=plan, report=report, device=dev,
    )


def _tensor(a, device) -> torch.Tensor:
    """One NumPy leaf as a tensor; bfloat16 (NumPy's extension dtype, which
    torch cannot read) goes over through its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def lm_params_from_numpy(tree, *, device=None):
    """The reference's language-model parameter tree, with NumPy leaves, as
    the port's: the same ``groups[g][t][name]`` layout, leading stacked
    ``layers`` axis and dtypes, as tensors on ``device`` (default: the card,
    or raise)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _tensor(node, dev)

    return walk(tree)


__all__ = ["executable_from_operands", "lm_params_from_numpy"]
