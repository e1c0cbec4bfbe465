"""Parallel-paradigm executor — the MAC-array path (paper §III-B), torch port.

Per timestep:

1. **Dominant PE** — maintains the input-spike ring (last ``delay_range``
   spike vectors) and assembles the *stacked input buffer* through the
   input merging table: column c of the buffer is
   ``x[t - delay(c)][source(c)]``, read via the *reversed order* ring
   indices.  The port keeps the ring batch-major, ``(B, depth, n_source)``
   int8, so the read is one ``index_select`` of columns on the
   ``(B, depth * n_source)`` view and lands directly in the ``(B, C)``
   layout the matmul kernel reads (no transpose is ever materialised).
2. **Subordinate PEs** — one int8 x int8 -> int32 matmul of the optimized
   weight-delay-map with the stacked input: the CUDA kernel
   :func:`repro_torch.kernels.spike_wdm_matmul`.
3. Fused LIF update (:func:`repro_torch.kernels.lif_update`).

Bit-identical to the dense oracle: every accumulation is an exact int32.

The ring depth is clamped to ``max(1, delay_range)`` so the degenerate
``delay_range == 0`` program (an empty layer) executes instead of dividing
by zero in the ring index arithmetic.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import resolve_device
from ...kernels.lif_update import lif_update
from ...kernels.spike_wdm_matmul import spike_wdm_matmul
from ..layer import LIFParams, SNNLayer
from ..parallel_compiler import OptFlags, ParallelProgram, compile_parallel
from .reference import LIFState, init_state

#: Total ``lower_parallel`` invocations (executable caching keeps this at
#: one per layer per report and device).
LOWER_COUNT = 0


@dataclasses.dataclass
class ParallelExecutable:
    n_source: int
    n_target: int
    delay_range: int
    wdm_stack: torch.Tensor    # (n_target, C) int8 — slices concatenated
    col_source: torch.Tensor   # (C,) i32 input-merging-table: column -> source
    col_delay: torch.Tensor    # (C,) i32 reversed-order: column -> delay
    lif: LIFParams

    @property
    def ring_depth(self) -> int:
        """Spike-history ring depth; >= 1 even for degenerate programs."""
        return max(1, self.delay_range)

    @property
    def device(self) -> torch.device:
        return self.wdm_stack.device


def lower_parallel(
    program: ParallelProgram, lif: LIFParams | None = None, *, device=None
) -> ParallelExecutable:
    """Concatenate the optimized WDM slices into one (T x C) int8 operand."""
    global LOWER_COUNT
    LOWER_COUNT += 1
    dev = resolve_device(device)
    mats, srcs, dls = [], [], []
    for sl in program.slices:
        n_cols = len(sl.col_sources)
        if n_cols == 0:
            continue
        mats.append(sl.matrix[: program.n_target, :n_cols])
        srcs.append(sl.col_sources)
        dls.append(np.full(n_cols, sl.delay, dtype=np.int64))
    if mats:
        wdm = np.concatenate(mats, axis=1).astype(np.int8)
        col_source = np.concatenate(srcs)
        col_delay = np.concatenate(dls)
    else:
        wdm = np.zeros((program.n_target, 0), np.int8)
        col_source = np.zeros(0, np.int64)
        col_delay = np.zeros(0, np.int64)
    return ParallelExecutable(
        n_source=program.n_source,
        n_target=program.n_target,
        delay_range=program.delay_range,
        wdm_stack=torch.as_tensor(np.ascontiguousarray(wdm), device=dev),
        col_source=torch.as_tensor(col_source.astype(np.int32), device=dev),
        col_delay=torch.as_tensor(col_delay.astype(np.int32), device=dev),
        lif=lif or LIFParams(),
    )


def init_history(
    batch: int, depth: int, n_source: int, *, device
) -> torch.Tensor:
    """A zero ``(B, depth, n_source)`` int8 spike-history ring."""
    return torch.zeros((batch, depth, n_source), dtype=torch.int8, device=device)


def parallel_project(
    wdm_stack, col_source, col_delay,
    x_hist: torch.Tensor,     # (B, max(1, D), S) int8 spike history ring
    x_t: torch.Tensor,        # (B, S) f32 spikes at t
    t: int,
):
    """Dominant-PE + MAC half of ONE projection.

    Returns ``(x_hist, i_t)`` — the spike-history ring with ``x_t`` written
    in (in place) and the ``(B, n_target)`` f32 input current the target
    population consumes at ``t``.
    """
    # the allocated ring IS the truth for the depth (clamped >= 1 at
    # allocation via ring_depth), so the index arithmetic cannot drift
    batch, d, n_source = x_hist.shape
    # dominant PE: stacked input via merging table + reversed order; one
    # column gather on the (B, depth * n_source) ring view.  torch's % on
    # integer tensors is a floor-mod, like the reference's jnp %.
    slot = (t - col_delay.long()) % d                             # (C,)
    stacked = x_hist.view(batch, d * n_source).index_select(
        1, slot * n_source + col_source
    )                                        # (B, C) int8, a fresh copy
    i_t = spike_wdm_matmul(wdm_stack, stacked).to(torch.float32)  # (B, T)
    # write x_t into the history ring AFTER the read (delays are >= 1); the
    # gather above copied its columns, so the write cannot reach them
    x_hist[:, t % d] = x_t.to(torch.int8)
    return x_hist, i_t


def parallel_step(
    wdm_stack, col_source, col_delay,
    x_hist: torch.Tensor,     # (B, max(1, D), S) int8 spike history ring
    state: LIFState,          # .ring unused here (kept for API parity)
    x_t: torch.Tensor,        # (B, S) f32 spikes at t
    t: int,
    *,
    alpha: float,
    v_th: float,
):
    x_hist, i_t = parallel_project(
        wdm_stack, col_source, col_delay, x_hist, x_t, t
    )
    v_new, z_new = lif_update(i_t, state.v, state.z, alpha=alpha, v_th=v_th)
    new_state = LIFState(v=v_new, z=z_new, ring=state.ring)
    return x_hist, new_state, z_new


def run_parallel(
    layer: SNNLayer,
    spikes: np.ndarray,       # (T, B, S) 0/1
    lif: LIFParams | None = None,
    program: ParallelProgram | None = None,
    opts: OptFlags = OptFlags(),
    *,
    device=None,
) -> np.ndarray:
    """One projection through the WDM matmul; returns (T, B, n_target)."""
    program = program or compile_parallel(layer, opts=opts)
    exe = lower_parallel(program, lif or layer.lif, device=device)
    dev = exe.device
    x = torch.as_tensor(np.asarray(spikes, np.float32), device=dev)
    T, B, _ = x.shape
    state = init_state(B, exe.n_target, 0, device=dev)
    x_hist = init_history(B, exe.ring_depth, exe.n_source, device=dev)
    zs = torch.empty((T, B, exe.n_target), dtype=torch.float32, device=dev)
    for t in range(T):
        x_hist, state, zs[t] = parallel_step(
            exe.wdm_stack, exe.col_source, exe.col_delay,
            x_hist, state, x[t], t,
            alpha=exe.lif.alpha, v_th=exe.lif.v_th,
        )
    return zs.cpu().numpy()
