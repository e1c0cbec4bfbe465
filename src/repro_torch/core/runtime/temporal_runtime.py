"""Temporal-parallel LIF runtime: all T timesteps of a layer at once.

Every other launch path pays one loop iteration per timestep.  This module
removes that loop for feed-forward segments of the graph plan: a
population's whole input train is projected in one batched contraction and
the membrane trajectory is resolved by a whole-train affine scan
(:mod:`repro_torch.kernels.lif_parallel_scan`, K4).

The only obstruction is the spike reset ``- z[t-1]*v_th``, which couples
consecutive steps.  Three resolution modes, picked per population by
:func:`choose_temporal_mode`:

``alpha0`` (exact, alpha == 0)
    With no membrane carry-over each step is one of two precomputable
    bits: ``A[t] = [i[t] >= v_th]`` (previous step silent) or ``B[t] =
    [i[t] - v_th >= v_th]`` (previous step fired).  The step map ``z[t-1]
    -> z[t]`` encoded as the pair ``(f(0), f(1))`` composes associatively
    and exactly in f32 0/1 arithmetic, so a log-step doubling scan
    resolves the whole spike train; any composition order is exact.

``count`` (exact, alpha == 1, non-negative weights, integer v_th >= 1)
    Perfect integration with subtractive reset is a counting process:
    with ``U[t] = cumsum(i)`` the cumulative spike count is ``N[t] = t +
    min(1, cummin(U[s]//v_th - s))``.  Pure int32 arithmetic.

``iterative`` (bounded fixed point, everything else)
    Pass k feeds the spikes of pass k-1 into the reset currents ``c[t] =
    i[t] - z[t-1]*v_th`` and re-runs the reset-free affine scan.  After
    pass k the first k timesteps are final, so the iteration converges in
    at most T+1 passes.  The reference's ``lax.while_loop`` stops when a
    pass flips no spike or at the cap;
    :func:`repro_torch.kernels.lif_parallel_scan.lif_fixed_point` keeps
    that rule, so the pass count and the residual (flips between the last
    two passes, 0 on convergence) equal the reference's.  On the card the
    whole loop is one K4 launch in which each feature runs its own passes,
    and the two counts come back to the host once per population.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ...device import require_full_f32
from ...kernels.lif_parallel_scan import lif_fixed_point
from ...kernels.sparse_gather import sparse_gather

def choose_temporal_mode(
    alpha: float, v_th: float, *, nonneg_weights: bool
) -> str:
    """Pick the cheapest exact reset-resolution mode a layer admits."""
    if alpha == 0.0:
        return "alpha0"
    if (
        alpha == 1.0
        and nonneg_weights
        and float(v_th).is_integer()
        and v_th >= 1.0
    ):
        return "count"
    return "iterative"


@dataclasses.dataclass(frozen=True)
class TemporalReport:
    """Per-launch record of the temporal paradigm's reset resolution.

    Keys of ``modes`` / ``iterations`` / ``residual`` are population
    indices (declared order).  Exact modes always report one pass and
    zero residual; iterative populations report the fixed-point pass
    count and the number of spike flips between the final two passes —
    ``residual == 0`` whenever ``iterations < max_iters`` (the loop only
    stops early on convergence).
    """

    split: Tuple[int, int, int]          # (pre, serial-block, post) pops
    modes: Dict[int, str]
    iterations: Dict[int, int]
    residual: Dict[int, int]
    max_iters: int

    def as_dict(self) -> dict:
        return {
            "split": list(self.split),
            "modes": {str(k): v for k, v in self.modes.items()},
            "iterations": {str(k): v for k, v in self.iterations.items()},
            "residual": {str(k): v for k, v in self.residual.items()},
            "max_iters": self.max_iters,
        }


# ---------------------------------------------------------------------------
# whole-train projection


def _delayed_sum(y: torch.Tensor, steps: int) -> torch.Tensor:
    """Sum per-delay contributions y (d_slots, T, B, N) shifted by their
    delay into one (T, B, N) input-current train.  Slot 0 is the unused
    zero row (delays start at 1), so it never contributes."""
    out = torch.zeros(y.shape[1:], dtype=y.dtype, device=y.device)
    for d in range(1, min(y.shape[0], steps)):
        out[d:] += y[d, : steps - d]
    return out


def temporal_project_dense(
    w_dense: torch.Tensor, x: torch.Tensor, complete=None
) -> torch.Tensor:
    """Whole-train dense projection: x (T, B, S) f32 spikes through the
    delay-stacked weights w (d_slots, S, N) -> currents (T, B, N);
    ``complete`` gathers a slab of target columns into the whole."""
    require_full_f32(x.device)
    y = torch.einsum("tbs,dsn->dtbn", x, w_dense)
    out = _delayed_sum(y, x.shape[0])
    return out if complete is None else complete(out)


def temporal_project_sparse(
    ell_val: torch.Tensor,
    ell_idx: torch.Tensor,
    x: torch.Tensor,
    *,
    delay_range: int,
    n_target: int,
    complete=None,
) -> torch.Tensor:
    """Whole-train ELL projection: ONE gather-accumulate launch over all
    T·B spike columns, then the same shift-and-sum as the dense form.
    ``complete`` gathers a slab of ELL rows into all of them.

    The (S, T·B) columns go to the kernel as a strided view of ``x``: on
    the H100 the gather from the view took less time than a source-major
    copy followed by the gather (``chip_smoke.py`` times both)."""
    steps, batch, n_src = x.shape
    d_slots = delay_range + 1
    xs = x.permute(2, 0, 1).reshape(n_src, steps * batch)
    gat = sparse_gather(ell_val, ell_idx, xs)            # (d_slots*N, T*B)
    if complete is not None:
        gat = complete(gat)
    y = gat.view(d_slots, n_target, steps, batch).permute(0, 2, 3, 1)
    return _delayed_sum(y, steps)                      # y: (d_slots, T, B, N)


# ---------------------------------------------------------------------------
# reset resolution


def _temporal_alpha0(i_full: torch.Tensor, v_th: float) -> torch.Tensor:
    vth = float(v_th)                                  # enters the ops as f32
    f0 = (i_full >= vth).to(torch.float32)             # step image of z=0
    f1 = (i_full - vth >= vth).to(torch.float32)       # step image of z=1
    # Hillis-Steele doubling: after the pass with shift s, entry t holds
    # the composition of steps (t-2s, t]; "right after left" is
    # (r0 + l0*(r1-r0), r0 + l1*(r1-r0)), exact in 0/1 arithmetic
    shift = 1
    while shift < i_full.shape[0]:
        l0, l1 = f0[:-shift], f1[:-shift]
        r0, r1 = f0[shift:], f1[shift:]
        step = r1 - r0
        f0 = torch.cat([f0[:shift], r0 + l0 * step])
        f1 = torch.cat([f1[:shift], r0 + l1 * step])
        shift *= 2
    return f0                                          # composed chain at z=0


def _temporal_count(i_full: torch.Tensor, v_th: float) -> torch.Tensor:
    steps = i_full.shape[0]
    if steps == 0:
        return torch.zeros_like(i_full)
    vthi = int(round(v_th))
    u = torch.cumsum(i_full.to(torch.int32), dim=0, dtype=torch.int32)
    k = torch.div(u, vthi, rounding_mode="floor")
    t_idx = torch.arange(steps, dtype=torch.int32, device=i_full.device).reshape(
        (steps,) + (1,) * (i_full.ndim - 1)
    )
    m = torch.cummin(k - t_idx, dim=0).values
    n = t_idx + torch.clamp(m, max=1)                  # cumulative spikes
    nprev = torch.cat([torch.zeros_like(n[:1]), n[:-1]])
    return (n - nprev).to(torch.float32)


def _temporal_iterative(
    i_full: torch.Tensor, v_th: float, alpha: float, max_iters: int
):
    steps = i_full.shape[0]
    z, iters, residual = lif_fixed_point(
        i_full.reshape(steps, -1), alpha=alpha, v_th=v_th, cap=max_iters
    )
    return z.reshape(i_full.shape), iters, residual


def temporal_lif(
    i_full: torch.Tensor,
    *,
    alpha: float,
    v_th: float,
    mode: str,
    max_iters: int | None = None,
):
    """Resolve the spike train for a whole (T, B, N) current train.

    Returns ``(z, iterations, residual)`` with ``z`` f32 0/1 of the same
    shape and two host ints (always ``(1, 0)`` in the exact modes).
    """
    if mode == "alpha0":
        return _temporal_alpha0(i_full, v_th), 1, 0
    if mode == "count":
        return _temporal_count(i_full, v_th), 1, 0
    if mode != "iterative":
        raise ValueError(f"unknown temporal mode {mode!r}")
    cap = int(max_iters) if max_iters else i_full.shape[0] + 1
    return _temporal_iterative(i_full, v_th, alpha, cap)


def temporal_step(
    w_dense: torch.Tensor,
    spikes: torch.Tensor,
    *,
    alpha: float,
    v_th: float,
    mode: str | None = None,
    max_iters: int | None = None,
):
    """One projection + its LIF over the whole train — the temporal
    analogue of the serial/parallel runtimes' per-step ``*_step``.

    ``spikes`` is (T, B, S) f32; ``w_dense`` the (d_slots, S, N)
    delay-stacked weights (``dense_serial_weights`` layout), both on one
    device.  When ``mode`` is None the cheapest admissible mode is chosen
    from the concrete weights.  Returns ``(z, iterations, residual)``.
    """
    if mode is None:
        mode = choose_temporal_mode(
            alpha, v_th, nonneg_weights=bool((w_dense >= 0).all())
        )
    i_full = temporal_project_dense(w_dense, spikes)
    return temporal_lif(
        i_full, alpha=alpha, v_th=v_th, mode=mode, max_iters=max_iters,
    )
