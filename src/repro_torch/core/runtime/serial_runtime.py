"""Serial-paradigm executor — event-driven semantics, torch port.

Walks the *compiled* serial artifacts exactly as the ARM core does
(paper §III-A): a spike from source j unlocks the master-population-table
entry, which points at j's address-list row, which points at j's block of
packed 32-bit synaptic rows; each row's weight is accumulated into the
synaptic input buffer slot selected by (delay, synapse type).

Three kernel *forms* implement the synaptic-current step, as in the
reference package:

* :func:`serial_project` — the event form: per synaptic row r,
  ``weight[r] * x_t[src[r]]`` scattered into the (delay-slot, target) ring
  by one flat ``index_add_`` over all ``B * R`` (batch, row) pairs with
  batch-offset segment ids (the reference's XLA ``segment_sum``).  On CUDA
  ``index_add_`` accumulates with atomics, so the order of the sums
  changes from run to run; the result is still exact, because every
  weight is an int8-magnitude integer and every current an integer below
  2^24, which the bit-identity tests rely on.
* :func:`serial_project_dense` — the dense fallback: the row arrays folded
  into a ``(d_slots, S, T)`` tensor so the update is one ``torch.einsum``
  plus a ring roll.  The einsum is exact only in full float32, so on CUDA
  it runs only while TF32 stays off for matrix products (PyTorch's
  default; :func:`~repro_torch.device.require_full_f32`).
* :func:`serial_project_sparse` — the ELL gather form through the CUDA
  gather kernel (:mod:`repro_torch.kernels.sparse_gather`).

Every form is bit-identical on the spike trains, so which one runs is a
throughput decision (:meth:`SerialBatchCostModel.choose_form
<repro_torch.core.cost_model.SerialBatchCostModel.choose_form>`).

Each form is two halves.  The *update half* (``serial_update``,
``serial_update_dense``, ``serial_update_sparse``) turns the step's spikes
into a ``(d_slots, B, n_target)`` update and the shift that lands its slot
``d`` in ring slot ``(d + shift) mod d_slots``.  The *delivery*
(:func:`~repro_torch.kernels.lif_update.ring_deliver_ref`) adds it into the
delay ring and takes out the current slot.  The fused executor runs only
the update halves and hands the delivery to the population step
(:func:`repro_torch.kernels.lif_update.lif_step`), one launch for all of a
population's in-edges; ``serial_project*`` run both halves.

Unlike the reference's functional updates, the ring is updated **in
place**: each ``serial_project*`` adds into ``ring``, copies out the
current slot (``clone`` — the slot is zeroed in place right after) and
returns ``(ring, i_t)`` with ``ring`` the same tensor it was given.
``t`` is a host integer throughout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import require_full_f32, resolve_device
from ...kernels.lif_update import lif_update, ring_deliver_ref
from ...kernels.sparse_gather import sparse_gather
from ..layer import LIFParams, SNNLayer
from ..serial_compiler import SerialProgram, compile_serial, unpack_rows
from .reference import LIFState, init_state

#: Total ``lower_serial`` invocations (executable caching keeps this at one
#: per layer per report and device).
LOWER_COUNT = 0


@dataclasses.dataclass
class SerialExecutable:
    """Flattened row arrays across all machine-graph cells."""

    n_source: int
    n_target: int
    delay_range: int
    row_weight: torch.Tensor   # (R,) f32 signed weight
    row_delay: torch.Tensor    # (R,) i32 in [1, D]
    row_src: torch.Tensor      # (R,) i32 global source index
    row_tgt: torch.Tensor      # (R,) i32 global target index
    lif: LIFParams

    @property
    def device(self) -> torch.device:
        return self.row_weight.device


def lower_serial(
    program: SerialProgram, lif: LIFParams | None = None, *, device=None
) -> SerialExecutable:
    """Decode packed rows of every cell into flat gather arrays on ``device``."""
    global LOWER_COUNT
    LOWER_COUNT += 1
    dev = resolve_device(device)
    ws, ds_, ss, ts = [], [], [], []
    for cell in program.cells:
        w, d, tgt_local = unpack_rows(cell.synaptic_rows)
        # reconstruct each row's source neuron from the address list
        row_len = cell.address_list[:, 1]
        src_local = np.repeat(np.arange(cell.src_size), row_len)
        ws.append(w)
        ds_.append(d)
        ss.append(src_local + cell.src_start)
        ts.append(tgt_local + cell.tgt_start)

    def cat(parts, dtype):
        arr = np.concatenate(parts) if parts else np.zeros(0)
        return torch.as_tensor(np.asarray(arr, dtype), device=dev)

    return SerialExecutable(
        n_source=program.n_source,
        n_target=program.n_target,
        delay_range=program.delay_range,
        row_weight=cat(ws, np.float32),
        row_delay=cat(ds_, np.int32),
        row_src=cat(ss, np.int32),
        row_tgt=cat(ts, np.int32),
        lif=lif or LIFParams(),
    )


def serial_update(
    exe_weight, exe_delay, exe_src, exe_tgt,
    x_t: torch.Tensor,    # (B, S) f32
    t: int,
    *,
    delay_range: int,
    n_target: int,
    complete=None,
):
    """Event form's update half: ``(upd, 0)``, ``upd`` the ``(d_slots, B,
    n_target)`` view of this step's scattered spikes.

    The segment ids already hold each row's ring slot ``(delay + t) mod
    d_slots``, so the update lands unshifted.  ``complete``, when given,
    sums the flat update over the ranks that hold the other slabs of the
    synaptic rows (:mod:`repro_torch.distributed.exchange`).
    """
    d_slots = delay_range + 1
    batch = x_t.shape[0]
    # event-driven gather: row fires iff its source spiked this timestep
    fired = x_t[:, exe_src.long()]                   # (B, R)
    contrib = fired * exe_weight[None, :]            # (B, R)
    slot = (exe_delay + t) % d_slots                 # (R,) floor-mod
    seg = slot * n_target + exe_tgt                  # ring-flat segment ids
    # one flat index_add_ over all (batch, row) pairs: batch b's rows are
    # offset into their own block of d_slots * n_target segments
    seg_flat = (
        torch.arange(batch, dtype=torch.int64, device=x_t.device)[:, None]
        * (d_slots * n_target)
        + seg[None, :]
    ).reshape(-1)                                    # (B*R,)
    updates = torch.zeros(
        batch * d_slots * n_target, dtype=torch.float32, device=x_t.device
    ).index_add_(0, seg_flat, contrib.reshape(-1))
    if complete is not None:
        updates = complete(updates)
    return updates.view(batch, d_slots, n_target).transpose(0, 1), 0


def serial_project(
    exe_weight, exe_delay, exe_src, exe_tgt,
    ring: torch.Tensor,   # (d_slots, B, n_target) f32 future input currents
    x_t: torch.Tensor,    # (B, S) f32
    t: int,
    *,
    delay_range: int,
    n_target: int,
):
    """Event-form synaptic-current step of ONE projection.

    Scatters this timestep's presynaptic spikes through the delay ring and
    returns ``(ring, i_t)`` — the ring (updated in place) and the
    ``(B, n_target)`` input current the target population consumes at
    ``t``.
    """
    upd, shift = serial_update(
        exe_weight, exe_delay, exe_src, exe_tgt, x_t, t,
        delay_range=delay_range, n_target=n_target,
    )
    return ring, ring_deliver_ref(ring, upd, shift, t)


def serial_step(
    exe_weight, exe_delay, exe_src, exe_tgt,
    state: LIFState,
    x_t: torch.Tensor,    # (B, S)
    t: int,
    *,
    delay_range: int,
    n_target: int,
    alpha: float,
    v_th: float,
):
    ring, i_t = serial_project(
        exe_weight, exe_delay, exe_src, exe_tgt, state.ring, x_t, t,
        delay_range=delay_range, n_target=n_target,
    )
    v_new, z_new = lif_update(i_t, state.v, state.z, alpha=alpha, v_th=v_th)
    return LIFState(v=v_new, z=z_new, ring=ring), z_new


def dense_serial_weights(exe: SerialExecutable) -> np.ndarray:
    """Fold the flat row arrays into a ``(d_slots, S, T)`` dense tensor.

    Slot ``d`` holds the delay-``d`` weights (slot 0 is all zero — delays
    are >= 1), so ``x_t @ W[d]`` is exactly the sum the event form
    scatters for delay ``d``.
    """
    d_slots = exe.delay_range + 1
    w = np.zeros((d_slots, exe.n_source, exe.n_target), np.float32)
    np.add.at(
        w,
        (
            exe.row_delay.cpu().numpy(),
            exe.row_src.cpu().numpy(),
            exe.row_tgt.cpu().numpy(),
        ),
        exe.row_weight.cpu().numpy(),
    )
    return w


def serial_project_dense(
    w_dense,             # (d_slots, S, T) f32 per-delay-slot weights
    ring: torch.Tensor,  # (d_slots, B, n_target) f32 future input currents
    x_t: torch.Tensor,   # (B, S)
    t: int,
    *,
    delay_range: int,
    n_target: int,
):
    """Dense-fallback synaptic-current step — same ring, same currents.

    ``upd[d] = x_t @ W[d]`` is the total delay-``d`` contribution; rolling
    by ``t`` lands it in ring slot ``(t + d) % d_slots``, exactly where the
    event form's segment ids point.  Delay-0 weights are structurally zero,
    so the current slot is read before anything lands in it.
    """
    upd, shift = serial_update_dense(
        w_dense, x_t, t, delay_range=delay_range, n_target=n_target,
    )
    return ring, ring_deliver_ref(ring, upd, shift, t)


def serial_update_dense(
    w_dense,             # (d_slots, S, T) f32 per-delay-slot weights
    x_t: torch.Tensor,   # (B, S)
    t: int,
    *,
    delay_range: int,
    n_target: int,
    complete=None,
):
    """Dense form's update half: ``(x_t @ W[d] for every d, t)``;
    ``complete`` gathers a slab of target columns into the whole."""
    require_full_f32(x_t.device)
    upd = torch.einsum("bs,dst->dbt", x_t, w_dense)         # (d_slots, B, T)
    return (upd if complete is None else complete(upd)), t


def serial_step_dense(
    w_dense,
    state: LIFState,
    x_t: torch.Tensor,
    t: int,
    *,
    delay_range: int,
    n_target: int,
    alpha: float,
    v_th: float,
):
    """Dense-fallback serial step — same carry, same outputs, all matmul."""
    ring, i_t = serial_project_dense(
        w_dense, state.ring, x_t, t, delay_range=delay_range, n_target=n_target,
    )
    v_new, z_new = lif_update(i_t, state.v, state.z, alpha=alpha, v_th=v_th)
    return LIFState(v=v_new, z=z_new, ring=ring), z_new


def sparse_serial_operands(exe: SerialExecutable):
    """Group the flat row arrays into ELL form for the sparse kernel.

    One ELL row per ``(delay_slot, target)`` pair — row id ``delay *
    n_target + target`` — holding that pair's source indices and weights,
    padded to the longest row with weight-0 / index-0 lanes.  The gather
    ``out[row] = sum_l w[row, l] * x[idx[row, l]]`` then computes exactly
    the sum the event form scatters into ring slot ``(t + delay) %
    d_slots`` at target ``target``.

    Returns ``(ell_val, ell_idx)``: ``(d_slots * n_target, L)`` f32/i32
    host-side numpy arrays (built once per executable, cached by the
    executor next to the dense operand).
    """
    d_slots = exe.delay_range + 1
    T = exe.n_target
    w = exe.row_weight.cpu().numpy().astype(np.float32)
    dly = exe.row_delay.cpu().numpy().astype(np.int64)
    src = exe.row_src.cpu().numpy().astype(np.int64)
    tgt = exe.row_tgt.cpu().numpy().astype(np.int64)
    n_rows = d_slots * T
    row_id = dly * T + tgt
    counts = np.bincount(row_id, minlength=n_rows)
    L = max(1, int(counts.max()) if counts.size else 1)
    order = np.argsort(row_id, kind="stable")
    starts = np.cumsum(counts) - counts               # first slot of each row
    lane = np.arange(row_id.size) - np.repeat(starts, counts)
    ell_val = np.zeros((n_rows, L), np.float32)
    ell_idx = np.zeros((n_rows, L), np.int32)
    ell_val[row_id[order], lane] = w[order]
    ell_idx[row_id[order], lane] = src[order]
    return ell_val, ell_idx


def serial_project_sparse(
    ell_val,             # (d_slots * T, L) f32 ELL weights
    ell_idx,             # (d_slots * T, L) i32 ELL source indices
    ring: torch.Tensor,  # (d_slots, B, n_target) f32 future input currents
    x_t: torch.Tensor,   # (B, S)
    t: int,
    *,
    delay_range: int,
    n_target: int,
):
    """Sparse (ELL gather) synaptic-current step — same ring, same currents.

    Each ELL row gathers and accumulates one ``(delay, target)`` pair's
    contribution for the whole batch (:mod:`repro_torch.kernels.sparse_gather`
    takes ``x`` source-major through its strides, so the step's ``(B, S)``
    spikes go in as the view ``x_t.t()``, not copied); the
    ``(d_slots * T, B)`` result viewed as
    ``(d_slots, B, T)`` and rolled by ``t`` lands delay-``d`` sums in ring
    slot ``(t + d) % d_slots``, exactly where the event form's segment ids
    point.
    """
    upd, shift = serial_update_sparse(
        ell_val, ell_idx, x_t, t, delay_range=delay_range, n_target=n_target,
    )
    return ring, ring_deliver_ref(ring, upd, shift, t)


def serial_update_sparse(
    ell_val,             # (d_slots * T, L) f32 ELL weights
    ell_idx,             # (d_slots * T, L) i32 ELL source indices
    x_t: torch.Tensor,   # (B, S)
    t: int,
    *,
    delay_range: int,
    n_target: int,
    complete=None,
):
    """Sparse form's update half: one K3 launch; ``(upd, t)``, ``upd`` the
    ``(d_slots, B, T)`` strided view of the ``(d_slots * T, B)`` gather.
    ``complete`` gathers a slab of ELL rows into all of them."""
    d_slots = delay_range + 1
    out = sparse_gather(ell_val, ell_idx, x_t.t())                # (R, B)
    if complete is not None:
        out = complete(out)
    return out.view(d_slots, n_target, -1).permute(0, 2, 1), t    # (d, B, T)


def serial_step_sparse(
    ell_val,
    ell_idx,
    state: LIFState,
    x_t: torch.Tensor,
    t: int,
    *,
    delay_range: int,
    n_target: int,
    alpha: float,
    v_th: float,
):
    """Sparse serial step — same carry, same outputs, gather + LIF."""
    ring, i_t = serial_project_sparse(
        ell_val, ell_idx, state.ring, x_t, t,
        delay_range=delay_range, n_target=n_target,
    )
    v_new, z_new = lif_update(i_t, state.v, state.z, alpha=alpha, v_th=v_th)
    return LIFState(v=v_new, z=z_new, ring=ring), z_new


def run_serial(
    layer: SNNLayer,
    spikes: np.ndarray,
    lif: LIFParams | None = None,
    program: SerialProgram | None = None,
    *,
    device=None,
) -> np.ndarray:
    """One projection through the event form; returns (T, B, n_target)."""
    program = program or compile_serial(layer)
    exe = lower_serial(program, lif or layer.lif, device=device)
    x = torch.as_tensor(np.asarray(spikes, np.float32), device=exe.device)
    T, B, _ = x.shape
    state = init_state(B, exe.n_target, exe.delay_range, device=exe.device)
    zs = torch.empty((T, B, exe.n_target), dtype=torch.float32, device=exe.device)
    for t in range(T):
        state, zs[t] = serial_step(
            exe.row_weight, exe.row_delay, exe.row_src, exe.row_tgt,
            state, x[t], t,
            delay_range=exe.delay_range, n_target=exe.n_target,
            alpha=exe.lif.alpha, v_th=exe.lif.v_th,
        )
    return zs.cpu().numpy()
