"""Dense LIF oracle — the executable semantics both paradigms must match.

Eq. (1) of the paper:

    V_i^{t+1} = sum_j W_ji * x_j^{t - d(j,i)} + alpha * V_i^t - z_i^t * V_th
    z_i^t     = H(V_i^t - V_th)          (Heaviside; subtractive reset)

Delays d >= 1.  A ring buffer of ``delay_range + 1`` slots holds future
input currents: the contribution of a spike at time t through a synapse of
delay d lands in slot (t + d), which is consumed when computing V^{t+d+1}.

All weights are int8-magnitude integers, so every accumulation is exact in
float32 and the three executors (reference / serial / parallel) agree
bit-for-bit on the spike trains.  The per-delay product is a plain
``torch.einsum`` in full float32: on CUDA it runs only while TF32 is off for
matrix products (PyTorch's default), since TF32 would round the integer
currents (:func:`repro_torch.device.require_full_f32`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import require_full_f32, resolve_device
from ...kernels.lif_update.ref import lif_update_ref
from ..layer import LIFParams, SNNLayer, is_sparse


@dataclasses.dataclass
class LIFState:
    """Per-layer runtime state (batch leading)."""

    v: torch.Tensor       # (B, n_target) membrane potential
    z: torch.Tensor       # (B, n_target) last spike flags (float 0/1)
    ring: torch.Tensor    # (D+1, B, n_target) future input currents


def init_state(
    batch: int, n_target: int, delay_range: int, *, device=None
) -> LIFState:
    dev = resolve_device(device)
    d = delay_range + 1
    return LIFState(
        v=torch.zeros((batch, n_target), dtype=torch.float32, device=dev),
        z=torch.zeros((batch, n_target), dtype=torch.float32, device=dev),
        ring=torch.zeros((d, batch, n_target), dtype=torch.float32, device=dev),
    )


def delay_stacked_weights(layer: SNNLayer) -> np.ndarray:
    """(delay_range, n_source, n_target) float32: slice d-1 holds delay-d weights.

    Accepts dense layers and CSR
    :class:`~repro_torch.core.layer.SparseProjection` storage alike — the
    oracle *densifies internally* (it is the brute-force ground truth, not a
    scalable path), so sparse fixtures diff against exactly the same
    dense per-delay tensors their densified twins produce.
    """
    out = np.zeros((layer.delay_range, layer.n_source, layer.n_target), np.float32)
    if is_sparse(layer):
        src, tgt, w, d = layer.coo()
        out[d - 1, src, tgt] = w
        return out
    conn = layer.connectivity()
    for d in range(1, layer.delay_range + 1):
        m = conn & (layer.delays == d)
        out[d - 1][m] = layer.weights[m]
    return out


def reference_step(
    w_delay: torch.Tensor,    # (D, S, T) dense per-delay weights
    state: LIFState,
    x_t: torch.Tensor,        # (B, S) input spikes at time t (0/1 float)
    t: int,                   # host timestep
    *,
    delay_range: int,
    alpha: float = 0.9,
    v_th: float = 1.0,
) -> tuple:
    """One oracle step; updates ``state.ring`` in place."""
    require_full_f32(x_t.device)
    d_slots = delay_range + 1
    # 1. route spikes to future slots:  ring[(t+d) % slots] += x_t @ W_d
    contrib = torch.einsum("bs,dst->dbt", x_t, w_delay)      # (D, B, T)
    ring = state.ring
    for d in range(delay_range):          # distinct slots: d < d_slots
        ring[(t + 1 + d) % d_slots] += contrib[d]
    # 2. consume the current slot (clone: the zeroing below is in place)
    i_t = ring[t % d_slots].clone()
    ring[t % d_slots] = 0.0
    # 3. Eq. (1), as the plain expression: the oracle shares no kernel
    v_new, z_new = lif_update_ref(i_t, state.v, state.z, alpha=alpha, v_th=v_th)
    return LIFState(v=v_new, z=z_new, ring=ring), z_new


def run_reference(
    layer: SNNLayer,
    spikes: np.ndarray,        # (T, B, n_source) 0/1
    lif: LIFParams | None = None,
    *,
    device=None,
) -> np.ndarray:
    """Run the oracle over a spike train; returns (T, B, n_target) spikes."""
    dev = resolve_device(device)
    lif = lif or layer.lif
    w_delay = torch.as_tensor(delay_stacked_weights(layer), device=dev)
    x = torch.as_tensor(np.asarray(spikes, np.float32), device=dev)
    T, B, _ = x.shape
    state = init_state(B, layer.n_target, layer.delay_range, device=dev)
    zs = torch.empty((T, B, layer.n_target), dtype=torch.float32, device=dev)
    for t in range(T):
        state, zs[t] = reference_step(
            w_delay, state, x[t], t,
            delay_range=layer.delay_range, alpha=lif.alpha, v_th=lif.v_th,
        )
    return zs.cpu().numpy()


def run_graph_reference(net, spikes: np.ndarray) -> list:
    """Brute-force unrolled application-graph oracle — pure numpy, no scan.

    Simulates an :class:`~repro_torch.core.layer.SNNNetwork` graph (fan-in,
    fan-out, self-loops, recurrent edges) with an explicit Python loop
    over timesteps, dense per-delay weight tensors per projection, and
    the same float32 arithmetic as the fused executor.  Sparse (CSR)
    projections are accepted and **densified internally** via
    :func:`delay_stacked_weights` — the oracle is ground truth, not a
    scalable path, so keep its fixtures small.

    * forward projections see their source population's spikes from the
      **current** timestep (within-step cascade in topological order);
    * **back-edges** see the source's spikes from the **previous**
      timestep (the one-step-delayed feedback path), so a back-edge spike
      of synaptic delay ``d`` arrives ``d + 1`` steps after emission;
    * a population sums the currents of all its in-projections before one
      LIF update (``v' = i + alpha*v - z*v_th``; ``z' = v' >= v_th``);
    * multi-input graphs consume the concatenated ``(T, B, n_input)``
      train — each input population reads its ``net.input_slices``
      columns, exactly like the fused executor.

    All weights are int8-magnitude integers, so every accumulation is an
    exact float32 integer and the result is **bit-identical** to the
    compiled executor on every launch path — this is the differential
    harness's ground truth for non-chain graphs (it shares no code with
    the fused scan).  Returns per-projection trains ``[(T, B, n_post),
    ...]`` — entry ``i`` is projection ``i``'s *target population* spike
    train, matching :meth:`NetworkExecutable.run`.
    """
    spikes = np.asarray(spikes, np.float32)
    T, B, n_in = spikes.shape
    if n_in != net.n_input:
        raise ValueError(
            f"spikes must be (T, B, {net.n_input}); got {spikes.shape}"
        )
    idx = {p.name: i for i, p in enumerate(net.populations)}
    sizes = [p.size for p in net.populations]
    endpoints = net.endpoints
    w_delay = [
        delay_stacked_weights(e).astype(np.float32) for e in net.projections
    ]
    d_slots = [e.delay_range + 1 for e in net.projections]
    rings = [
        np.zeros((d_slots[i], B, e.n_target), np.float32)
        for i, e in enumerate(net.projections)
    ]
    v = {p: np.zeros((B, sizes[p]), np.float32) for p in range(len(sizes))}
    z = {p: np.zeros((B, sizes[p]), np.float32) for p in range(len(sizes))}
    prev = [np.zeros((B, s), np.float32) for s in sizes]
    pop_trains = [np.zeros((T, B, s), np.float32) for s in sizes]
    input_set = set(net.input_indices)
    in_slices = list(zip(net.input_indices, net.input_slices))
    for t in range(T):
        cur = [None] * len(sizes)
        for p, (a, b) in in_slices:
            cur[p] = spikes[t][:, a:b]
        for p in net.topo_order:
            if p in input_set:
                continue
            lif = net.population_lif(p)
            alpha, v_th = np.float32(lif.alpha), np.float32(lif.v_th)
            i_tot = np.zeros((B, sizes[p]), np.float32)
            for ei in net.in_edges[p]:
                e = net.projections[ei]
                src = idx[endpoints[ei][0]]
                x = prev[src] if ei in net.back_edges else cur[src]
                # scatter to future ring slots: delay-d lands at t + d
                contrib = np.einsum(
                    "bs,dst->dbt", x, w_delay[ei]
                ).astype(np.float32)
                ring = rings[ei]
                for d in range(e.delay_range):
                    ring[(t + 1 + d) % d_slots[ei]] += contrib[d]
                i_tot += ring[t % d_slots[ei]]
                ring[t % d_slots[ei]] = 0.0
            v[p] = i_tot + alpha * v[p] - z[p] * v_th
            z[p] = (v[p] >= v_th).astype(np.float32)
            cur[p] = z[p]
        for p in range(len(sizes)):
            pop_trains[p][t] = cur[p]
        prev = cur
    return [pop_trains[idx[post]] for _, post in endpoints]
