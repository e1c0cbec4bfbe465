"""Fused whole-network executor — one loop over timesteps for the graph.

On SpiNNaker2 every population advances together each timestep: the chip
runs a lockstep per-timestep pipeline across all PEs (arXiv 1911.02385),
whatever paradigm each projection's PEs execute.  This module mirrors that
structure on the CUDA card:

* :func:`get_layer_executable` lowers a :class:`CompiledLayer`'s program
  once per device and caches the result on the compiled projection, so
  repeated runs never re-lower.  The report classes are the port's own
  (:mod:`repro_torch.core.switching`), so a port executable never lands
  on a reference report, nor the other way round.
* :class:`NetworkExecutable` executes the **application graph** of
  :class:`~repro_torch.core.layer.SNNNetwork` — populations as vertices,
  projections as edges — in **one Python loop over timesteps**
  (:func:`_scan_network`; the reference's ``jax.lax.scan``).  Within a
  timestep, forward projections cascade in the graph's topological
  order; **back-edges** (self-loops and projections onto earlier
  populations) read their source population's spikes from a
  one-step-delayed **feedback ring**, so a spike crossing a back-edge of
  synaptic delay ``d`` arrives ``d + 1`` steps after emission.

Each projection contributes a *synaptic current* through its paradigm's
machinery (:func:`~repro_torch.core.runtime.serial_runtime.serial_project`
and its sparse/dense forms, or
:func:`~repro_torch.core.runtime.parallel_runtime.parallel_project`); a
population sums the currents of all its in-projections and runs ONE fused
LIF update (:func:`repro_torch.kernels.lif_update`).  All weights are
int8-magnitude integers, so the sums are exact in float32 and converging
projections stay bit-exact.

Layout: everything the loop carries is batch-major, ``(B, n)`` — membrane
potentials, int8 previous spikes, the int8 feedback ring and the
parallel projections' int8 history rings — so the LIF kernel and the
matmul kernel read and write contiguous buffers with no transposes.  The
serial delay rings are ``(d_slots, B, n_target)`` f32, as in the
reference.  Spike state crossing timesteps is int8 (spikes are exactly
0/1, so the casts are exact).

The timestep ``t`` is a host integer and nothing in the loop reads a
device value back: a launch enqueues its whole T-step run, and the
all-0/1 output self-check stays on the device (:attr:`last_check`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...kernels.lif_update import lif_update
from ..cost_model import DEFAULT_SERIAL_BATCH_COST, SerialBatchCostModel
from ..layer import LIFParams, SNNNetwork
from ..parallel_compiler import ParallelProgram
from ..serial_compiler import SerialProgram
from ..switching import CompiledLayer, CompileReport
from .parallel_runtime import (
    ParallelExecutable,
    init_history,
    lower_parallel,
    parallel_project,
)
from .serial_runtime import (
    SerialExecutable,
    dense_serial_weights,
    lower_serial,
    serial_project,
    serial_project_dense,
    serial_project_sparse,
    sparse_serial_operands,
)


def get_layer_executable(
    compiled: CompiledLayer, lif: LIFParams | None = None, *, device=None
):
    """Lower ``compiled.program`` once per device; reuse the cached one after.

    The cache is invalidated (re-lowered) if it was built for different
    LIF parameters or another device than the ones requested now.
    """
    lif = lif or LIFParams()
    dev = resolve_device(device)
    exe = compiled.executable
    if exe is not None and exe.lif == lif and exe.device == dev:
        return exe
    prog = compiled.program
    if isinstance(prog, SerialProgram):
        exe = lower_serial(prog, lif, device=dev)
    elif isinstance(prog, ParallelProgram):
        exe = lower_parallel(prog, lif, device=dev)
    else:  # pragma: no cover
        raise TypeError(type(prog))
    compiled.executable = exe
    return exe


@dataclasses.dataclass(frozen=True)
class LayerMeta:
    """Static per-projection facts the loop reads.

    ``alpha``/``v_th`` are the *target population's* effective LIF
    parameters (for a chain: the layer's own ``lif``).
    """

    paradigm: str        # "serial" | "parallel"
    n_source: int
    n_target: int
    delay_range: int
    alpha: float
    v_th: float
    #: Event volume: synaptic rows (serial) / WDM columns (parallel); feeds
    #: the serial form decision.
    n_rows: int = 0

    @property
    def ring_depth(self) -> int:
        """Spike-history ring depth; >= 1 even for degenerate programs."""
        return max(1, self.delay_range)


@dataclasses.dataclass(frozen=True)
class GraphPlan:
    """Static application-graph structure the loop follows.

    Population indices are the network's *declared* indices; only the
    iteration order (``update_order``) is topological.  Input populations
    carry dummy LIF constants (they have no neural update — their
    "spikes" are slices of the external train: input population
    ``input_pops[k]`` reads columns ``input_slices[k]`` of the
    concatenated ``(T, B, n_input)`` train, declared order).
    """

    pop_sizes: Tuple[int, ...]
    input_pops: Tuple[int, ...]           # declared indices of input pops
    input_slices: Tuple[Tuple[int, int], ...]  # per input pop: train columns
    update_order: Tuple[int, ...]         # non-input pops, topological order
    pop_alpha: Tuple[float, ...]
    pop_vth: Tuple[float, ...]
    in_edges: Tuple[Tuple[int, ...], ...]  # per pop: in-projection indices
    proj_src: Tuple[int, ...]             # per projection: source pop
    proj_tgt: Tuple[int, ...]             # per projection: target pop
    proj_back: Tuple[bool, ...]           # per projection: back-edge?
    back_sources: Tuple[int, ...]         # pops carried in the feedback ring


def _graph_plan(net: SNNNetwork) -> GraphPlan:
    """Extract the static execution plan from the application graph."""
    n = len(net.populations)
    input_pops = net.input_indices
    input_set = frozenset(input_pops)
    update_order = tuple(p for p in net.topo_order if p not in input_set)
    alpha, vth = [0.0] * n, [1.0] * n
    for p in update_order:
        lif = net.population_lif(p)
        alpha[p], vth[p] = float(lif.alpha), float(lif.v_th)
    endpoints = net.endpoints
    proj_src = tuple(net.population_index(pre) for pre, _ in endpoints)
    return GraphPlan(
        pop_sizes=tuple(p.size for p in net.populations),
        input_pops=input_pops,
        input_slices=net.input_slices,
        update_order=update_order,
        pop_alpha=tuple(alpha),
        pop_vth=tuple(vth),
        in_edges=tuple(net.in_edges),
        proj_src=proj_src,
        proj_tgt=tuple(
            net.population_index(post) for _, post in endpoints
        ),
        proj_back=tuple(
            i in net.back_edges for i in range(len(endpoints))
        ),
        back_sources=tuple(sorted({proj_src[i] for i in net.back_edges})),
    )


def _chain_plan(metas: Tuple[LayerMeta, ...]) -> GraphPlan:
    """The feed-forward chain plan (for handles built without a network)."""
    n = len(metas) + 1
    return GraphPlan(
        pop_sizes=(metas[0].n_source,) + tuple(m.n_target for m in metas),
        input_pops=(0,),
        input_slices=((0, metas[0].n_source),),
        update_order=tuple(range(1, n)),
        pop_alpha=(0.0,) + tuple(m.alpha for m in metas),
        pop_vth=(1.0,) + tuple(m.v_th for m in metas),
        in_edges=((),) + tuple((i,) for i in range(len(metas))),
        proj_src=tuple(range(len(metas))),
        proj_tgt=tuple(range(1, n)),
        proj_back=(False,) * len(metas),
        back_sources=(),
    )


def _layer_params(exe) -> Tuple[torch.Tensor, ...]:
    """The operand tensors of one lowered layer."""
    if isinstance(exe, SerialExecutable):
        return (exe.row_weight, exe.row_delay, exe.row_src, exe.row_tgt)
    return (exe.wdm_stack, exe.col_source, exe.col_delay)


def _init_graph_carry(
    plan: GraphPlan, metas: Tuple[LayerMeta, ...], batch: int, device
):
    """Fresh zero loop state: per-projection rings, per-population LIF
    state, and the back-edge feedback ring.  The loop updates these
    buffers in place, so every launch builds its own."""
    zeros = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    proj = [
        zeros((m.delay_range + 1, batch, m.n_target), torch.float32)
        if m.paradigm == "serial"
        else init_history(batch, m.ring_depth, m.n_source, device=device)
        for m in metas
    ]
    pop_v = [
        zeros((batch, plan.pop_sizes[p]), torch.float32)
        for p in plan.update_order
    ]
    # spike state crossing timesteps is int8 (spikes are exactly 0/1, the
    # f32<->int8 casts are exact) — same element type as the parallel
    # spike-history rings
    pop_z = [
        zeros((batch, plan.pop_sizes[p]), torch.int8)
        for p in plan.update_order
    ]
    feedback = [
        zeros((batch, plan.pop_sizes[s]), torch.int8)
        for s in plan.back_sources
    ]
    return proj, pop_v, pop_z, feedback


_SERIAL_FORMS = {
    "event": serial_project,
    "sparse": serial_project_sparse,
    "dense": serial_project_dense,
}


def _scan_network(
    plan: GraphPlan,
    metas: Tuple[LayerMeta, ...],
    forms: Tuple[str, ...],       # per proj: "event" | "sparse" | "dense" | "-"
    params: List[Tuple[torch.Tensor, ...]],
    states,                       # _init_graph_carry output (updated in place)
    spikes: torch.Tensor,         # (T, B, n_input) f32
    valid_steps: torch.Tensor | None = None,   # (B,) true length per request
):
    """Run the graph over all T steps; returns per-population trains.

    Step-count mask: batch slot b is live while t < valid_steps[b].  The
    mask is applied entirely OUTSIDE the loop (one multiply on the input
    train and one per population's stacked output), so masking costs
    nothing per timestep.  Padded timesteps are inert per request: the
    input mask stops them injecting external spikes, the output mask
    forces their emitted spikes to exact zeros, and because the loop is
    causal and batch slots are independent, the first valid_steps[b]
    outputs are bit-identical to running that request alone.
    """
    T, batch = spikes.shape[0], spikes.shape[1]
    live = None
    if valid_steps is not None:
        live = (
            torch.arange(T, device=spikes.device)[:, None]
            < valid_steps[None, :]
        ).to(spikes.dtype)[:, :, None]                    # (T, B, 1)
        spikes = spikes * live

    proj_states, pop_v, pop_z, feedback = states
    vz_slot = {p: k for k, p in enumerate(plan.update_order)}
    fb_slot = {s: k for k, s in enumerate(plan.back_sources)}
    outs = [
        torch.empty(
            (T, batch, plan.pop_sizes[p]), dtype=torch.float32,
            device=spikes.device,
        )
        for p in plan.update_order
    ]
    full_input = tuple(plan.input_slices) == ((0, spikes.shape[2]),)
    for t in range(T):
        x_t = spikes[t]
        pop_out = [None] * len(plan.pop_sizes)
        for p, (a, b) in zip(plan.input_pops, plan.input_slices):
            pop_out[p] = x_t if full_input else x_t[:, a:b]
        for p in plan.update_order:
            k = vz_slot[p]
            i_nb = None               # summed current, (B, n_target)
            for ei in plan.in_edges[p]:
                meta = metas[ei]
                # back-edges read the source's spikes from the previous
                # timestep (int8 feedback ring; the f32 cast of 0/1 spikes
                # is exact); forward edges cascade within the step
                x = (
                    feedback[fb_slot[plan.proj_src[ei]]].to(torch.float32)
                    if plan.proj_back[ei]
                    else pop_out[plan.proj_src[ei]]
                )
                if meta.paradigm == "serial":
                    _, i_e = _SERIAL_FORMS[forms[ei]](
                        *params[ei], proj_states[ei], x, t,
                        delay_range=meta.delay_range, n_target=meta.n_target,
                    )
                else:
                    _, i_e = parallel_project(
                        *params[ei], proj_states[ei], x, t
                    )
                i_nb = i_e if i_nb is None else i_nb + i_e
            v_new, z_new = lif_update(
                i_nb, pop_v[k], pop_z[k].to(torch.float32),
                alpha=plan.pop_alpha[p], v_th=plan.pop_vth[p],
            )
            # previous-spike state crosses the timestep as int8 (exact:
            # spikes are 0/1); the f32 train is what the step emits and
            # what same-step forward projections consume
            pop_v[k], pop_z[k] = v_new, z_new.to(torch.int8)
            outs[k][t] = z_new
            pop_out[p] = z_new
        for j, s in enumerate(plan.back_sources):
            feedback[j] = pop_out[s].to(torch.int8)
    if live is not None:
        outs = [z * live for z in outs]
    return outs


class NetworkExecutable:
    """A whole compiled application graph, lowered once, run in one loop."""

    def __init__(
        self,
        metas: Tuple[LayerMeta, ...],
        params: List[Tuple[torch.Tensor, ...]],
        name: str = "snn",
        *,
        plan: GraphPlan | None = None,
        report: CompileReport | None = None,
        cost_model: SerialBatchCostModel | None = None,
        device=None,
    ):
        self.metas = tuple(metas)
        self.params = list(params)
        self.name = name
        self.device = resolve_device(device)
        #: The application-graph execution plan; a plain chain when the
        #: handle was constructed from bare metas.
        self.plan = plan or (_chain_plan(self.metas) if self.metas else None)
        #: The report this executable was built from; launches record
        #: their serial kernel-form decisions into ``report.serial_forms``.
        self.report = report
        #: Crossover model deciding the serial form per batch.
        self.cost_model = cost_model or DEFAULT_SERIAL_BATCH_COST
        self._dense = {}     # layer index -> (d_slots, S, T) dense operand
        self._sparse = {}    # layer index -> (ell_val, ell_idx) ELL operands
        #: Device bool tensor from the last launch: True iff every output
        #: entry was exactly 0.0 or 1.0 (NaN/Inf equal neither).  Computed
        #: on the device after the loop and never read back by the launch,
        #: so checking it costs the caller one sync when it wants to know.
        self.last_check = None

    @classmethod
    def build(
        cls, net: SNNNetwork, report: CompileReport, *, device=None
    ) -> "NetworkExecutable":
        if len(report.layers) != len(net.layers):
            raise ValueError("report does not match network")
        dev = resolve_device(device)
        plan = _graph_plan(net)
        metas, params = [], []
        for i, (layer, compiled) in enumerate(
            zip(net.layers, report.layers)
        ):
            exe = get_layer_executable(compiled, layer.lif, device=dev)
            tgt = plan.proj_tgt[i]
            metas.append(
                LayerMeta(
                    paradigm=compiled.paradigm,
                    n_source=exe.n_source,
                    n_target=exe.n_target,
                    delay_range=exe.delay_range,
                    alpha=plan.pop_alpha[tgt],
                    v_th=plan.pop_vth[tgt],
                    n_rows=int(
                        exe.row_weight.shape[0]
                        if isinstance(exe, SerialExecutable)
                        else exe.col_source.shape[0]
                    ),
                )
            )
            params.append(_layer_params(exe))
        return cls(
            tuple(metas), params, name=getattr(net, "name", "snn"),
            plan=plan, report=report, device=dev,
        )

    @property
    def n_input(self) -> int:
        """Width of the external spike train (summed input pop sizes)."""
        return sum(b - a for a, b in self.plan.input_slices)

    # -- serial kernel-form selection ----------------------------------------
    def serial_forms(
        self, batch: int, serial_form: str = "auto"
    ) -> Tuple[str, ...]:
        """Per-projection kernel form at this batch: "event" | "sparse" |
        "dense" ("-" = parallel).

        ``serial_form`` forces every serial projection onto one form;
        "auto" asks the cost model's three-way argmin per projection
        (:meth:`~repro_torch.core.cost_model.SerialBatchCostModel.choose_form`).
        Forcing "dense" on a projection over the cost model's element cap
        raises; every form is bit-identical on outputs, so the choice only
        moves throughput.
        """
        if serial_form not in ("auto", "event", "sparse", "dense"):
            raise ValueError(f"unknown serial_form {serial_form!r}")
        forms = []
        for meta in self.metas:
            if meta.paradigm != "serial":
                forms.append("-")
            elif serial_form != "auto":
                if serial_form == "dense" and not self.cost_model.dense_fits(
                    meta.n_source, meta.n_target, meta.delay_range
                ):
                    raise ValueError(
                        f"serial_form='dense' forced on a projection whose "
                        f"({meta.delay_range + 1}, {meta.n_source}, "
                        f"{meta.n_target}) dense operand exceeds the "
                        f"{self.cost_model.dense_element_cap}-element cap — "
                        f"use serial_form='sparse' (or 'auto')"
                    )
                forms.append(serial_form)
            else:
                forms.append(
                    self.cost_model.choose_form(
                        meta.n_rows, meta.n_source, meta.n_target,
                        meta.delay_range, batch,
                    )
                )
        return tuple(forms)

    def _serial_exe(self, i: int) -> SerialExecutable:
        meta, p = self.metas[i], self.params[i]
        return SerialExecutable(
            n_source=meta.n_source, n_target=meta.n_target,
            delay_range=meta.delay_range,
            row_weight=p[0], row_delay=p[1], row_src=p[2], row_tgt=p[3],
            lif=LIFParams(alpha=meta.alpha, v_th=meta.v_th),
        )

    def _dense_param(self, i: int) -> Tuple[torch.Tensor, ...]:
        """The layer's dense-form operand, built once and cached."""
        w = self._dense.get(i)
        if w is None:
            w = torch.as_tensor(
                dense_serial_weights(self._serial_exe(i)), device=self.device
            )
            self._dense[i] = w
        return (w,)

    def _sparse_param(self, i: int) -> Tuple[torch.Tensor, ...]:
        """The layer's ELL (sparse-form) operands, built once and cached."""
        ell = self._sparse.get(i)
        if ell is None:
            val, idx = sparse_serial_operands(self._serial_exe(i))
            ell = (
                torch.as_tensor(val, device=self.device),
                torch.as_tensor(idx, device=self.device),
            )
            self._sparse[i] = ell
        return ell

    def _params_for(self, forms: Tuple[str, ...]) -> List[Tuple]:
        per_form = {"dense": self._dense_param, "sparse": self._sparse_param}
        return [
            per_form[form](i) if form in per_form else p
            for i, (form, p) in enumerate(zip(forms, self.params))
        ]

    def _record_forms(self, batch: int, forms: Tuple[str, ...]) -> None:
        if self.report is not None:
            self.report.serial_forms[("fused", batch)] = forms

    # -- launch paths --------------------------------------------------------
    def _inputs(self, spikes, valid_steps):
        spikes = torch.as_tensor(spikes, dtype=torch.float32, device=self.device)
        if spikes.ndim != 3 or spikes.shape[2] != self.n_input:
            raise ValueError(
                f"spikes must be (T, B, {self.n_input}); got {tuple(spikes.shape)}"
            )
        if valid_steps is not None:
            valid_steps = torch.as_tensor(
                valid_steps, dtype=torch.int32, device=self.device
            )
            if valid_steps.shape != (spikes.shape[1],):
                raise ValueError(
                    f"valid_steps must be ({spikes.shape[1]},); "
                    f"got {tuple(valid_steps.shape)}"
                )
        return spikes, valid_steps

    def run_device(
        self,
        spikes,                    # (T, B, n_input) 0/1, numpy or tensor
        *,
        valid_steps=None,          # (B,) true steps per request
        serial_form: str = "auto",
    ) -> Tuple[torch.Tensor, ...]:
        """Per-projection spike trains as device tensors — no host sync.

        Entry ``i`` is the spike train of projection ``i``'s *target
        population* (fan-in entries alias one tensor).  Callers that time
        this must ``torch.cuda.synchronize()``.  With ``valid_steps``,
        batch slot ``b`` is masked after its first ``valid_steps[b]``
        timesteps: the live prefix is bit-identical to an unmasked run
        and every padded timestep emits exact zeros.  ``serial_form``
        forces the serial kernel form ("auto" lets the cost model pick
        per projection); the form never changes outputs.
        """
        if not self.metas:
            return ()
        spikes, valid_steps = self._inputs(spikes, valid_steps)
        forms = self.serial_forms(spikes.shape[1], serial_form)
        self._record_forms(spikes.shape[1], forms)
        states = _init_graph_carry(
            self.plan, self.metas, spikes.shape[1], self.device
        )
        outs = _scan_network(
            self.plan, self.metas, forms, self._params_for(forms), states,
            spikes, valid_steps,
        )
        # output self-check on the device: every spike entry must be
        # exactly 0.0 or 1.0 (subsumes finiteness — NaN and Inf equal
        # neither), reduced to one bool tensor and never read back here
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        for z in outs:
            ok = ok & ((z == 0.0) | (z == 1.0)).all()
        self.last_check = ok
        slot = {p: k for k, p in enumerate(self.plan.update_order)}
        return tuple(outs[slot[tgt]] for tgt in self.plan.proj_tgt)

    def run(
        self,
        spikes,
        *,
        valid_steps=None,
        serial_form: str = "auto",
    ) -> List[np.ndarray]:
        """Returns the per-projection spike trains [(T, B, n_l) ...]."""
        outs = self.run_device(
            spikes, valid_steps=valid_steps, serial_form=serial_form
        )
        # single host sync, after the whole network finished on the device
        return [z.cpu().numpy() for z in outs]


class OutputValidationError(ValueError):
    """A launch returned spike trains that cannot be served.

    Raised by :func:`validate_spike_outputs` when a result violates the
    output contract (shape, dtype, finiteness, binariness).
    """


def validate_spike_outputs(
    outs,
    *,
    steps: int,
    batch: int,
    sizes: Optional[Tuple[int, ...]] = None,
) -> None:
    """Post-launch guard: every output train must be a servable spike train.

    Checks, per projection output: shape ``(steps, batch, n_target)``
    (``sizes`` supplies the expected widths when known), float32 dtype,
    and every entry exactly 0.0 or 1.0.  The binary check subsumes
    finiteness — NaN and Inf compare unequal to both 0 and 1 — and the
    raised message still distinguishes the two.  Accepts numpy arrays and
    tensors.  Raises :class:`OutputValidationError`; returns ``None`` on
    clean outputs.
    """
    if sizes is not None and len(outs) != len(sizes):
        raise OutputValidationError(
            f"expected {len(sizes)} projection outputs; got {len(outs)}"
        )
    for i, z in enumerate(outs):
        arr = z.detach().cpu().numpy() if isinstance(z, torch.Tensor) else np.asarray(z)
        want = (steps, batch) if sizes is None else (steps, batch, sizes[i])
        if arr.ndim != 3 or arr.shape[: len(want)] != want:
            raise OutputValidationError(
                f"projection {i}: expected (T, B, n_target) shape starting "
                f"{want}; got {arr.shape}"
            )
        if arr.dtype != np.float32:
            raise OutputValidationError(
                f"projection {i}: expected float32 spikes; got {arr.dtype}"
            )
        if not bool(np.all((arr == 0.0) | (arr == 1.0))):
            kind = (
                "non-finite" if not bool(np.all(np.isfinite(arr)))
                else "non-binary"
            )
            raise OutputValidationError(
                f"projection {i}: {kind} entries in the output spike train"
            )


def _matches_network(exe: NetworkExecutable, net: SNNNetwork) -> bool:
    """Does the cached executable still reflect the net's graph and LIF?"""
    if len(exe.metas) != len(net.layers):
        return False
    try:
        plan = _graph_plan(net)
    except (ValueError, KeyError):
        return False
    if plan != exe.plan:
        return False
    return all(
        meta.n_source == layer.n_source
        and meta.n_target == layer.n_target
        for meta, layer in zip(exe.metas, net.layers)
    )


def network_executable(
    net: SNNNetwork,
    report: CompileReport,
    *,
    device=None,
) -> NetworkExecutable:
    """The report's cached fused executable, (re)building when stale.

    A cached executable on another device than ``device`` counts as stale.
    """
    dev = resolve_device(device)
    exe = report.executable
    if exe is None or exe.device != dev or not _matches_network(exe, net):
        exe = NetworkExecutable.build(net, report, device=dev)
        report.executable = exe
    return exe


def release_network_executable(report: CompileReport) -> int:
    """Drop the report's fused executable and every per-layer lowering.

    Returns the number of cache slots cleared.  The next
    ``network_executable`` call on this report re-lowers from the compiled
    programs.
    """
    cleared = 0
    if report.executable is not None:
        report.executable = None
        cleared += 1
    for compiled in report.layers:
        if compiled.executable is not None:
            compiled.executable = None
            cleared += 1
    return cleared
