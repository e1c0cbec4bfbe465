"""Table I DTCM cost models, byte-exact.

Every formula below is a row of Table I of the paper.  Each function returns a
dict of item -> bytes so benchmarks can print the table and tests can pin
individual rows.

Interpretation notes (documented in DESIGN.md §2 "assumptions changed"):

* ``n_neuron`` in the serial rows is the PE's *target sub-population* size;
  source neurons appear through the synaptic-matrix row count and the
  address-list length (one block per source neuron, paper §III-A).
* The parallel-dominant row "neuron and synapse model" is printed in the paper
  as ``(32/8)*n_neuron*n_neuron*max_connected_rate`` — a literal copy of the
  serial synaptic-matrix row.  With that reading no dominant PE could ever fit
  a >20%-dense 500-neuron layer in 96 kB, contradicting the paper's own §IV-A
  claim that one dominant PE always suffices on the dataset grid.  We use the
  LIF parameter row ``(32/8)*n_param`` (as in the serial column) instead and
  verify the paper's "one dominant PE is enough" claim as a test.
* DRAM is excluded (paper §IV-A): the DMA-buffer row is 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .hw import SpiNNaker2Config, DEFAULT_S2


def serial_pe_cost(
    n_tgt_pe: int,
    n_src_pe: int,
    density: float,
    delay_range: int,
    n_source_vertex: int,
    *,
    hw: SpiNNaker2Config = DEFAULT_S2,
    n_projection_type: int = 2,
    matrix_split: int = 1,
) -> Dict[str, float]:
    """Serial-paradigm DTCM bytes for one PE (Table I, upper block).

    ``matrix_split`` divides only the synaptic matrix (the paper distributes
    the matrix across 2-4 adjacent PEs when dense; all other structures are
    replicated on each of those PEs).
    """
    synaptic_matrix = (32 / 8) * n_src_pe * n_tgt_pe * density / matrix_split
    return {
        "input_spike_buffer": (32 / 8) * n_tgt_pe,
        "dma_buffer": 0.0,  # DRAM not involved
        "master_population_table": (96 / 8) * n_source_vertex,
        "address_list": (32 / 8) * n_src_pe,  # one block row per source neuron
        "synaptic_matrix": synaptic_matrix,
        "synaptic_input_buffer": (16 / 8) * n_tgt_pe * delay_range * n_projection_type,
        "neuron_synapse_model": (32 / 8) * hw.lif_n_params,
        "output_recording": (32 / 8) * (math.ceil(n_tgt_pe / 32) + 1)
        + (32 / 8) * n_tgt_pe * 3,
        "stack_heap": (96 / 8) * n_source_vertex,
        "os": float(hw.os_overhead_bytes),
    }


def serial_pe_overhead(
    n_tgt_pe: int,
    n_src_pe: int,
    delay_range: int,
    n_source_vertex: int,
    *,
    hw: SpiNNaker2Config = DEFAULT_S2,
    n_projection_type: int = 2,
) -> float:
    """Everything except the synaptic matrix (used to size the matrix split)."""
    cost = serial_pe_cost(
        n_tgt_pe, n_src_pe, 0.0, delay_range, n_source_vertex,
        hw=hw, n_projection_type=n_projection_type,
    )
    return float(sum(cost.values()))


def parallel_dominant_cost(
    n_source: int,
    n_target: int,
    delay_range: int,
    n_source_vertex: int,
    *,
    hw: SpiNNaker2Config = DEFAULT_S2,
) -> Dict[str, float]:
    """Parallel-paradigm dominant-PE DTCM bytes (Table I, middle block)."""
    return {
        "input_spike_buffer": (32 / 8) * n_source,
        "reversed_order": (32 / 16) * n_source * delay_range,
        "input_merging_table": n_source * delay_range * 3,
        "stacked_input": n_source * delay_range * 4,
        # Paper typo corrected: LIF parameter block, not the synaptic matrix.
        "neuron_synapse_model": (32 / 8) * hw.lif_n_params,
        "output_recording": (32 / 8) * n_target * 4,
        "stack_heap": (96 / 8) * n_source_vertex,
        "os": float(hw.os_overhead_bytes),
    }


def parallel_subordinate_overhead(
    n_tgt_pe: int,
    delay_range: int,
    n_source_vertex: int,
    *,
    hw: SpiNNaker2Config = DEFAULT_S2,
    n_projection_type: int = 2,
) -> Dict[str, float]:
    """Parallel subordinate DTCM bytes, *excluding* the weight-delay-map.

    The WDM row is "(can't be accurately estimated)" in Table I — the
    compiler measures it (:mod:`repro_torch.core.parallel_compiler`).
    """
    return {
        "output_recording": (16 / 8) * n_tgt_pe * delay_range * n_projection_type,
        "stack_heap": (96 / 8) * n_source_vertex,
        "os": float(hw.os_overhead_bytes),
    }


def total(cost: Dict[str, float]) -> float:
    return float(sum(cost.values()))


# --- serial-paradigm batch crossover (accelerator adaptation) ---------------
#
# Not a Table-I row: this models the *JAX runtime* cost of the two serial
# kernel forms so the fused executor can pick per batch size.  The
# event-driven form is one flat ``(B*R)`` ``segment_sum`` scatter — work
# proportional to synaptic rows, but with poor locality that degrades
# super-linearly in batch on the host backend (the segment-id space grows as
# ``B * d_slots * n_target``).  The dense fallback is a ``(B,S) x (S,
# d_slots*T)`` matmul — ``d_slots/density`` times more MACs, each far
# cheaper and perfectly batched.  Dense wins once
# ``batch^exponent * density`` crosses ``(mac/scatter) * d_slots``.


@dataclasses.dataclass(frozen=True)
class SerialBatchCostModel:
    """Relative per-timestep cost of the serial paradigm's two kernel forms.

    Coefficients are unitless ratios fitted to the CPU batch-scaling sweep
    in ``benchmarks/bench_network.py`` (``BENCH_network.json`` records the
    measured curves next to the model's decisions so drift is visible);
    they deliberately err toward the event form at batch 1 so solo
    requests keep the paper's event-driven semantics on the hot path.

    * ``scatter_coeff`` — cost of one scattered ``(batch, row)`` element
      relative to one dense MAC (random-access accumulate vs FMA).
    * ``batch_exponent`` — super-linearity of the flat segment-sum in
      batch (1.0 = perfectly linear; measured ~1.5 on the CPU backend).
    * ``mac_coeff`` — cost of one dense MAC (the unit).
    * ``gather_coeff`` — cost of one gathered ELL element in the *sparse*
      form (:func:`repro_torch.core.runtime.serial_project_sparse`) relative to
      one dense MAC.  The gather reads are batch-contiguous (each ELL row
      gathers whole ``(B,)`` lanes), so unlike the scatter it scales
      *linearly* in batch — pricier per element than a MAC
      (``gather > mac``) but cheaper than a scattered accumulate at
      batch >= 2 (``gather < scatter * B^(exponent-1)``).
    * ``dense_element_cap`` — largest ``S * d_slots * T`` the dense form
      may materialize; above it dense is excluded from
      :meth:`choose_form` outright (mirrors
      ``repro_torch.core.layer.DENSE_ELEMENT_CAP`` — a projection that only
      fits sparse must never pick the form that would densify it).

    Temporal-parallel constants (the fourth, whole-train form of
    :meth:`choose_form` — only competing when the caller supplies a step
    count):

    * ``temporal_coeff`` — cost of one whole-train contraction element
      (per step, per dense MAC) in the temporal form.  The contraction
      does the same MACs as the dense per-step form but batched over all
      T steps at once, so the fitted value is typically < ``mac_coeff``.
    * ``temporal_base`` — fixed per-launch cost of the temporal path
      (reset resolution, shifts), amortized over the step count.
    * ``step_coeff`` — per-timestep dispatch overhead of the sequential
      scan that the temporal form *avoids*; it is added to the serial
      side of the temporal-vs-serial comparison only, never to the
      three-way serial argmin, so existing serial decisions are
      untouched.  Deliberately conservative by default: with equal
      operand costs the default constants only pick temporal beyond
      ``temporal_base / step_coeff`` = 256 steps, about an order of
      magnitude above the crossover ``benchmarks/bench_temporal.py``
      measures on the CPU backend (temporal already wins at T = 16
      there).
    """

    scatter_coeff: float = 16.0
    batch_exponent: float = 1.5
    mac_coeff: float = 1.0
    gather_coeff: float = 24.0
    dense_element_cap: int = 2 ** 24
    temporal_coeff: float = 1.0
    temporal_base: float = 16384.0
    step_coeff: float = 64.0

    def event_cost(self, n_rows: int, batch: int) -> float:
        """Relative cost of one event-form timestep at this batch."""
        return self.scatter_coeff * n_rows * float(batch) ** self.batch_exponent

    def dense_cost(
        self, n_source: int, n_target: int, delay_range: int, batch: int
    ) -> float:
        """Relative cost of one dense-form timestep at this batch."""
        return self.mac_coeff * batch * n_source * (delay_range + 1) * n_target

    def sparse_cost(self, n_rows: int, batch: int) -> float:
        """Relative cost of one sparse (ELL gather) timestep at this batch."""
        return self.gather_coeff * n_rows * float(batch)

    def dense_fits(
        self, n_source: int, n_target: int, delay_range: int
    ) -> bool:
        """May the dense ``(d_slots, S, T)`` operand be materialized at all?"""
        return (
            n_source * (delay_range + 1) * n_target <= self.dense_element_cap
        )

    def temporal_cost(
        self,
        n_rows: int,
        n_source: int,
        n_target: int,
        delay_range: int,
        batch: int,
        steps: int,
    ) -> float:
        """Relative per-timestep cost of the whole-train temporal form.

        The projection runs either as one dense ``(T,B,S) x (d,S,N)``
        contraction or as the ELL gather vmapped over time — per step
        that is the dense/sparse element count scaled by
        ``temporal_coeff``/``gather_coeff`` — plus the fixed per-launch
        reset-resolution cost amortized over the step count.
        """
        sparse = self.gather_coeff * n_rows * float(batch)
        cost = sparse
        if self.dense_fits(n_source, n_target, delay_range):
            dense = (
                self.temporal_coeff
                * batch * n_source * (delay_range + 1) * n_target
            )
            cost = min(cost, dense)
        return cost + self.temporal_base / float(max(1, steps))

    def temporal_operand(
        self,
        n_rows: int,
        n_source: int,
        n_target: int,
        delay_range: int,
        batch: int,
    ) -> str:
        """Cheaper whole-train operand: ``"dense"`` einsum or ``"sparse"``
        (ELL gather vmapped over time).  Over the element cap the dense
        operand may not exist, so sparse is forced."""
        if not self.dense_fits(n_source, n_target, delay_range):
            return "sparse"
        dense = (
            self.temporal_coeff
            * batch * n_source * (delay_range + 1) * n_target
        )
        return "dense" if dense <= self.gather_coeff * n_rows * batch else "sparse"

    def prefer_dense(
        self,
        n_rows: int,
        n_source: int,
        n_target: int,
        delay_range: int,
        batch: int,
    ) -> bool:
        """Should ``serial_step`` switch to the dense matmul form?

        The legacy *two-way* (event vs dense) question; kept because its
        crossover algebra (:meth:`crossover_batch`) is pinned by tests and
        refit by ``tools/fit_cost_model.py``.  The executor itself asks
        the three-way :meth:`choose_form`.
        """
        if n_rows == 0:
            return False         # empty layer: nothing to scatter
        return self.event_cost(n_rows, batch) > self.dense_cost(
            n_source, n_target, delay_range, batch
        )

    def choose_form(
        self,
        n_rows: int,
        n_source: int,
        n_target: int,
        delay_range: int,
        batch: int,
        steps: int | None = None,
        allow_temporal: bool = True,
    ) -> str:
        """Cheapest serial kernel form: ``"event"``, ``"sparse"``,
        ``"dense"`` — or ``"temporal"`` when a step count is supplied.

        Without ``steps`` (the per-timestep callers) the decision is the
        exact three-way argmin it has always been.  With ``steps`` the
        whole-train temporal form competes as a fourth candidate: it wins
        only when its amortized per-step cost beats the best serial form
        *plus* the per-step scan overhead the serial forms pay
        (``step_coeff``) — the overhead never enters the serial forms'
        own comparison, so the three-way outcome is unchanged by the
        temporal constants.  Back-edge projections must pass
        ``allow_temporal=False``: their rings are inherently step-serial.

        All forms are bit-identical on outputs (integer weights,
        exact float32 accumulation), so this is purely a throughput
        argmin.  Structure of the three-way space:

        * batch 1 — event wins (``scatter < gather`` per element and the
          scatter's super-linearity hasn't kicked in yet).
        * growing batch at fixed density — sparse overtakes event (linear
          vs ``B^1.5``), then dense overtakes sparse iff the layer is
          dense enough: ``dense < sparse`` ⇔ ``d_slots / density <
          gather_coeff``.
        * the choice is *monotone in density* at fixed batch: more rows
          per dense element only ever moves the argmin toward dense.
        * layers over :attr:`dense_element_cap` never pick dense — the
          operand physically shouldn't exist.

        Ties break toward the cheaper-memory form (event < sparse <
        dense).
        """
        if n_rows == 0:
            return "event"       # nothing to scatter, gather, or multiply
        costs = [
            ("event", self.event_cost(n_rows, batch)),
            ("sparse", self.sparse_cost(n_rows, batch)),
        ]
        if self.dense_fits(n_source, n_target, delay_range):
            costs.append(
                ("dense", self.dense_cost(n_source, n_target, delay_range, batch))
            )
        best = min(costs, key=lambda fc: fc[1])
        if steps is None or not allow_temporal:
            return best[0]
        tc = self.temporal_cost(
            n_rows, n_source, n_target, delay_range, batch, steps
        )
        if tc < best[1] + self.step_coeff:
            return "temporal"
        return best[0]

    def crossover_batch(
        self, n_rows: int, n_source: int, n_target: int, delay_range: int
    ) -> float:
        """Smallest batch at which the dense form wins (``inf`` if never).

        Solves ``event_cost(batch) == dense_cost(batch)``; because both
        sides share a factor of ``batch``, the crossover depends on
        ``batch^(exponent-1)`` against ``(mac/scatter) * (d_slots /
        density)`` — i.e. the denser the layer (higher row *rate* per
        dense element), the earlier dense wins.
        """
        if n_rows == 0:
            return math.inf
        ratio = (
            self.mac_coeff * n_source * (delay_range + 1) * n_target
        ) / (self.scatter_coeff * n_rows)
        if self.batch_exponent <= 1.0:
            return 1.0 if ratio < 1.0 else math.inf
        return max(1.0, ratio ** (1.0 / (self.batch_exponent - 1.0)))


    # -- refitting from measured sweeps --------------------------------------
    @classmethod
    def fit_from_sweep(
        cls,
        points,                 # [{"batch": b, "event_us": e, "dense_us": d}]
        *,
        n_rows_total: int,
        dense_macs_per_batch: int,
    ) -> "SerialBatchCostModel":
        """Refit the constants from a measured event/dense batch sweep.

        ``points`` are per-batch wall-clock measurements of the two serial
        kernel forms over the SAME network (``benchmarks/bench_network.py
        run_batch_sweep`` produces them); ``n_rows_total`` is the summed
        synaptic-row count of its serial layers and
        ``dense_macs_per_batch`` the summed ``n_source * (delay_range+1) *
        n_target`` dense MACs.  The fit keeps ``mac_coeff`` as the unit
        and solves the other two in log space:

        * ``batch_exponent`` — least-squares slope of ``log(event_us)``
          on ``log(batch)`` (the event form's measured super-linearity).
        * ``scatter_coeff`` — chosen so the model's event/dense cost
          ratio matches the measured time ratio on average, i.e. the
          predicted crossover batch tracks where the measured curves
          actually cross on the current backend.
        """
        pts = [p for p in points if p["batch"] >= 1]
        if len(pts) < 2:
            raise ValueError("need at least two sweep points to fit")
        if n_rows_total <= 0 or dense_macs_per_batch <= 0:
            raise ValueError("row/MAC totals must be positive")
        if any(p["event_us"] <= 0 or p["dense_us"] <= 0 for p in pts):
            raise ValueError(
                "sweep timings must be positive (corrupt or underflowed "
                "batch_sweep point?)"
            )
        logb = [math.log(p["batch"]) for p in pts]
        loge = [math.log(p["event_us"]) for p in pts]
        bbar = sum(logb) / len(pts)
        ebar = sum(loge) / len(pts)
        denom = sum((b - bbar) ** 2 for b in logb)
        if denom == 0:
            raise ValueError("sweep points must span multiple batch sizes")
        exponent = sum(
            (b - bbar) * (e - ebar) for b, e in zip(logb, loge)
        ) / denom
        exponent = max(1.0, exponent)
        # log scatter = mean_b [ log(event/dense) + log(M*b) - log(R*b^p) ]
        log_scatter = sum(
            math.log(p["event_us"] / p["dense_us"])
            + math.log(dense_macs_per_batch * p["batch"])
            - math.log(n_rows_total * p["batch"] ** exponent)
            for p in pts
        ) / len(pts)
        return cls(
            scatter_coeff=math.exp(log_scatter),
            batch_exponent=exponent,
            mac_coeff=1.0,
        )

    def fit_gather_from_sweep(
        self,
        points,              # [{"batch": b, "event_us": e, "sparse_us": s}]
    ) -> "SerialBatchCostModel":
        """Refit ``gather_coeff`` from a measured event/sparse sweep.

        ``points`` compare the event and sparse kernel forms on the SAME
        rows (``benchmarks/bench_sparse.py`` records them in
        ``BENCH_network.json.sparse_sweep``); both costs share the factor
        ``n_rows``, so the coefficient falls straight out of the time
        ratio: ``gather = scatter * batch^(exponent-1) *
        geomean(sparse_us / event_us)``.  Other constants are untouched.
        """
        pts = [
            p for p in points
            if p.get("event_us", 0) > 0 and p.get("sparse_us", 0) > 0
        ]
        if not pts:
            raise ValueError("need at least one event/sparse sweep point")
        log_ratio = sum(
            math.log(p["sparse_us"] / p["event_us"])
            + (self.batch_exponent - 1.0) * math.log(p["batch"])
            for p in pts
        ) / len(pts)
        return dataclasses.replace(
            self, gather_coeff=self.scatter_coeff * math.exp(log_ratio)
        )

    def fit_temporal_from_sweep(
        self,
        points,              # [{"steps": T, "fused_us": f, "temporal_us": u}]
        *,
        dense_macs_per_batch: int,
        batch: int,
    ) -> "SerialBatchCostModel":
        """Refit the temporal constants from a measured T-sweep.

        ``points`` time the fused per-step scan against the whole-train
        temporal path over the SAME network at several step counts
        (``benchmarks/bench_temporal.py`` records them in
        ``BENCH_network.json.temporal_sweep``).  Both curves are
        ~affine in T, so two least-squares lines
        ``fused_us ~ f0 + f1*T`` and ``temporal_us ~ g0 + g1*T`` give:

        * ``temporal_coeff = mac_coeff * g1/f1`` — marginal per-step cost
          ratio, mapped onto the dense MAC unit;
        * ``temporal_base = g0 * M / f1`` — the temporal launch intercept
          in cost units (M = dense MACs per step at this batch);
        * ``step_coeff = max(0, (f1 - g1) * M / f1)`` — the per-step
          overhead the scan pays and the temporal form avoids.
        """
        pts = [
            p for p in points
            if p.get("fused_us", 0) > 0 and p.get("temporal_us", 0) > 0
        ]
        if len(pts) < 2:
            raise ValueError("need at least two temporal sweep points")
        if dense_macs_per_batch <= 0 or batch <= 0:
            raise ValueError("MAC total and batch must be positive")

        def slope_intercept(ys):
            xs = [float(p["steps"]) for p in pts]
            xbar = sum(xs) / len(xs)
            ybar = sum(ys) / len(ys)
            denom = sum((x - xbar) ** 2 for x in xs)
            if denom == 0:
                raise ValueError("sweep points must span multiple step counts")
            s = sum(
                (x - xbar) * (y - ybar) for x, y in zip(xs, ys)
            ) / denom
            return s, ybar - s * xbar

        f1, _f0 = slope_intercept([p["fused_us"] for p in pts])
        g1, g0 = slope_intercept([p["temporal_us"] for p in pts])
        if f1 <= 0 or g1 <= 0:
            raise ValueError("sweep slopes must be positive")
        macs = float(dense_macs_per_batch) * batch
        # 1 cost unit  <->  f1 / (mac_coeff * macs) microseconds per step
        unit_us = f1 / (self.mac_coeff * macs)
        return dataclasses.replace(
            self,
            temporal_coeff=self.mac_coeff * g1 / f1,
            temporal_base=max(0.0, g0) / unit_us,
            step_coeff=max(0.0, f1 - g1) / unit_us,
        )

    def as_dict(self) -> Dict[str, float]:
        return {
            "scatter_coeff": self.scatter_coeff,
            "batch_exponent": self.batch_exponent,
            "mac_coeff": self.mac_coeff,
            "gather_coeff": self.gather_coeff,
            "dense_element_cap": float(self.dense_element_cap),
            "temporal_coeff": self.temporal_coeff,
            "temporal_base": self.temporal_base,
            "step_coeff": self.step_coeff,
        }


#: Default crossover model used by the fused executor; fitted to the
#: CPU batch sweep (see ``BENCH_network.json`` -> ``batch_sweep``);
#: ``tools/fit_cost_model.py`` refits these constants from the recorded
#: sweep whenever the backend changes.
DEFAULT_SERIAL_BATCH_COST = SerialBatchCostModel()


def equal_parts(n: int, cap: int) -> list:
    """Split ``n`` items into ceil(n/cap) equal parts (paper: "equally split").

    Returns the part sizes, e.g. equal_parts(500, 255) == [250, 250].
    """
    if n <= 0:
        raise ValueError("n must be positive")
    k = math.ceil(n / cap)
    base, rem = divmod(n, k)
    return [base + 1] * rem + [base] * (k - rem)
