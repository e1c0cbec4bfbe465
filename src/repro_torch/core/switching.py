"""The fast-switching compiling system — paper §IV.

Policies:

* ``serial`` / ``parallel`` — the two pure paradigms.
* ``ideal``      — compile BOTH paradigms per layer and keep the smaller
  (the oracle of Fig 5; doubles compile work and host RAM).
* ``classifier`` — the paper's contribution: a trained classifier prejudges
  the winning paradigm from the 4 layer characters BEFORE compiling, so only
  one compilation runs per layer (layer-granularity switching, Fig 2).

Compilation is **per projection**: the layer character is a property of one
projection (edge of the application graph), so arbitrary graphs — fan-in,
skip connections, recurrent back-edges — compile through the exact same
prejudging flow as feed-forward chains, one ``CompiledLayer`` per
projection in declaration order.

``CompileReport`` tracks the two costs the paper optimizes on the host —
number of paradigm compilations and peak host RAM holding compiled
artifacts — plus the PE occupation on SpiNNaker2.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from .. import trace
from .classifiers import AdaBoostClassifier, Classifier
from .dataset import LABEL_PARALLEL, LABEL_SERIAL, ParadigmDataset
from .hw import SpiNNaker2Config, DEFAULT_S2
from .layer import DENSE_ELEMENT_CAP, SNNLayer, SNNNetwork, is_sparse
from .parallel_compiler import OptFlags, ParallelProgram, compile_parallel
from .serial_compiler import SerialProgram, compile_serial

PARADIGM_NAMES = {LABEL_SERIAL: "serial", LABEL_PARALLEL: "parallel"}


def over_dense_cap(layer) -> bool:
    """True for a CSR projection whose dense ``(S, T)`` form would exceed
    :data:`~repro_torch.core.layer.DENSE_ELEMENT_CAP`: the parallel compiler
    densifies, so such a projection can only compile serial."""
    return is_sparse(layer) and layer.n_source * layer.n_target > DENSE_ELEMENT_CAP


def _program_host_bytes(program) -> int:
    """Host-RAM proxy: bytes of compiled artifacts held for loading."""
    if isinstance(program, SerialProgram):
        return int(
            sum(
                c.synaptic_rows.nbytes
                + c.address_list.nbytes
                + c.master_population_table.nbytes
                for c in program.cells
            )
        )
    if isinstance(program, ParallelProgram):
        return int(
            sum(s.matrix.nbytes + s.col_sources.nbytes for s in program.slices)
        )
    raise TypeError(type(program))


@dataclasses.dataclass
class CompiledLayer:
    layer_name: str
    paradigm: str            # "serial" | "parallel"
    predicted_label: int
    program: object          # SerialProgram | ParallelProgram
    pe_count: int
    n_compilations: int      # 1 for prejudged, 2 for ideal
    host_bytes_peak: int     # artifacts resident while deciding
    compile_seconds: float
    #: True where the projection compiled serial only because its dense
    #: form is over the cap (:func:`over_dense_cap`), whatever the policy
    #: would have chosen; ``predicted_label`` keeps the classifier's label.
    forced: bool = False
    #: Lowered runtime executable (SerialExecutable | ParallelExecutable),
    #: attached lazily by :mod:`repro_torch.core.runtime.executor` so each program
    #: is lowered exactly once per report however many times it runs.
    executable: object = dataclasses.field(
        default=None, repr=False, compare=False
    )


@dataclasses.dataclass
class CompileReport:
    layers: List[CompiledLayer]
    #: Cached :class:`repro_torch.core.runtime.executor.NetworkExecutable` for the
    #: whole report (attached lazily; reused across ``run_network`` calls).
    executable: object = dataclasses.field(
        default=None, repr=False, compare=False
    )
    #: Which serial kernel form the fused executor ran, recorded per launch
    #: shape: ``{(path, batch): (form per layer, ...)}`` with ``path`` in
    #: ``{"fused", "temporal"}`` and form ``"event"`` | ``"sparse"`` |
    #: ``"dense"`` for serial layers, ``"-"`` for parallel ones, and
    #: ``"temporal"`` | ``"temporal_sparse"`` for whole-train ones.  The
    #: three-way form choice
    #: (:meth:`repro_torch.core.cost_model.SerialBatchCostModel.choose_form`)
    #: only ever changes which form runs, never the spike trains — this
    #: record is how tests and benchmarks observe the decision.
    serial_forms: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    #: The :class:`repro.placement.DeviceAssignment` the executable was
    #: sharded with (``shard(assignment=...)``), or ``None`` when no
    #: placement-driven sharding happened.  On single-device CI this is
    #: the identity assignment — recorded all the same, so the full
    #: placement -> sharding path is observable without hardware.
    placement: object = dataclasses.field(
        default=None, repr=False, compare=False
    )
    #: The :class:`repro_torch.core.runtime.profiler.ActivityProfile` of the
    #: last profiled run (attached by
    #: :func:`repro_torch.core.runtime.profiler.profile_run`), or ``None`` when
    #: no run was profiled.  Its per-population rates feed the placement
    #: engine's measured-traffic estimates and activity budget checks.
    activity: object = dataclasses.field(
        default=None, repr=False, compare=False
    )
    #: Temporal-parallel launch records, ``{(batch, steps):
    #: repro_torch.core.runtime.temporal_runtime.TemporalReport}``.  Each
    #: ``run_temporal`` launch records its feed-forward/step-serial
    #: split, the reset-resolution mode per population, and — for
    #: iterative populations — the fixed-point pass count and residual
    #: (spike flips between the final two passes; 0 whenever the loop
    #: converged before the ``max_iters`` cap).
    temporal: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def total_pes(self) -> int:
        return sum(l.pe_count for l in self.layers)

    @property
    def total_compilations(self) -> int:
        return sum(l.n_compilations for l in self.layers)

    @property
    def host_bytes_peak(self) -> int:
        return sum(l.host_bytes_peak for l in self.layers)

    @property
    def compile_seconds(self) -> float:
        return sum(l.compile_seconds for l in self.layers)

    @property
    def cap_fallbacks(self) -> int:
        """Projections compiled serial because of the dense cap."""
        return sum(l.forced for l in self.layers)


def temporal_character(layer) -> dict:
    """Temporal-parallel eligibility features for the switching surface.

    Extends the paper's 4-factor :class:`~repro_torch.core.layer.LayerCharacter`
    with what the third ("temporal") paradigm needs to prejudge a layer:
    which reset-resolution mode it would run under
    (:func:`repro_torch.core.runtime.temporal_runtime.choose_temporal_mode`)
    and whether that mode is exact — exact layers cost one whole-train
    pass, iterative layers a convergence loop, which is the feature the
    classifier (and :meth:`SerialBatchCostModel.choose_form
    <repro_torch.core.cost_model.SerialBatchCostModel.choose_form>` with a step
    count) weighs against the per-step scan overhead.  Works for dense
    layers and CSR :class:`~repro_torch.core.layer.SparseProjection` alike.
    """
    from .runtime.temporal_runtime import choose_temporal_mode

    weights = getattr(layer, "values", None)
    if weights is None:
        weights = layer.weights
    nonneg = bool(np.all(np.asarray(weights) >= 0))
    lif = layer.lif
    mode = choose_temporal_mode(
        float(lif.alpha), float(lif.v_th), nonneg_weights=nonneg
    )
    return {
        "character": layer.character(),
        "mode": mode,
        "exact": mode in ("alpha0", "count"),
        "nonneg_weights": nonneg,
    }


class SwitchingCompiler:
    """Layer-granularity paradigm switching (Fig 2, right panel)."""

    def __init__(
        self,
        policy: str = "classifier",
        classifier: Optional[Classifier] = None,
        *,
        hw: SpiNNaker2Config = DEFAULT_S2,
        opts: OptFlags = OptFlags(),
    ):
        if policy not in ("serial", "parallel", "ideal", "classifier"):
            raise ValueError(f"unknown policy {policy!r}")
        if policy == "classifier" and classifier is None:
            raise ValueError("classifier policy needs a trained classifier")
        self.policy = policy
        self.classifier = classifier
        self.hw = hw
        self.opts = opts

    # -- per-layer -----------------------------------------------------------
    def compile_layer(self, layer: SNNLayer) -> CompiledLayer:
        """Compile one projection under the policy.  Under ``classifier``
        and ``ideal`` a projection over the dense cap compiles serial
        (``forced``); an explicit ``parallel`` policy still raises
        :class:`~repro_torch.core.layer.DenseStorageError` on it."""
        with trace.span("switching.compile_layer") as sp:
            if sp:
                sp.set(name=layer.name)
            compiled = self._compile_layer(layer)
            if sp:
                prog = compiled.program
                sp.set(paradigm=compiled.paradigm,
                       predicted=compiled.predicted_label,
                       forced=compiled.forced, n_synapses=layer.n_synapses,
                       n_cells=len(prog.cells if isinstance(prog, SerialProgram)
                                   else prog.slices))
            if compiled.forced:
                trace.count("switching.cap_fallbacks")
        return compiled

    def _compile_layer(self, layer: SNNLayer) -> CompiledLayer:
        t0 = time.perf_counter()
        if self.policy == "serial":
            prog = compile_serial(layer, hw=self.hw)
            return self._wrap(layer, LABEL_SERIAL, prog, 1,
                              _program_host_bytes(prog), t0)
        if self.policy == "parallel":
            prog = compile_parallel(layer, hw=self.hw, opts=self.opts)
            return self._wrap(layer, LABEL_PARALLEL, prog, 1,
                              _program_host_bytes(prog), t0)
        forced = over_dense_cap(layer)
        if self.policy == "ideal":
            sp = compile_serial(layer, hw=self.hw)
            if forced:
                return self._wrap(layer, LABEL_SERIAL, sp, 1,
                                  _program_host_bytes(sp), t0, forced=True)
            pp = compile_parallel(layer, hw=self.hw, opts=self.opts)
            peak = _program_host_bytes(sp) + _program_host_bytes(pp)
            label = (
                LABEL_PARALLEL if pp.pe_count < sp.pe_count else LABEL_SERIAL
            )
            prog = pp if label == LABEL_PARALLEL else sp
            return self._wrap(layer, label, prog, 2, peak, t0)
        # classifier: prejudge from the 4 characters, compile once
        feats = layer.character().as_features()[None, :]
        predicted = int(self.classifier.predict(feats)[0])
        label = LABEL_SERIAL if forced else predicted
        if label == LABEL_PARALLEL:
            prog = compile_parallel(layer, hw=self.hw, opts=self.opts)
        else:
            prog = compile_serial(layer, hw=self.hw)
        return self._wrap(layer, label, prog, 1, _program_host_bytes(prog), t0,
                          predicted=predicted,
                          forced=forced and predicted == LABEL_PARALLEL)

    def _wrap(self, layer, label, prog, n_compiles, peak, t0, *,
              predicted=None, forced=False) -> CompiledLayer:
        return CompiledLayer(
            layer_name=layer.name,
            paradigm=PARADIGM_NAMES[label],
            predicted_label=label if predicted is None else predicted,
            program=prog,
            pe_count=prog.pe_count,
            n_compilations=n_compiles,
            host_bytes_peak=peak,
            compile_seconds=time.perf_counter() - t0,
            forced=forced,
        )

    # -- whole network -------------------------------------------------------
    def compile_network(self, net: SNNNetwork) -> CompileReport:
        """One ``CompiledLayer`` per projection, in declaration order.

        Works for chains and arbitrary application graphs alike —
        prejudging only reads the per-projection character, never the
        topology.
        """
        return CompileReport([self.compile_layer(l) for l in net.layers])


def train_switch_classifier(
    dataset: ParadigmDataset,
    *,
    classifier: Optional[Classifier] = None,
    test_fraction: float = 0.2,
    seed: int = 0,
):
    """Train the prejudging classifier (AdaBoost by default, as the paper).

    Returns (classifier, test_accuracy).
    """
    clf = classifier or AdaBoostClassifier(seed=seed)
    (Xtr, ytr), (Xte, yte) = dataset.split(test_fraction, seed=seed)
    clf.fit(Xtr, ytr)
    return clf, clf.score(Xte, yte)


def average_pes_by_delay(
    dataset: ParadigmDataset, predictions: np.ndarray
) -> dict:
    """Fig 5: mean PEs per delay range under a given per-layer paradigm choice.

    ``predictions`` holds 0/1 labels for every dataset row; the realized PE
    count is the compiled count of the chosen paradigm (from the dataset).
    """
    chosen = np.where(
        predictions == LABEL_PARALLEL, dataset.parallel_pes, dataset.serial_pes
    )
    delays = dataset.features[:, 3].astype(int)
    out = {}
    for d in np.unique(delays):
        out[int(d)] = float(chosen[delays == d].mean())
    return out
