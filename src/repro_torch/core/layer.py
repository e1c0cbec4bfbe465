"""SNN model abstractions: layer characters, layers, and the application graph.

Terminology follows the paper (§III):

* **application graph** — :class:`Population` vertices connected by
  :class:`Projection` edges (synaptic connections between populations).
  :class:`SNNNetwork` is that graph: it validates shapes, topologically
  orders the forward edges, and identifies **back-edges** (self-loops and
  projections onto earlier populations) which the runtime routes through
  a one-step-delayed feedback path.
* **layer character** — the 4-tuple the classifier sees:
  (n_source, n_target, weight_density, delay_range).  This is all the
  switching system may look at *before* compiling (paper §IV-B).  The
  character is a **per-projection** property, so the switching system
  prejudges arbitrary graphs exactly as it prejudges chains.
* **machine graph** — sub-populations mapped onto PEs; produced by the
  paradigm compilers in :mod:`repro_torch.core.serial_compiler` /
  :mod:`repro_torch.core.parallel_compiler`, one program per projection.

The feed-forward chain the paper evaluates is the special case with one
projection between each pair of consecutive populations; the chain
constructor (``SNNNetwork(layers=[...])``) and :func:`feedforward_network`
remain as thin builders over the graph form and produce bit-identical
runtime behavior.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from .hw import BudgetExceeded

#: Largest ``n_source * n_target`` a *dense* ``(S, T)`` weight matrix may
#: materialize (2**24 elements = 64 MiB of float32 per array, weights and
#: delays each).  Beyond this the dense representation is the memory cliff
#: the sparse storage exists to avoid — a SpiNNCer-scale network (97k
#: neurons, ~0.04 % density) is physically unrepresentable densely —
#: so :func:`random_layer` / :func:`densify` raise
#: :class:`DenseStorageError` instead of silently OOMing.  Pass
#: ``max_elements=`` to raise the cap deliberately.
DENSE_ELEMENT_CAP = 2 ** 24


class DenseStorageError(BudgetExceeded):
    """A dense ``(S, T)`` weight matrix would exceed the element cap.

    The fix is almost always sparse storage
    (:class:`SparseProjection` / :func:`random_sparse_projection`), which
    holds only the nonzero synapses in CSR form; ``max_elements=`` raises
    the cap for callers that genuinely want the dense array.
    """


def _check_dense_budget(
    n_source: int, n_target: int, max_elements: Optional[int], what: str
) -> None:
    cap = DENSE_ELEMENT_CAP if max_elements is None else int(max_elements)
    if n_source * n_target > cap:
        raise DenseStorageError(
            f"{what}: dense ({n_source}, {n_target}) storage is "
            f"{n_source * n_target} elements, over the {cap}-element cap "
            f"— use sparse storage (random_sparse_projection / "
            f"SparseProjection.from_dense) or pass max_elements= to raise "
            f"the cap deliberately"
        )


@dataclasses.dataclass(frozen=True)
class LayerCharacter:
    """The pre-compile observable features of one projection/layer.

    Exactly the four factors from the paper's dataset (§IV-A).
    """

    n_source: int
    n_target: int
    weight_density: float   # fraction of nonzero synapses in [0, 1]
    delay_range: int        # max synaptic delay in timesteps, >= 1

    def as_features(self) -> np.ndarray:
        return np.array(
            [self.n_source, self.n_target, self.weight_density, self.delay_range],
            dtype=np.float64,
        )

    def validate(self) -> None:
        if self.n_source <= 0 or self.n_target <= 0:
            raise ValueError("neuron counts must be positive")
        if not (0.0 <= self.weight_density <= 1.0):
            raise ValueError("weight_density must be in [0, 1]")
        if self.delay_range < 1:
            raise ValueError("delay_range must be >= 1")


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Leaky integrate-and-fire parameters for Eq. (1) of the paper.

    V[t+1] = sum_j W[j,i] x[j, t-d(j,i)] + alpha * V[t] - z[t] * V_th
    """

    alpha: float = 0.9       # membrane decay
    v_th: float = 1.0        # firing threshold
    v_reset: float = 0.0     # unused by Eq. (1) (subtractive reset) but kept
    n_projection_type: int = 2   # excitatory / inhibitory (Table I)


@dataclasses.dataclass
class SNNLayer:
    """A concrete projection: weights + delays + the derived character.

    ``weights`` is (n_source, n_target) float (signed: excitatory > 0,
    inhibitory < 0); zero means no synapse.  ``delays`` is (n_source,
    n_target) int in [1, delay_range]; entries where weights == 0 are
    ignored.

    ``pre``/``post`` name the source/target :class:`Population` when the
    layer is used as an edge of an explicit application graph.  The chain
    constructor never reads or writes them — it synthesizes its endpoints
    positionally on the network (``SNNNetwork.endpoints``), so layer
    objects can be shared between networks without corruption.
    """

    weights: np.ndarray
    delays: np.ndarray
    delay_range: int
    lif: LIFParams = dataclasses.field(default_factory=LIFParams)
    name: str = "layer"
    pre: Optional[str] = None
    post: Optional[str] = None

    def __post_init__(self) -> None:
        if self.weights.shape != self.delays.shape:
            raise ValueError("weights and delays must share a shape")
        if self.delays.size and self.connectivity().any():
            dmax = int(self.delays[self.connectivity()].max())
            if dmax > self.delay_range:
                raise ValueError(f"delay {dmax} exceeds delay_range {self.delay_range}")

    @property
    def n_source(self) -> int:
        return self.weights.shape[0]

    @property
    def n_target(self) -> int:
        return self.weights.shape[1]

    def connectivity(self) -> np.ndarray:
        return self.weights != 0.0

    @property
    def n_synapses(self) -> int:
        return int(self.connectivity().sum())

    def density(self) -> float:
        return self.n_synapses / float(self.weights.size)

    def character(self) -> LayerCharacter:
        return LayerCharacter(
            n_source=self.n_source,
            n_target=self.n_target,
            weight_density=self.density(),
            delay_range=self.delay_range,
        )


def random_layer(
    n_source: int,
    n_target: int,
    density: float,
    delay_range: int,
    *,
    seed: int,
    inhibitory_fraction: float = 0.2,
    delay_granularity: str = "source",
    name: str = "layer",
    max_elements: Optional[int] = None,
) -> SNNLayer:
    """Generate a random layer like the paper's dataset generator (§IV-A).

    Bernoulli(density) connectivity, int8-representable weights in
    [-128, 127] \\ {0}, uniform delays in [1, delay_range].

    ``delay_granularity``:

    * ``"source"`` (default) — axonal delays: all synapses of one source
      neuron share a delay.  This is the reading under which the paper's
      weight-delay-map stays ~1 B/synapse independent of delay range and
      the parallel paradigm wins the broad region Fig 3 shows (DESIGN.md §2).
    * ``"synapse"`` — per-synapse delays (the fully general sPyNNaker row
      format; supported end-to-end and used as an ablation).

    Raises :class:`DenseStorageError` when ``n_source * n_target`` exceeds
    ``max_elements`` (default :data:`DENSE_ELEMENT_CAP`) — use
    :func:`random_sparse_projection` for networks of that scale.
    """
    if delay_granularity not in ("source", "synapse"):
        raise ValueError(delay_granularity)
    _check_dense_budget(n_source, n_target, max_elements, f"random_layer({name!r})")
    rng = np.random.default_rng(seed)
    mask = rng.random((n_source, n_target)) < density
    mag = rng.integers(1, 128, size=(n_source, n_target)).astype(np.float64)
    sign = np.where(rng.random((n_source, n_target)) < inhibitory_fraction, -1.0, 1.0)
    weights = np.where(mask, mag * sign, 0.0)
    if delay_granularity == "source":
        per_src = rng.integers(1, delay_range + 1, size=(n_source, 1))
        delays = np.broadcast_to(per_src, (n_source, n_target)).copy()
    else:
        delays = rng.integers(1, delay_range + 1, size=(n_source, n_target))
    delays = np.where(mask, delays, 1)
    return SNNLayer(weights=weights, delays=delays, delay_range=delay_range, name=name)


@dataclasses.dataclass(frozen=True)
class Population:
    """A vertex of the application graph: one population of LIF neurons.

    ``lif`` optionally pins the population's neuron parameters; when
    ``None`` they are derived from the (unique) LIF parameters of the
    projections targeting it — the chain-compatible behavior where a
    layer's ``lif`` governs its target neurons.
    """

    name: str
    size: int
    lif: Optional[LIFParams] = None

    def validate(self) -> None:
        if not self.name:
            raise ValueError("population needs a name")
        if self.size <= 0:
            raise ValueError(f"population {self.name!r} size must be > 0")


@dataclasses.dataclass
class Projection(SNNLayer):
    """An edge of the application graph: a named synaptic projection.

    Exactly an :class:`SNNLayer` (weights + delays + derived character —
    the compilers and the classifier treat the two identically) that
    *requires* its ``pre``/``post`` population endpoints.
    """

    def __post_init__(self) -> None:
        super().__post_init__()
        if not self.pre or not self.post:
            raise ValueError(
                f"projection {self.name!r} needs pre= and post= populations"
            )


def random_projection(
    pre: Population,
    post: Population,
    density: float,
    delay_range: int,
    *,
    seed: int,
    inhibitory_fraction: float = 0.2,
    delay_granularity: str = "source",
    name: Optional[str] = None,
    max_elements: Optional[int] = None,
) -> Projection:
    """A :func:`random_layer` whose shape comes from its two populations.

    Raises :class:`DenseStorageError` above the dense element cap — use
    :func:`random_sparse_projection` for networks of that scale.
    """
    layer = random_layer(
        pre.size, post.size, density, delay_range, seed=seed,
        inhibitory_fraction=inhibitory_fraction,
        delay_granularity=delay_granularity,
        name=name or f"{pre.name}->{post.name}",
        max_elements=max_elements,
    )
    return Projection(
        weights=layer.weights, delays=layer.delays,
        delay_range=layer.delay_range, lif=layer.lif, name=layer.name,
        pre=pre.name, post=post.name,
    )


@dataclasses.dataclass
class SparseProjection:
    """A projection stored in CSR form — only nonzero synapses exist.

    Rows are source neurons.  ``indptr`` is the ``(S + 1,)`` int64 row
    pointer; ``indices`` holds each synapse's target-neuron column
    (sorted, duplicate-free within each row); ``values`` holds the signed
    weight (excitatory > 0, inhibitory < 0, never 0) and ``delay_values``
    the per-synapse delay in ``[1, delay_range]``.  ``densify()`` is the
    exact inverse of :meth:`from_dense` on any dense projection, and the
    differential harness (``tests/test_sparse_equivalence.py``) pins every
    sparse launch path bit-identical to the densified numpy oracle.

    This is deliberately *not* a subclass of :class:`SNNLayer` — there is
    no dense ``(S, T)`` array to inherit, which is the point.  Consumers
    (classifier, compilers, executor, tiling) interact through the shared
    duck-typed surface: ``n_source`` / ``n_target`` / ``n_synapses`` /
    ``density()`` / ``character()`` / ``lif`` / ``name`` / ``pre`` /
    ``post``, plus the sparse-only ``coo()`` / ``densify()`` /
    ``slice_block()``.  Use :func:`is_sparse` to branch where the storage
    format matters.
    """

    n_source: int
    n_target: int
    indptr: np.ndarray        # (S + 1,) int64, monotone, indptr[-1] == nnz
    indices: np.ndarray       # (nnz,) int64 target columns, sorted per row
    values: np.ndarray        # (nnz,) float64 signed weights, nonzero
    delay_values: np.ndarray  # (nnz,) int64 delays in [1, delay_range]
    delay_range: int
    lif: LIFParams = dataclasses.field(default_factory=LIFParams)
    name: str = "sparse"
    pre: Optional[str] = None
    post: Optional[str] = None

    def __post_init__(self) -> None:
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int64)
        self.values = np.asarray(self.values, dtype=np.float64)
        self.delay_values = np.asarray(self.delay_values, dtype=np.int64)
        if self.indptr.shape != (self.n_source + 1,):
            raise ValueError(
                f"sparse projection {self.name!r}: indptr shape "
                f"{self.indptr.shape} != ({self.n_source + 1},)"
            )
        if self.indptr[0] != 0 or (np.diff(self.indptr) < 0).any():
            raise ValueError(f"sparse projection {self.name!r}: bad indptr")
        nnz = int(self.indptr[-1])
        if not (self.indices.shape == self.values.shape
                == self.delay_values.shape == (nnz,)):
            raise ValueError(
                f"sparse projection {self.name!r}: indices/values/delays "
                f"must all be ({nnz},)"
            )
        if nnz:
            if self.indices.min() < 0 or self.indices.max() >= self.n_target:
                raise ValueError(
                    f"sparse projection {self.name!r}: column out of range"
                )
            if (self.values == 0.0).any():
                raise ValueError(
                    f"sparse projection {self.name!r}: explicit zero weight "
                    f"— drop the entry instead"
                )
            if self.delay_values.min() < 1 or (
                int(self.delay_values.max()) > self.delay_range
            ):
                raise ValueError(
                    f"sparse projection {self.name!r}: delay outside "
                    f"[1, {self.delay_range}]"
                )
            # each row's columns strictly increasing: every step between
            # neighbours is positive, bar those from one row into the next
            rising = np.diff(self.indices) > 0
            starts = self.indptr[1:-1]
            rising[starts[(starts > 0) & (starts < nnz)] - 1] = True
            if not rising.all():
                r = int(np.searchsorted(self.indptr, np.argmin(rising),
                                        side="right")) - 1
                raise ValueError(
                    f"sparse projection {self.name!r}: row {r} columns "
                    f"must be strictly increasing (sorted, no duplicates)"
                )
        if not self.pre or not self.post:
            raise ValueError(
                f"sparse projection {self.name!r} needs pre= and post= "
                f"populations"
            )

    @property
    def n_synapses(self) -> int:
        return int(self.indptr[-1])

    def density(self) -> float:
        return self.n_synapses / float(self.n_source * self.n_target)

    def character(self) -> LayerCharacter:
        return LayerCharacter(
            n_source=self.n_source,
            n_target=self.n_target,
            weight_density=self.density(),
            delay_range=self.delay_range,
        )

    def coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """``(src, tgt, weight, delay)`` per synapse, row-major order."""
        src = np.repeat(
            np.arange(self.n_source, dtype=np.int64), np.diff(self.indptr)
        )
        return src, self.indices, self.values, self.delay_values

    def densify(self, max_elements: Optional[int] = None) -> Projection:
        """The exact dense :class:`Projection` this CSR form represents.

        Unconnected slots get weight 0 and delay 1 (ignored, matching the
        dense generators).  Subject to the same element cap as
        :func:`random_projection` — the oracle densifies small fixtures,
        it must never be the accidental path to a 100 MB array.
        """
        _check_dense_budget(
            self.n_source, self.n_target, max_elements,
            f"SparseProjection.densify({self.name!r})",
        )
        weights = np.zeros((self.n_source, self.n_target), dtype=np.float64)
        delays = np.ones((self.n_source, self.n_target), dtype=np.int64)
        src, tgt, w, d = self.coo()
        weights[src, tgt] = w
        delays[src, tgt] = d
        return Projection(
            weights=weights, delays=delays, delay_range=self.delay_range,
            lif=self.lif, name=self.name, pre=self.pre, post=self.post,
        )

    @classmethod
    def from_dense(cls, layer: SNNLayer, *,
                   pre: Optional[str] = None,
                   post: Optional[str] = None,
                   name: Optional[str] = None) -> "SparseProjection":
        """CSR form of a dense layer; ``densify()`` inverts it exactly."""
        mask = layer.connectivity()
        src, tgt = np.nonzero(mask)          # row-major, cols sorted per row
        counts = np.bincount(src, minlength=layer.n_source)
        indptr = np.zeros(layer.n_source + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(
            n_source=layer.n_source, n_target=layer.n_target,
            indptr=indptr, indices=tgt.astype(np.int64),
            values=layer.weights[src, tgt].astype(np.float64),
            delay_values=layer.delays[src, tgt].astype(np.int64),
            delay_range=layer.delay_range, lif=layer.lif,
            name=name or layer.name,
            pre=pre or layer.pre, post=post or layer.post,
        )

    def slice_block(self, r0: int, r1: int, c0: int, c1: int, *,
                    pre: str, post: str, name: str) -> "SparseProjection":
        """The CSR sub-matrix ``[r0:r1, c0:c1]`` — no densification.

        The tiling pass slices population blocks this way; columns inside
        each row are already sorted, so masking preserves CSR invariants.
        """
        starts = self.indptr[r0:r1]
        stops = self.indptr[r0 + 1:r1 + 1]
        keep = np.zeros(self.n_synapses, dtype=bool)
        for a, b in zip(starts, stops):
            keep[a:b] = True
        keep &= (self.indices >= c0) & (self.indices < c1)
        src_all = np.repeat(
            np.arange(self.n_source, dtype=np.int64), np.diff(self.indptr)
        )
        src = src_all[keep] - r0
        counts = np.bincount(src, minlength=r1 - r0)
        indptr = np.zeros(r1 - r0 + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return SparseProjection(
            n_source=r1 - r0, n_target=c1 - c0,
            indptr=indptr, indices=self.indices[keep] - c0,
            values=self.values[keep], delay_values=self.delay_values[keep],
            delay_range=self.delay_range, lif=self.lif,
            name=name, pre=pre, post=post,
        )


def is_sparse(proj: object) -> bool:
    """True when ``proj`` uses CSR storage (:class:`SparseProjection`)."""
    return isinstance(proj, SparseProjection)


def random_sparse_projection(
    pre: Population,
    post: Population,
    density: float,
    delay_range: int,
    *,
    seed: int,
    inhibitory_fraction: float = 0.2,
    delay_granularity: str = "source",
    name: Optional[str] = None,
) -> SparseProjection:
    """Generate a random CSR projection without materializing ``(S, T)``.

    Distribution-compatible with :func:`random_projection` (Bernoulli
    connectivity via per-row binomial counts, int8-magnitude signed
    weights, uniform delays, source/synapse delay granularity) but memory
    scales with nnz, so SpiNNCer-scale nets (~0.04 % of 97k²) fit easily.
    """
    if delay_granularity not in ("source", "synapse"):
        raise ValueError(delay_granularity)
    if not (0.0 <= density <= 1.0):
        raise ValueError("density must be in [0, 1]")
    rng = np.random.default_rng(seed)
    S, T = pre.size, post.size
    counts = rng.binomial(T, density, size=S).astype(np.int64)
    indptr = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = np.empty(nnz, dtype=np.int64)
    for r in range(S):
        k = counts[r]
        if k:
            indices[indptr[r]:indptr[r + 1]] = np.sort(
                rng.choice(T, size=k, replace=False)
            )
    mag = rng.integers(1, 128, size=nnz).astype(np.float64)
    sign = np.where(rng.random(nnz) < inhibitory_fraction, -1.0, 1.0)
    if delay_granularity == "source":
        per_src = rng.integers(1, delay_range + 1, size=S)
        delays = np.repeat(per_src, counts)
    else:
        delays = rng.integers(1, delay_range + 1, size=nnz)
    return SparseProjection(
        n_source=S, n_target=T, indptr=indptr, indices=indices,
        values=mag * sign, delay_values=delays.astype(np.int64),
        delay_range=delay_range, name=name or f"{pre.name}->{post.name}",
        pre=pre.name, post=post.name,
    )


class SNNNetwork:
    """Application graph: :class:`Population` vertices, projection edges.

    Two construction forms:

    * **chain** (compatibility): ``SNNNetwork(layers=[l0, l1, ...])`` —
      populations are synthesized from the layer sizes and each layer
      becomes the projection between consecutive populations.  ``layers``
      remains readable (it aliases ``projections``), so all existing
      feed-forward code keeps working unchanged.
    * **graph**: ``SNNNetwork(populations=[...], projections=[...])`` —
      arbitrary projection graphs: fan-in / fan-out, skip connections,
      self-loops, and recurrent edges.

    On construction the network validates shapes (every projection's
    endpoints must exist and match its weight matrix), computes a
    **topological order** of the populations over the forward edges
    (Kahn's algorithm with declared-order tie-breaking; cycles are broken
    at the earliest-declared population of the cycle), and classifies
    every projection: a **back-edge** is a self-loop or a projection onto
    a population at-or-before its source in the topological order.  The
    runtime cascades forward edges within a timestep in topological order
    and routes back-edges through a one-step-delayed feedback ring, so a
    spike crossing a back-edge of synaptic delay ``d`` arrives ``d + 1``
    steps after emission.

    ``forced_back_edges`` (graph form only) lists projection indices that
    must be treated as back-edges regardless of where their endpoints land
    in the topological order.  The tiling pass
    (:mod:`repro.placement.tiling`) uses this to keep every block of a
    tiled back-edge on the one-step-delayed feedback path — blocks of a
    tiled self-loop connect tile pairs in both directions, which no total
    order could classify uniformly on its own.

    Populations with no incoming projections are **input populations**,
    driven by the external spike train; a graph needs at least one.  A
    multi-input graph (e.g. a cerebellum scaffold with mossy- and
    climbing-fiber sources) consumes ONE concatenated external train of
    width ``n_input`` — the input populations' slots in **declared
    order**, with :attr:`input_slices` giving each population's
    ``(start, stop)`` columns.  Single-input graphs keep the exact
    pre-multi-input surface (``input_index`` / ``input_population``),
    and their concatenated train is trivially the one train it always
    was, so existing callers are bit-identical.

    Graph-form construction validates eagerly.  The chain form defers
    graph synthesis until a graph query (topology, runtime) needs it, so
    compile-only uses — e.g. a bag of unrelated layers compiled for PE
    accounting — keep working exactly as before the graph IR.
    """

    def __init__(
        self,
        layers: Optional[Sequence[SNNLayer]] = None,
        name: str = "snn",
        *,
        populations: Optional[Sequence[Population]] = None,
        projections: Optional[Sequence[SNNLayer]] = None,
        forced_back_edges: Optional[Sequence[int]] = None,
    ):
        self.name = name
        self._graph_built = False
        self._forced_back: FrozenSet[int] = frozenset(forced_back_edges or ())
        if layers is not None:
            if populations is not None or projections is not None:
                raise ValueError(
                    "pass either layers= (chain) or populations=/"
                    "projections= (graph), not both"
                )
            if self._forced_back:
                raise ValueError("forced_back_edges needs the graph form")
            if not layers:
                raise ValueError("a chain network needs at least one layer")
            self._projections: List[SNNLayer] = list(layers)
            self._populations: Optional[List[Population]] = None
        else:
            if populations is None or projections is None:
                raise ValueError(
                    "SNNNetwork needs layers= (chain) or both populations= "
                    "and projections= (graph)"
                )
            self._projections = list(projections)
            self._populations = list(populations)
            self._build_graph()

    def _build_graph(self) -> None:
        if self._populations is None:
            self._populations, self._endpoints = self._chain_graph(
                self._projections, self.name
            )
        else:
            for e in self._projections:
                if not getattr(e, "pre", None) or not getattr(e, "post", None):
                    raise ValueError(
                        f"graph projection {getattr(e, 'name', '?')!r} "
                        f"needs pre= and post= populations"
                    )
            self._endpoints = [(e.pre, e.post) for e in self._projections]
        self._validate()
        self._order_graph()
        self._graph_built = True

    def _ensure_graph(self) -> None:
        if not self._graph_built:
            self._build_graph()

    # -- chain compatibility --------------------------------------------------
    @staticmethod
    def _chain_graph(layers, name):
        """Positional chain endpoints — the caller's layers are NOT
        mutated (their ``pre``/``post`` fields are ignored), so layer
        objects shared between several networks stay uncorrupted."""
        if not layers:
            raise ValueError("a chain network needs at least one layer")
        pops = [Population(f"{name}.p0", layers[0].n_source)]
        ends = []
        for i, l in enumerate(layers):
            if l.n_source != pops[-1].size:
                raise ValueError(
                    f"chain shape mismatch at layer {i} ({l.name!r}): "
                    f"n_source {l.n_source} != previous n_target "
                    f"{pops[-1].size}"
                )
            pops.append(Population(f"{name}.p{i + 1}", l.n_target))
            ends.append((pops[-2].name, pops[-1].name))
        return pops, ends

    @property
    def projections(self) -> List[SNNLayer]:
        return self._projections

    @property
    def populations(self) -> List[Population]:
        self._ensure_graph()
        return self._populations

    @property
    def layers(self) -> List[SNNLayer]:
        """The projections, in declaration order (chain-era alias)."""
        return self._projections

    @property
    def layer_sizes(self) -> list:
        sizes = [self._projections[0].n_source]
        sizes += [l.n_target for l in self._projections]
        return sizes

    @property
    def endpoints(self) -> Tuple[Tuple[str, str], ...]:
        """Per projection: its ``(pre, post)`` population names.

        Graph-form networks read these off each projection; chain-form
        networks synthesize them positionally (never mutating the layer
        objects).
        """
        self._ensure_graph()
        return tuple(self._endpoints)

    @property
    def is_chain(self) -> bool:
        """A pure feed-forward chain (the pre-graph data model)."""
        self._ensure_graph()
        if self.back_edges or len(self._projections) != len(
            self._populations
        ) - 1:
            return False
        if len(self.input_indices) != 1:
            return False
        cur = self._populations[self.input_indices[0]].name
        for pre, post in self._endpoints:
            if pre != cur:
                return False
            cur = post
        return True

    # -- validation + ordering ------------------------------------------------
    def _validate(self) -> None:
        if not self._projections:
            raise ValueError("network needs at least one projection")
        seen = set()
        for p in self._populations:
            p.validate()
            if p.name in seen:
                raise ValueError(f"duplicate population name {p.name!r}")
            seen.add(p.name)
        self._pop_index: Dict[str, int] = {
            p.name: i for i, p in enumerate(self._populations)
        }
        for e, (pre, post) in zip(self._projections, self._endpoints):
            if pre not in self._pop_index or post not in self._pop_index:
                raise ValueError(
                    f"projection {e.name!r} references unknown population "
                    f"({pre!r} -> {post!r})"
                )
            if e.n_source != self._populations[self._pop_index[pre]].size:
                raise ValueError(
                    f"projection {e.name!r}: n_source {e.n_source} != "
                    f"population {pre!r} size "
                    f"{self._populations[self._pop_index[pre]].size}"
                )
            if e.n_target != self._populations[self._pop_index[post]].size:
                raise ValueError(
                    f"projection {e.name!r}: n_target {e.n_target} != "
                    f"population {post!r} size "
                    f"{self._populations[self._pop_index[post]].size}"
                )

    def _order_graph(self) -> None:
        n = len(self._populations)
        idx = self._pop_index
        if self._forced_back - set(range(len(self._projections))):
            raise ValueError(
                f"forced_back_edges {sorted(self._forced_back)} out of "
                f"range for {len(self._projections)} projections"
            )
        preds: List[set] = [set() for _ in range(n)]
        for i, (pre, post) in enumerate(self._endpoints):
            # edges declared (forced) as back-edges never constrain the
            # topological order — they are routed through the one-step
            # feedback ring whatever positions their endpoints land on,
            # exactly like auto-detected cycle breaks.  The tiling pass
            # relies on this: blocks of a tiled self-loop span tile pairs
            # in BOTH directions, which no total order could classify
            # uniformly without the override.
            if i in self._forced_back:
                continue
            s, t = idx[pre], idx[post]
            if s != t:
                preds[t].add(s)
        placed: set = set()
        order: List[int] = []
        while len(order) < n:
            ready = [
                i for i in range(n)
                if i not in placed and not (preds[i] - placed)
            ]
            if ready:
                pick = min(ready)
            else:
                # no acyclic candidate left: break a cycle at the
                # earliest-declared population of a SOURCE cycle (an SCC
                # with no unplaced predecessors outside itself) — a
                # population merely downstream of a cycle is never
                # picked, so only genuinely cyclic in-edges become
                # back-edges, independent of declaration order
                pick = self._stalled_cycle_pick(
                    [i for i in range(n) if i not in placed], preds
                )
            placed.add(pick)
            order.append(pick)
        self._topo_order: Tuple[int, ...] = tuple(order)
        self._topo_pos = {p: k for k, p in enumerate(order)}
        self._back_edges: FrozenSet[int] = self._forced_back | frozenset(
            i for i, (pre, post) in enumerate(self._endpoints)
            if self._topo_pos[idx[post]] <= self._topo_pos[idx[pre]]
        )
        self._in_edges: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(
                i for i, (_, post) in enumerate(self._endpoints)
                if idx[post] == p
            )
            for p in range(n)
        )
        sources = [p for p in range(n) if not self._in_edges[p]]
        if not sources:
            raise ValueError(
                "the application graph needs at least one population with "
                "no incoming projections (an external input); got none"
            )
        # declared order == external-train slot order (see class docstring)
        self._input_indices: Tuple[int, ...] = tuple(sources)

    @staticmethod
    def _stalled_cycle_pick(unplaced: List[int], preds: List[set]) -> int:
        """Earliest-declared population inside a *source* cycle.

        ``unplaced`` nodes at a Kahn stall all have unplaced
        predecessors; the condensation of their subgraph is a DAG whose
        source components are exactly the cycles nothing else feeds.
        Breaking there (and only there) keeps every non-cyclic forward
        edge forward whatever the declaration order.
        """
        un = set(unplaced)
        succs = {u: [v for v in unplaced if u in preds[v]] for u in unplaced}
        reach: Dict[int, set] = {}
        for u in unplaced:
            seen: set = set()
            stack = [u]
            while stack:
                x = stack.pop()
                for y in succs[x]:
                    if y not in seen:
                        seen.add(y)
                        stack.append(y)
            reach[u] = seen
        candidates = []
        for u in unplaced:
            comp = {u} | {
                v for v in unplaced if v in reach[u] and u in reach[v]
            }
            if all(
                p in comp or p not in un
                for v in comp for p in preds[v]
            ):
                candidates.append(u)        # u sits in a source SCC
        return min(candidates)

    # -- graph queries --------------------------------------------------------
    @property
    def topo_order(self) -> Tuple[int, ...]:
        """Population indices in topological order of the forward edges."""
        self._ensure_graph()
        return self._topo_order

    @property
    def back_edges(self) -> FrozenSet[int]:
        """Projection indices classified as back-edges (self-loops and
        projections onto populations at-or-before their source)."""
        self._ensure_graph()
        return self._back_edges

    @property
    def in_edges(self) -> Tuple[Tuple[int, ...], ...]:
        """Per population (declared index): in-edge projection indices in
        declaration order."""
        self._ensure_graph()
        return self._in_edges

    @property
    def input_indices(self) -> Tuple[int, ...]:
        """Declared indices of all input populations (no in-edges), in
        declared order — the order of their slots in the concatenated
        external train."""
        self._ensure_graph()
        return self._input_indices

    @property
    def input_index(self) -> int:
        """Declared index of THE input population.

        Single-input compatibility surface; raises for multi-input
        graphs — use :attr:`input_indices` / :attr:`input_slices` there.
        """
        self._ensure_graph()
        if len(self._input_indices) != 1:
            names = [self._populations[p].name for p in self._input_indices]
            raise ValueError(
                f"graph has {len(names)} input populations {names}; "
                "input_index is only defined for single-input graphs — "
                "use input_indices/input_slices"
            )
        return self._input_indices[0]

    def population_index(self, name: str) -> int:
        self._ensure_graph()
        return self._pop_index[name]

    @property
    def input_populations(self) -> List[Population]:
        """All input populations, in external-train slot order."""
        return [self.populations[i] for i in self.input_indices]

    @property
    def input_population(self) -> Population:
        return self.populations[self.input_index]

    @property
    def input_slices(self) -> Tuple[Tuple[int, int], ...]:
        """Per input population (aligned with :attr:`input_indices`): its
        ``(start, stop)`` columns in the concatenated external train."""
        self._ensure_graph()
        out, start = [], 0
        for i in self._input_indices:
            size = self._populations[i].size
            out.append((start, start + size))
            start += size
        return tuple(out)

    @property
    def n_input(self) -> int:
        """Width of the external spike train (summed input population
        sizes; a single-input graph's train is just that population)."""
        self._ensure_graph()
        return sum(self._populations[i].size for i in self._input_indices)

    def population_lif(self, pop: int) -> LIFParams:
        """Effective LIF parameters for one population (declared index).

        The population's own ``lif`` wins; otherwise the unique ``lif``
        shared by its incoming projections (chain-compatible: a layer's
        ``lif`` governs its target neurons).  Ambiguity is an error —
        set ``Population.lif`` explicitly for multi-in-edge populations
        whose projections disagree.
        """
        p = self.populations[pop]
        if p.lif is not None:
            return p.lif
        lifs = {self.projections[i].lif for i in self.in_edges[pop]}
        if not lifs:
            raise ValueError(
                f"input population {p.name!r} has no LIF parameters"
            )
        if len(lifs) > 1:
            raise ValueError(
                f"population {p.name!r} has in-projections with differing "
                f"LIF parameters; set Population.lif explicitly"
            )
        return next(iter(lifs))

    def characters(self) -> list:
        return [l.character() for l in self.projections]


def feedforward_network(
    sizes: list,
    density: float,
    delay_range: int,
    *,
    seed: int = 0,
    name: str = "snn",
) -> SNNNetwork:
    layers = [
        random_layer(
            sizes[i], sizes[i + 1], density, delay_range,
            seed=seed + i, name=f"{name}.l{i}",
        )
        for i in range(len(sizes) - 1)
    ]
    return SNNNetwork(layers=layers, name=name)
