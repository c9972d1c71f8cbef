"""Plan/factor session API on PyTorch: analyze once, refactorize many, solve
multi-RHS — on one CUDA device by default::

    import repro_torch

    plan = repro_torch.analyze(a, repro_torch.LUOptions(concurrency=512))
    for values in value_stream:            # same pattern, new values
        factor = plan.factorize(values)    # numeric sweep only, on the card
        result = factor.solve(b)           # b is (n,) or multi-RHS (n, k)

    batch = plan.factorize_batch(values_batch)   # (B, nnz): one sweep
    results = batch.solve_batch(b_batch)         # (B, n) or (B, n, k)

    blocked = repro_torch.replan(plan, plan.options.replace(blocking=True))

``analyze`` runs the symbolic fixpoint + streamed supernode detection on the
device and precomputes everything value-independent: the sparse
``CSCPattern`` of L+U, the supernode panel partition, the level schedule,
the per-panel gather maps, the CSR scatter maps, the solve-level DAGs and a
structure-only ``PanelStore`` template.  ``LUPlan.factorize`` runs only the
value-dependent panel sweep on the plan's device;
``LUFactorization.refactorize`` reuses the same device buffers in place.
``LUPlan.factorize_batch`` factors B value sets of the pattern in one
sweep (the many-matrix tier: Newton iterations, transient sweeps, Monte
Carlo corners), each system bitwise its sequential factorization.

The robust tier (``LUOptions(pivot="static", perturb=True)``) runs a
maximum-product transversal + equilibration pre-pass on the host at
analyze time; the symbolic analysis runs on the permuted pattern
(``LUPlan.a_factored``), each factorization replays the O(nnz) value
transform on the device, tiny pivots are bumped on the device, and
``LUFactorization.quality()`` certifies the factors.  ``blocking=True`` /
``autotune=True`` merge the detected supernodes under a roofline cost
model before the schedule is built, and ``replan`` re-derives a plan
under new partition knobs without re-running the fixpoint.

The default device is the card (``device=None`` -> ``"cuda"``); without
CUDA ``analyze`` raises instead of running on the CPU.  Pass
``device="cpu"`` to run the whole path on the CPU (the kernels' plain
versions), as the tests do.  Plans hold numpy arrays and plain dataclasses
only — device copies of the maps live in a cache that is not pickled — so
an analysis pickles and replays anywhere its device exists.

Analysis distributes over ``torch.distributed``: every rank of a process
group calls ``analyze(a, opts, mesh=launch.mesh.make_flat_mesh())`` (or sets
``LUOptions(distribute=True)``), relaxes its own share of the sources, and
gets the whole plan, bitwise the single-process one, with a
``PanelPlacement`` that splits each level's panels into per-device segments
(``LUPlan.place(n)`` re-derives it for any count).
``LUOptions(runtime="dynamic")`` runs the fixpoint on the work-stealing
scheduler's executor slots (``runtime.scheduler``).

``LUOptions`` keeps exactly the fields, defaults and validation of
``repro.LUOptions``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.symbolic import SymbolicResult
from repro_torch.core.symbolic import symbolic_factorize as _symbolic_factorize
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import (
    FLAT_AXIS, make_flat_mesh, visible_device_count,
)
from repro_torch.numeric.schedule import (
    PanelPlacement, PanelSchedule, build_gather_maps, build_placement,
    build_schedule, build_update_maps, device_maps,
)
from repro_torch.numeric.solve import (
    BatchedSolveResult, SolveResult, SolveSchedule, build_solve_schedule,
)
from repro_torch.numeric.solve import solve as _solve
from repro_torch.numeric.solve import solve_batch as _solve_batch
from repro_torch.numeric.storage import (
    BatchedPanelStore, CSCPattern, CsrScatterMaps, PanelStore,
)
from repro_torch.numeric.supernodal import (
    BatchedNumericResult, NumericResult, factor_batch_on_store,
    factor_on_store,
)
from repro_torch.obs import trace as _ot
from repro_torch.obs.trace import SpanSummary
from repro_torch.robust import (
    QualityReport, RobustPlan, build_robust_prepass, estimate_quality,
)
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.numeric import CsrOperator, generic_values_csr
from repro_torch.supernodes.blocking import merge_supernodes
from repro_torch.supernodes.detect import detect_from_fingerprints
from repro_torch.tune import TuneReport, autotune_partition, cost_model_for

_SYMBOLIC_BACKENDS = ("ell", "dense", "kernel")
_NUMERIC_BACKENDS = ("numpy", "kernel")
_POLICIES = ("lpt", "contiguous")
_RUNTIMES = ("static", "dynamic")
_PIVOTS = ("none", "static")


@dataclasses.dataclass(frozen=True)
class LUOptions:
    """Every knob of the symbolic -> numeric -> solve pipeline in one frozen
    object — the fields, defaults and validation of ``repro.LUOptions``.

    Symbolic fixpoint: ``concurrency`` (#C source chunk size), ``backend``
    ("ell" gather, "dense" plain masked min, "kernel" = K1 on the card),
    ``combined`` (one batched fixpoint per chunk), ``bubble`` (bubble
    removal: each chunk's labels only as wide as its sources need; the
    narrowed chunks relax by ELL whatever ``backend`` is),
    ``use_arena`` (label re-init elision; off under ``bubble``),
    ``budget_bytes`` (memory envelope -> effective #C),
    ``checkpoint_path`` (per-chunk durable progress).

    Supernodes: ``supernode_relax`` (T3 merge tolerance, 0 = exact T2),
    ``supernode_max_size`` (panel width cap).

    Blocking / autotune: ``blocking=True`` merges adjacent supernodes whose
    row structures nearly overlap into padded dense blocks when the
    roofline cost model says it pays (``block_merge_threshold``, default
    1.0 = exactly the modeled wins; ``block_max_width`` caps a merged
    panel); ``autotune=True`` sweeps ``supernode_relax`` /
    ``supernode_max_size`` candidates through that merge pass and freezes
    the winner (and a ``concurrency``) onto the plan's options
    (``LUPlan.tuned``).  Both off by default.

    Numeric: ``n_bins``/``policy`` (pack_panels within-level grouping),
    ``numeric_backend`` ("numpy" = float64 torch, "kernel" = float32 K3/K4),
    ``piv_tol`` (zero-pivot threshold; None = eps at matrix scale),
    ``check_pattern``/``pattern_tol``, ``segment_batch`` (stack same-shape
    panel GEMMs of a level into one dispatch).

    Solve: ``refine_iters``/``refine_tol``.  Observability: ``trace``.

    Robustness: ``pivot="static"`` adds the analyze-time maximum-product
    transversal + equilibration pre-pass (the factored system becomes
    ``Dr·P·A·Dc``, stored on the plan); ``perturb=True`` replaces tiny
    pivots (|piv| <= ``perturb_eps``·max|A|, default sqrt(machine eps))
    with the signed threshold during the sweep instead of raising, counting
    them in ``perturbed_pivots``.  Both off by default.

    Distribution: ``distribute=True`` makes ``analyze`` build the flat
    mesh over the default process group (``launch.mesh.make_flat_mesh``)
    when no mesh is passed: each rank relaxes its share of the sources and
    the plan's placement splits level work per device.  Runtime:
    ``runtime="dynamic"`` runs the fixpoint on the work-stealing scheduler
    (``runtime.scheduler``) instead of the static chunk loop.
    """

    # -- symbolic fixpoint
    concurrency: int = 128
    backend: str = "ell"
    combined: bool = True
    bubble: bool = False
    use_arena: bool = True
    budget_bytes: Optional[int] = None
    checkpoint_path: Optional[str] = None
    # -- supernode detection
    supernode_relax: int = 0
    supernode_max_size: int = 64
    # -- structure-aware blocking + roofline autotune
    blocking: bool = False
    block_merge_threshold: Optional[float] = None   # None = 1.0 (model wins)
    block_max_width: int = 256
    autotune: bool = False
    # -- numeric factorization
    n_bins: int = 8
    policy: str = "lpt"
    numeric_backend: str = "numpy"
    piv_tol: Optional[float] = None
    check_pattern: bool = True
    pattern_tol: Optional[float] = None
    segment_batch: bool = True
    # -- solve / refinement
    refine_iters: int = 2
    refine_tol: Optional[float] = None
    # -- numerical robustness
    pivot: str = "none"
    perturb: bool = False
    perturb_eps: Optional[float] = None
    # -- distribution
    distribute: bool = False
    # -- execution runtime
    runtime: str = "static"
    # -- observability: phase spans + counters for this plan's calls
    trace: bool = False

    def __post_init__(self):
        if self.concurrency < 1:
            raise ValueError(
                f"concurrency must be >= 1 (source-chunk width of the "
                f"symbolic fixpoint), got {self.concurrency}")
        if self.supernode_max_size < 1:
            raise ValueError(
                f"supernode_max_size must be >= 1 (panel width cap; 1 "
                f"disables supernode fusion), got {self.supernode_max_size}")
        if self.supernode_relax < 0:
            raise ValueError(
                f"supernode_relax must be >= 0 (T3 merge tolerance; 0 is "
                f"exact T2), got {self.supernode_relax}")
        if self.n_bins < 1:
            raise ValueError(
                f"n_bins must be >= 1 (pack_panels bins per level), "
                f"got {self.n_bins}")
        if self.refine_iters < 0:
            raise ValueError(
                f"refine_iters must be >= 0 (0 disables iterative "
                f"refinement), got {self.refine_iters}")
        if self.budget_bytes is not None and self.budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be >= 1 when set (memory envelope for "
                f"the fixpoint working set), got {self.budget_bytes}")
        if self.block_max_width < 1:
            raise ValueError(
                f"block_max_width must be >= 1 (merged-panel column cap "
                f"for blocking/autotune), got {self.block_max_width}")
        if (self.block_merge_threshold is not None
                and not self.block_merge_threshold > 0.0):
            raise ValueError(
                f"block_merge_threshold must be > 0 when set (1.0 accepts "
                f"exactly the modeled wins; larger merges more "
                f"aggressively), got {self.block_merge_threshold!r}")
        if self.backend not in _SYMBOLIC_BACKENDS:
            raise ValueError(f"unknown symbolic backend {self.backend!r}; "
                             f"pick from {_SYMBOLIC_BACKENDS}")
        if self.numeric_backend not in _NUMERIC_BACKENDS:
            raise ValueError(f"unknown numeric backend "
                             f"{self.numeric_backend!r}; pick from "
                             f"{_NUMERIC_BACKENDS}")
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown packing policy {self.policy!r}; "
                             f"pick from {_POLICIES}")
        if self.runtime not in _RUNTIMES:
            raise ValueError(f"unknown runtime {self.runtime!r}; "
                             f"pick from {_RUNTIMES}")
        if self.pivot not in _PIVOTS:
            raise ValueError(f"unknown pivot mode {self.pivot!r}; "
                             f"pick from {_PIVOTS}")
        if self.perturb_eps is not None and not self.perturb_eps > 0.0:
            raise ValueError(f"perturb_eps must be positive, got "
                             f"{self.perturb_eps!r}")
        if self.runtime == "dynamic" and self.distribute:
            raise ValueError(
                "runtime='dynamic' is the host-driven scheduler over the "
                "visible devices and cannot be combined with "
                "distribute=True (the shard_map mesh) — drop one")

    def replace(self, **changes) -> "LUOptions":
        """A copy with ``changes`` applied (frozen-dataclass convenience)."""
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class LUFactorization:
    """Numeric factors of one value set on a plan's structure, on the plan's
    device.  ``solve`` runs supernodal substitution + refinement (single
    (n,) or multi-RHS (n, k)); ``refactorize`` overwrites *this*
    factorization's device buffers with a new value set in place."""

    plan: "LUPlan"
    num: NumericResult
    values: torch.Tensor         # (nnz,) float64 on the device (refinement)
    factor_s: float              # scatter + panel-sweep wall time
    stats: Optional[SpanSummary] = None
    # the values actually swept: the static-pivoting transform of
    # ``values`` under ``pivot="static"``, ``values`` itself otherwise
    factored_values: Optional[torch.Tensor] = None
    _matvec: Optional[CsrOperator] = dataclasses.field(default=None,
                                                       repr=False)
    _quality: Optional[QualityReport] = dataclasses.field(default=None,
                                                          repr=False)

    @property
    def n(self) -> int:
        return self.num.n

    @property
    def store(self) -> PanelStore:
        return self.num.store

    @property
    def l(self) -> np.ndarray:
        """Dense unit-lower L on the host — test/oracle helper."""
        return self.num.l

    @property
    def u(self) -> np.ndarray:
        """Dense upper U on the host — test/oracle helper."""
        return self.num.u

    def solve(self, b, *, refine_iters: Optional[int] = None,
              refine_tol: Optional[float] = None,
              batched: Optional[bool] = None) -> SolveResult:
        """Solve A x = b on the existing factors.  ``b`` is (n,) or (n, k)
        (numpy or tensor); ``x`` comes back as a float64 tensor on the
        plan's device.  Refinement knobs default to the plan's options;
        ``batched=None`` batches the diagonal solves for multi-RHS ``b``."""
        opts = self.plan.options
        if self._matvec is None:
            self._matvec = CsrOperator(self.plan.a, self.values)
        return _solve(
            self.plan.a, b, values=self.values, num=self.num,
            refine_iters=(opts.refine_iters if refine_iters is None
                          else refine_iters),
            refine_tol=opts.refine_tol if refine_tol is None else refine_tol,
            batched=batched, matvec=self._matvec,
            transform=self.plan._transform())

    @property
    def perturbed_pivots(self) -> int:
        """Tiny pivots bumped by the robust tier during this sweep."""
        return self.num.perturbed_pivots

    def quality(self, *, itmax: int = 5) -> QualityReport:
        """Trust certificate of these factors: element growth, the Hager
        1-norm condition estimate of the factored system and an
        "ok"/"suspect"/"reject" verdict — a few triangular solves on the
        packed factors, on their device; computed once and cached."""
        if self._quality is None:
            fvals = (self.factored_values if self.factored_values is not None
                     else self.values)
            self._quality = estimate_quality(
                self.num, self.plan.a_factored, fvals,
                perturbed_pivots=self.num.perturbed_pivots, itmax=itmax)
        return self._quality

    def refactorize(self, values) -> "LUFactorization":
        """Factor a new value set **in place** on this factorization's
        device buffers (zero + rescatter + panel sweep; the previous factors
        become invalid)."""
        return self.plan.factorize(values, _reuse_store=self.num.store)


@dataclasses.dataclass
class BatchedLUFactorization:
    """Factors of B same-pattern value sets from one batched sweep on the
    plan's device — the many-matrix tier of the session API.

    ``solve_batch`` solves every system on its factors with per-system
    refinement; ``system(i)`` is system i as an ordinary
    ``LUFactorization`` over zero-copy views of the batched buffers.  Every
    per-system result is bitwise the sequential ``plan.factorize(values[i])``
    / ``.solve(b[i])``."""

    plan: "LUPlan"
    num: BatchedNumericResult
    values: torch.Tensor         # (B, nnz) float64 on the device
    factor_s: float              # scatter + batched panel-sweep wall time
    stats: Optional[SpanSummary] = None
    factored_values: Optional[torch.Tensor] = None   # (B, nnz) swept values
    _matvecs: Optional[List[CsrOperator]] = dataclasses.field(default=None,
                                                              repr=False)

    @property
    def batch(self) -> int:
        return self.num.batch

    @property
    def n(self) -> int:
        return self.num.n

    @property
    def store(self) -> BatchedPanelStore:
        return self.num.store

    @property
    def perturbed_pivots(self) -> np.ndarray:
        """Per-system tiny-pivot bump counts, (B,) int64 (all zero unless
        the plan was built with ``LUOptions(perturb=True)``)."""
        pp = self.num.perturbed_pivots
        return (pp if pp is not None
                else np.zeros(self.batch, dtype=np.int64))

    def system(self, i: int) -> LUFactorization:
        """System i as a sequential ``LUFactorization`` (zero-copy factor
        views; its ``factor_s`` is 0.0 — the batch owns the timing)."""
        return LUFactorization(
            plan=self.plan, num=self.num.system(i), values=self.values[i],
            factor_s=0.0,
            factored_values=(self.factored_values[i]
                             if self.factored_values is not None else None))

    def solve_batch(self, b, *, refine_iters: Optional[int] = None,
                    refine_tol: Optional[float] = None
                    ) -> BatchedSolveResult:
        """Solve A_i x_i = b_i for every system on the existing factors.
        ``b`` is (B, n) or (B, n, k); refinement knobs default to the
        plan's ``LUOptions``."""
        opts = self.plan.options
        if self._matvecs is None:
            self._matvecs = [CsrOperator(self.plan.a, self.values[i])
                             for i in range(self.batch)]
        return _solve_batch(
            self.plan.a, b, self.values, self.num,
            refine_iters=(opts.refine_iters if refine_iters is None
                          else refine_iters),
            refine_tol=opts.refine_tol if refine_tol is None else refine_tol,
            matvecs=self._matvecs, transform=self.plan._transform())


@dataclasses.dataclass
class LUPlan:
    """One matrix structure, analyzed once on ``device``: the symbolic
    prediction plus every value-independent precomputation of the numeric
    pipeline.  Picklable: numpy arrays and plain dataclasses only; the
    device copies of the maps and of the static-pivoting tables
    (``_device_cache``) are rebuilt on the first ``factorize`` after
    unpickling.  ``placement`` (per-device panel segments of every level,
    plain numpy) travels in the pickle; the mesh never does."""

    a: CSRMatrix
    options: LUOptions
    sym: SymbolicResult
    pattern: CSCPattern
    schedule: PanelSchedule
    store_template: PanelStore
    gather_maps: List
    csr_maps: CsrScatterMaps
    solve_schedule: SolveSchedule
    analyze_s: float
    device: str
    stats: Optional[SpanSummary] = None
    # static pivoting (``pivot="static"``): the transform and the permuted
    # structural matrix the symbolic analysis ran on
    robust: Optional[RobustPlan] = None
    factored: Optional[CSRMatrix] = None
    # autotune record (``autotune=True``): its chosen knobs are frozen into
    # ``options``
    tuned: Optional[TuneReport] = None
    # device placement of panel work: set by a sharded or dynamic analyze,
    # re-derived by ``place``
    placement: Optional[PanelPlacement] = None
    _device_cache: Dict = dataclasses.field(default_factory=dict, repr=False)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_device_cache"] = {}
        return state

    @property
    def a_factored(self) -> CSRMatrix:
        """The structural matrix the factors describe: ``Dr·P·A·Dc``'s
        pattern under static pivoting, ``a`` itself otherwise."""
        return self.factored if self.factored is not None else self.a

    @property
    def n(self) -> int:
        return self.a.n

    @property
    def lu_nnz(self) -> int:
        """Predicted structural nonzeros of L+U (diagonal included)."""
        return self.pattern.nnz

    @property
    def n_supernodes(self) -> int:
        return self.schedule.n_panels

    @property
    def n_levels(self) -> int:
        return self.schedule.n_levels

    @property
    def n_devices(self) -> int:
        return self.placement.n_devices if self.placement is not None else 1

    def place(self, n_devices: Optional[int] = None, *,
              policy: str = "lpt") -> "LUPlan":
        """Re-derive the panel placement for ``n_devices`` (default: the
        visible device count, ``launch.mesh.visible_device_count``).
        Within a level panels are independent, so placement changes
        scheduling only — factors and solutions stay bitwise the same at
        every count.  Returns ``self`` (the placement is replaced in place)
        so ``pickle.load(f).place().factorize(v)`` chains."""
        if n_devices is None:
            n_devices = visible_device_count()
        self.placement = build_placement(self.schedule, n_devices,
                                         axis=FLAT_AXIS, policy=policy)
        return self

    def _device_state(self, dev: torch.device):
        """(store index, per-panel device gather maps, trailing-update
        tables, static-pivoting tables or None) on ``dev``, built on first
        use and cached for every later factorization."""
        key = str(dev)
        if key not in self._device_cache:
            self._device_cache[key] = (
                self.store_template.build_index(self.csr_maps, dev),
                device_maps(self.gather_maps, dev),
                build_update_maps(self.store_template, self.schedule,
                                  self.gather_maps).to(dev),
                self.robust.on(dev) if self.robust is not None else None)
        return self._device_cache[key]

    def _transform(self):
        """The static-pivoting tables on the plan's device (None without
        ``pivot="static"``)."""
        if self.robust is None:
            return None
        return self._device_state(resolve_device(self.device))[3]

    def factorize(self, values=None, *,
                  _reuse_store: Optional[PanelStore] = None
                  ) -> LUFactorization:
        """Numeric factorization of CSR-aligned ``values`` ((nnz,), numpy or
        tensor; defaults to ``generic_values_csr``) on the plan's device.
        Under static pivoting the plan's transform is replayed on the
        device first (an O(nnz) gather + scale; no symbolic work)."""
        t0 = time.perf_counter()
        if values is None:
            values = generic_values_csr(self.a)
        dev = resolve_device(self.device)
        values = torch.as_tensor(values, dtype=torch.float64, device=dev)
        index, maps, update_maps, robust = self._device_state(dev)
        fvals = (robust.transform_values(values) if robust is not None
                 else values)
        store = (_reuse_store if _reuse_store is not None
                 else PanelStore.from_structure(self.store_template, dev,
                                                index))
        store._solve_schedule = self.solve_schedule
        store._placement = self.placement       # per-device solve segments
        with _ot.ensure(self.options.trace) as tr:
            mark = tr.mark() if tr is not None else 0
            with _ot.span("factorize"):
                num = factor_on_store(
                    self.a_factored, fvals, store, self.schedule,
                    backend=self.options.numeric_backend,
                    piv_tol=self.options.piv_tol,
                    check_pattern=self.options.check_pattern,
                    pattern_tol=self.options.pattern_tol,
                    maps=maps, update_maps=update_maps,
                    csr_maps=self.csr_maps,
                    store_is_zeroed=_reuse_store is None,
                    segment_batch=self.options.segment_batch,
                    perturb=self.options.perturb,
                    perturb_eps=self.options.perturb_eps,
                    placement=self.placement)
            stats = tr.summary(mark) if tr is not None else None
        return LUFactorization(plan=self, num=num, values=values,
                               factor_s=time.perf_counter() - t0,
                               stats=stats, factored_values=fvals)

    def factorize_batch(self, values_batch) -> BatchedLUFactorization:
        """Numeric factorization of B same-pattern value sets in ONE
        batched level sweep on the plan's device: ``values_batch`` is a
        (B, nnz) CSR-aligned stack (numpy or tensor).  The index, gather
        maps and update tables are the plan's (``_device_state``); the
        trailing updates are one mapped K3/K4 launch per level for all B
        systems.  System i's factors are bitwise
        ``self.factorize(values_batch[i])``'s.  The batched tier ignores
        the placement."""
        t0 = time.perf_counter()
        dev = resolve_device(self.device)
        values_batch = torch.as_tensor(values_batch, dtype=torch.float64,
                                       device=dev)
        if values_batch.dim() != 2:
            raise ValueError(
                f"values_batch must be a (B, {self.a.nnz}) CSR-aligned "
                f"stack, got shape {tuple(values_batch.shape)}")
        index, maps, update_maps, robust = self._device_state(dev)
        fvals = (robust.transform_values(values_batch) if robust is not None
                 else values_batch)
        bstore = BatchedPanelStore(self.store_template,
                                   values_batch.shape[0], dev, index)
        bstore._solve_schedule = self.solve_schedule
        with _ot.ensure(self.options.trace) as tr:
            mark = tr.mark() if tr is not None else 0
            with _ot.span("factorize_batch"):
                num = factor_batch_on_store(
                    self.a_factored, fvals, bstore, self.schedule,
                    backend=self.options.numeric_backend,
                    piv_tol=self.options.piv_tol,
                    check_pattern=self.options.check_pattern,
                    pattern_tol=self.options.pattern_tol,
                    maps=maps, update_maps=update_maps,
                    csr_maps=self.csr_maps, store_is_zeroed=True,
                    segment_batch=self.options.segment_batch,
                    perturb=self.options.perturb,
                    perturb_eps=self.options.perturb_eps)
            stats = tr.summary(mark) if tr is not None else None
        return BatchedLUFactorization(plan=self, num=num,
                                      values=values_batch,
                                      factor_s=time.perf_counter() - t0,
                                      stats=stats, factored_values=fvals)

    def solve(self, b, values=None) -> SolveResult:
        """Convenience: factorize ``values`` and solve in one call."""
        factor = self.factorize(values)
        res = factor.solve(b)
        res.factor_s = factor.factor_s
        return res


def _partition_with_blocking(pattern, supernodes, fingerprints, opts,
                             peaks):
    """Apply autotune / structure-aware blocking to a detected partition.

    Returns ``(supernodes, tuned, opts)``: the (possibly merged) partition,
    the ``TuneReport`` when autotuning ran, and the options with any chosen
    knob values frozen in.  A no-op (same objects back) when both knobs are
    off — the default path never touches the merge pass.
    """
    tuned = None
    if opts.autotune:
        supernodes, tuned = autotune_partition(pattern, fingerprints, opts,
                                               peaks=peaks)
        opts = opts.replace(**tuned.chosen)
    elif opts.blocking:
        threshold = (1.0 if opts.block_merge_threshold is None
                     else opts.block_merge_threshold)
        supernodes, _ = merge_supernodes(
            pattern, supernodes, cost_model_for(opts, peaks),
            threshold=threshold, max_width=opts.block_max_width)
    return supernodes, tuned, opts


def _plan_structure(pattern: CSCPattern, supernodes, a_factored: CSRMatrix,
                    opts: LUOptions) -> dict:
    """Everything value-independent below a partition: the level schedule,
    the store template, the gather and CSR scatter maps (on the factored
    matrix) and the solve schedule — ``LUPlan`` fields by name."""
    with _ot.span("build_schedule"):
        schedule = build_schedule(pattern, supernodes, n_bins=opts.n_bins,
                                  policy=opts.policy)
        store_template = PanelStore(pattern, schedule.supernodes)
    with _ot.span("gather_maps"):
        gather_maps = build_gather_maps(store_template, schedule)
        csr_maps = store_template.csr_maps(a_factored)
    with _ot.span("solve_schedule"):
        solve_schedule = build_solve_schedule(store_template)
    return dict(schedule=schedule, store_template=store_template,
                gather_maps=gather_maps, csr_maps=csr_maps,
                solve_schedule=solve_schedule)


def analyze(a: CSRMatrix, options: Optional[LUOptions] = None, *,
            values=None, peaks: Optional[dict] = None, device=None,
            mesh=None, on_progress=None) -> LUPlan:
    """Symbolic analysis of ``a`` on ``device`` (default: the card): one
    fixpoint pass streams out the L/U counts, the supernode partition
    (fingerprints, K2) and the sparse ``CSCPattern``; everything
    value-independent downstream is precomputed into the returned
    ``LUPlan``.  No dense (n, n) pattern is materialized on the host or the
    device (the dense adjacency of ``backend="dense"/"kernel"`` is the
    graph, not the pattern).

    With ``LUOptions(pivot="static")`` the robust pre-pass runs first, on
    the host: a maximum-product transversal over ``values`` (a
    representative value set, CSR-aligned (nnz,) or dense (n, n), numpy or
    tensor; defaults to ``generic_values_csr(a)``, which weights the
    pattern only) picks the row permutation, Ruiz equilibration the
    scalings, and the fixpoint and everything downstream run on the
    permuted pattern (``LUPlan.a_factored``).  With ``blocking=True`` /
    ``autotune=True`` the detected partition runs through the blocking
    merge pass / the roofline knob sweep before the schedule is built;
    ``peaks`` (``{"mem_bw_gbs", "flops_gflops"}``) feeds the cost model
    (fixed constants otherwise, so tuning stays deterministic).

    ``mesh`` (a ``launch.mesh.FlatMesh``; every rank of its process group
    calls ``analyze`` with it) shards the fixpoint's sources over the
    ranks, each on its own device (``device`` defaults to the mesh's), and
    attaches a ``PanelPlacement`` over the mesh's shards;
    ``LUOptions(distribute=True)`` builds the flat mesh itself.  Counts,
    supernodes, pattern, factors and solutions are bitwise the mesh-less
    analysis's, on every rank.  A ``runtime="dynamic"`` plan gets a
    placement over the visible devices."""
    t0 = time.perf_counter()
    opts = options if options is not None else LUOptions()
    if mesh is None and opts.distribute:
        mesh = make_flat_mesh(device=device)
    dev = (mesh.device if mesh is not None and device is None
           else resolve_device(device))
    robust = None
    a_sym = a
    with _ot.ensure(opts.trace) as tr:
        mark = tr.mark() if tr is not None else 0
        if opts.pivot == "static":
            with _ot.span("robust_prepass"):
                if values is None:
                    values = generic_values_csr(a)
                elif isinstance(values, torch.Tensor):
                    values = values.detach().cpu().numpy()
                a_sym, robust = build_robust_prepass(a, values)
        with _ot.span("analyze"):
            sym = _symbolic_factorize(
                a_sym, concurrency=opts.concurrency, backend=opts.backend,
                combined=opts.combined, bubble=opts.bubble,
                use_arena=opts.use_arena, budget_bytes=opts.budget_bytes,
                checkpoint_path=opts.checkpoint_path,
                detect_supernodes=True,
                supernode_relax=opts.supernode_relax,
                supernode_max_size=opts.supernode_max_size,
                collect_pattern=True, mesh=mesh, runtime=opts.runtime,
                device=dev, on_progress=on_progress)
            supernodes, tuned, opts = _partition_with_blocking(
                sym.pattern, sym.supernodes, sym.fingerprints, opts, peaks)
            structure = _plan_structure(sym.pattern, supernodes, a_sym, opts)
            placement = None
            if mesh is not None:
                placement = build_placement(structure["schedule"], mesh.size,
                                            axis=mesh.axis_names[0])
            elif opts.runtime == "dynamic":
                # the dynamic runtime drove every visible device through the
                # analyze; factorize/solve get the matching segments
                placement = build_placement(structure["schedule"],
                                            visible_device_count(),
                                            axis=FLAT_AXIS)
        stats = tr.summary(mark) if tr is not None else None
    return LUPlan(a=a, options=opts, sym=sym, pattern=sym.pattern,
                  **structure, analyze_s=time.perf_counter() - t0,
                  device=str(dev), stats=stats, robust=robust,
                  factored=a_sym if robust is not None else None,
                  tuned=tuned, placement=placement)


def replan(plan: LUPlan, options: Optional[LUOptions] = None, *,
           peaks: Optional[dict] = None) -> LUPlan:
    """Re-derive a plan under new partition knobs WITHOUT re-running the
    symbolic fixpoint.

    The supernode partition, schedules, gather/scatter maps, storage
    template and solve DAGs are cheap derivations from the plan's retained
    O(n) column fingerprints and sparse pattern; ``replan`` re-runs exactly
    those for ``options`` (defaults to the plan's own) — the blocking merge
    pass and the autotune sweep included — on the host.  Returns a NEW
    ``LUPlan`` on the same device (the input plan is untouched); with the
    plan's own knobs it factorizes bitwise like the plan.  The static-
    pivoting transform is the plan's.  Raises ``ValueError`` for a plan
    whose symbolic result kept no fingerprints.
    """
    t0 = time.perf_counter()
    opts = options if options is not None else plan.options
    fp = getattr(plan.sym, "fingerprints", None)
    if fp is None:
        raise ValueError(
            "plan retains no column fingerprints (symbolic ran without "
            "supernode detection); re-run repro_torch.analyze() to rebuild "
            "it")
    with _ot.ensure(opts.trace) as tr:
        mark = tr.mark() if tr is not None else 0
        with _ot.span("replan"):
            supernodes = detect_from_fingerprints(
                fp, relax=opts.supernode_relax,
                max_size=opts.supernode_max_size)
            supernodes, tuned, opts = _partition_with_blocking(
                plan.pattern, supernodes, fp, opts, peaks)
            structure = _plan_structure(plan.pattern, supernodes,
                                        plan.a_factored, opts)
            placement = None
            if plan.placement is not None:
                placement = build_placement(structure["schedule"],
                                            plan.placement.n_devices,
                                            axis=plan.placement.axis)
        stats = tr.summary(mark) if tr is not None else None
    return LUPlan(a=plan.a, options=opts, sym=plan.sym, pattern=plan.pattern,
                  **structure,
                  analyze_s=plan.analyze_s + (time.perf_counter() - t0),
                  device=plan.device, stats=stats, robust=plan.robust,
                  factored=plan.factored, tuned=tuned, placement=placement)
