"""Plan/factor session API on PyTorch: analyze once, refactorize many, solve
multi-RHS — on one CUDA device by default::

    import repro_torch

    plan = repro_torch.analyze(a, repro_torch.LUOptions(concurrency=512))
    for values in value_stream:            # same pattern, new values
        factor = plan.factorize(values)    # numeric sweep only, on the card
        result = factor.solve(b)           # b is (n,) or multi-RHS (n, k)

    batch = plan.factorize_batch(values_batch)   # (B, nnz): one sweep
    results = batch.solve_batch(b_batch)         # (B, n) or (B, n, k)

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

The default device is the card (``device=None`` -> ``"cuda"``); without
CUDA ``analyze`` raises instead of running on the CPU.  Pass
``device="cpu"`` to run the whole path on the CPU (the kernels' plain
versions), as the tests do.  Plans hold numpy arrays and plain dataclasses
only — device copies of the maps live in a cache that is not pickled — so
an analysis pickles and replays anywhere its device exists.

``LUOptions`` keeps exactly the fields, defaults and validation of
``repro.LUOptions``; options that belong to later slices of the port raise
``NotImplementedError`` naming the ``ROADMAP.md`` item.
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
from repro_torch.numeric.schedule import (
    PanelSchedule, build_gather_maps, build_schedule, build_update_maps,
    device_maps,
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
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.numeric import CsrOperator, generic_values_csr

_SYMBOLIC_BACKENDS = ("ell", "dense", "kernel")
_NUMERIC_BACKENDS = ("numpy", "kernel")
_POLICIES = ("lpt", "contiguous")
_RUNTIMES = ("static", "dynamic")
_PIVOTS = ("none", "static")

# options of later slices: (is it requested?, what it is, ROADMAP.md item)
_LATER_SLICES = (
    (lambda o: o.pivot == "static", "pivot='static' (static pivoting)", 9),
    (lambda o: o.perturb, "perturb=True (tiny-pivot perturbation)", 9),
    (lambda o: o.blocking, "blocking=True (structure-aware blocking)", 9),
    (lambda o: o.autotune, "autotune=True (roofline autotune)", 9),
    (lambda o: o.distribute, "distribute=True (multi-device)", 10),
    (lambda o: o.runtime == "dynamic",
     "runtime='dynamic' (work-stealing runtime)", 10),
)


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

    Numeric: ``n_bins``/``policy`` (pack_panels within-level grouping),
    ``numeric_backend`` ("numpy" = float64 torch, "kernel" = float32 K3/K4),
    ``piv_tol`` (zero-pivot threshold; None = eps at matrix scale),
    ``check_pattern``/``pattern_tol``, ``segment_batch`` (stack same-shape
    panel GEMMs of a level into one dispatch).

    Solve: ``refine_iters``/``refine_tol``.  Observability: ``trace``.

    ``pivot="static"``, ``perturb``, ``blocking``, ``autotune``,
    ``distribute`` and ``runtime="dynamic"`` are later slices of the port
    and raise ``NotImplementedError``.
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
        for requested, what, item in _LATER_SLICES:
            if requested(self):
                raise NotImplementedError(
                    f"LUOptions({what}) is not ported to repro_torch yet: "
                    f"ROADMAP.md Queue A item {item}")

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
    _matvec: Optional[CsrOperator] = dataclasses.field(default=None,
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
            batched=batched, matvec=self._matvec)

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

    def system(self, i: int) -> LUFactorization:
        """System i as a sequential ``LUFactorization`` (zero-copy factor
        views; its ``factor_s`` is 0.0 — the batch owns the timing)."""
        return LUFactorization(plan=self.plan, num=self.num.system(i),
                               values=self.values[i], factor_s=0.0)

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
            matvecs=self._matvecs)


@dataclasses.dataclass
class LUPlan:
    """One matrix structure, analyzed once on ``device``: the symbolic
    prediction plus every value-independent precomputation of the numeric
    pipeline.  Picklable: numpy arrays and plain dataclasses only; the
    device copies of the maps (``_device_cache``) are rebuilt on the first
    ``factorize`` after unpickling."""

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
    _device_cache: Dict = dataclasses.field(default_factory=dict, repr=False)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_device_cache"] = {}
        return state

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

    def _device_state(self, dev: torch.device):
        """(store index, per-panel device gather maps, trailing-update
        tables) on ``dev``, built on first use and cached for every later
        factorization."""
        key = str(dev)
        if key not in self._device_cache:
            self._device_cache[key] = (
                self.store_template.build_index(self.csr_maps, dev),
                device_maps(self.gather_maps, dev),
                build_update_maps(self.store_template, self.schedule,
                                  self.gather_maps).to(dev))
        return self._device_cache[key]

    def factorize(self, values=None, *,
                  _reuse_store: Optional[PanelStore] = None
                  ) -> LUFactorization:
        """Numeric factorization of CSR-aligned ``values`` ((nnz,), numpy or
        tensor; defaults to ``generic_values_csr``) on the plan's device."""
        t0 = time.perf_counter()
        if values is None:
            values = generic_values_csr(self.a)
        dev = resolve_device(self.device)
        values = torch.as_tensor(values, dtype=torch.float64, device=dev)
        index, maps, update_maps = self._device_state(dev)
        store = (_reuse_store if _reuse_store is not None
                 else PanelStore.from_structure(self.store_template, dev,
                                                index))
        store._solve_schedule = self.solve_schedule
        with _ot.ensure(self.options.trace) as tr:
            mark = tr.mark() if tr is not None else 0
            with _ot.span("factorize"):
                num = factor_on_store(
                    self.a, values, store, self.schedule,
                    backend=self.options.numeric_backend,
                    piv_tol=self.options.piv_tol,
                    check_pattern=self.options.check_pattern,
                    pattern_tol=self.options.pattern_tol,
                    maps=maps, update_maps=update_maps,
                    csr_maps=self.csr_maps,
                    store_is_zeroed=_reuse_store is None,
                    segment_batch=self.options.segment_batch)
            stats = tr.summary(mark) if tr is not None else None
        return LUFactorization(plan=self, num=num, values=values,
                               factor_s=time.perf_counter() - t0,
                               stats=stats)

    def factorize_batch(self, values_batch) -> BatchedLUFactorization:
        """Numeric factorization of B same-pattern value sets in ONE
        batched level sweep on the plan's device: ``values_batch`` is a
        (B, nnz) CSR-aligned stack (numpy or tensor).  The index, gather
        maps and update tables are the plan's (``_device_state``); the
        trailing updates are one mapped K3/K4 launch per level for all B
        systems.  System i's factors are bitwise
        ``self.factorize(values_batch[i])``'s."""
        t0 = time.perf_counter()
        dev = resolve_device(self.device)
        values_batch = torch.as_tensor(values_batch, dtype=torch.float64,
                                       device=dev)
        if values_batch.dim() != 2:
            raise ValueError(
                f"values_batch must be a (B, {self.a.nnz}) CSR-aligned "
                f"stack, got shape {tuple(values_batch.shape)}")
        index, maps, update_maps = self._device_state(dev)
        bstore = BatchedPanelStore(self.store_template,
                                   values_batch.shape[0], dev, index)
        bstore._solve_schedule = self.solve_schedule
        with _ot.ensure(self.options.trace) as tr:
            mark = tr.mark() if tr is not None else 0
            with _ot.span("factorize_batch"):
                num = factor_batch_on_store(
                    self.a, values_batch, bstore, self.schedule,
                    backend=self.options.numeric_backend,
                    piv_tol=self.options.piv_tol,
                    check_pattern=self.options.check_pattern,
                    pattern_tol=self.options.pattern_tol,
                    maps=maps, update_maps=update_maps,
                    csr_maps=self.csr_maps, store_is_zeroed=True,
                    segment_batch=self.options.segment_batch)
            stats = tr.summary(mark) if tr is not None else None
        return BatchedLUFactorization(plan=self, num=num,
                                      values=values_batch,
                                      factor_s=time.perf_counter() - t0,
                                      stats=stats)

    def solve(self, b, values=None) -> SolveResult:
        """Convenience: factorize ``values`` and solve in one call."""
        factor = self.factorize(values)
        res = factor.solve(b)
        res.factor_s = factor.factor_s
        return res


def analyze(a: CSRMatrix, options: Optional[LUOptions] = None, *,
            device=None, mesh=None, on_progress=None) -> LUPlan:
    """Symbolic analysis of ``a`` on ``device`` (default: the card): one
    fixpoint pass streams out the L/U counts, the supernode partition
    (fingerprints, K2) and the sparse ``CSCPattern``; everything
    value-independent downstream is precomputed into the returned
    ``LUPlan``.  No dense (n, n) pattern is materialized on the host or the
    device (the dense adjacency of ``backend="dense"/"kernel"`` is the
    graph, not the pattern).  ``mesh`` (multi-device analysis) is a later
    slice of the port and raises ``NotImplementedError``."""
    t0 = time.perf_counter()
    opts = options if options is not None else LUOptions()
    if mesh is not None:
        raise NotImplementedError(
            "analyze(mesh=...) is not ported to repro_torch yet: ROADMAP.md "
            "Queue A item 10")
    dev = resolve_device(device)
    with _ot.ensure(opts.trace) as tr:
        mark = tr.mark() if tr is not None else 0
        with _ot.span("analyze"):
            sym = _symbolic_factorize(
                a, concurrency=opts.concurrency, backend=opts.backend,
                combined=opts.combined, bubble=opts.bubble,
                use_arena=opts.use_arena, budget_bytes=opts.budget_bytes,
                checkpoint_path=opts.checkpoint_path,
                detect_supernodes=True,
                supernode_relax=opts.supernode_relax,
                supernode_max_size=opts.supernode_max_size,
                collect_pattern=True, device=dev, on_progress=on_progress)
            pattern = sym.pattern
            with _ot.span("build_schedule"):
                schedule = build_schedule(pattern, sym.supernodes,
                                          n_bins=opts.n_bins,
                                          policy=opts.policy)
                store_template = PanelStore(pattern, schedule.supernodes)
            with _ot.span("gather_maps"):
                gather_maps = build_gather_maps(store_template, schedule)
                csr_maps = store_template.csr_maps(a)
            with _ot.span("solve_schedule"):
                solve_schedule = build_solve_schedule(store_template)
        stats = tr.summary(mark) if tr is not None else None
    return LUPlan(a=a, options=opts, sym=sym, pattern=pattern,
                  schedule=schedule, store_template=store_template,
                  gather_maps=gather_maps, csr_maps=csr_maps,
                  solve_schedule=solve_schedule,
                  analyze_s=time.perf_counter() - t0, device=str(dev),
                  stats=stats)
