"""Long-lived solver engine: plan cache + fixed-shape batched dispatch on
the plan's device.

A solver that amortizes symbolic analysis is a *service*: requests carrying
(structure, values, rhs) arrive continuously, most share one of a handful
of sparsity patterns (circuit simulation: Newton iterations, transient
sweeps, Monte Carlo corners over one netlist), and the engine (a) never
re-analyzes a pattern it has seen and (b) never pays per-request sweep
overhead when requests can share one batched sweep:

* **Plan cache** — ``pattern_fingerprint`` content-hashes each request's
  structure; hits reuse the cached ``LUPlan``, misses ``analyze`` once (on
  the engine's ``device``) and insert with LRU eviction.
* **Fixed-shape slots** — requests sharing (pattern, rhs shape) are packed
  into ``batch_slots``-wide chunks; the final partial chunk is padded by
  repeating its last request, so every dispatch sees the same (B, nnz) /
  (B, n) shapes (padded slots are computed and dropped).  Each chunk is ONE
  ``factorize_batch`` + ``solve_batch`` pair: the trailing updates of all
  its systems are one mapped K3/K4 launch per level.
* **Observability** — ``serve.cache.{hit,miss,evict}`` counters,
  ``serve.batch_occupancy`` and a ``serve`` span around every flush, under
  tracing; ``engine.stats`` keeps always-on totals.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.api import LUOptions, LUPlan, analyze
from repro_torch.kernels.ops import resolve_device
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.robust import QualityReport
from repro_torch.serve.cache import PatternKey, PlanCache, pattern_fingerprint


@dataclasses.dataclass
class ServeRequest:
    """One queued (structure, values, rhs) solve request."""

    rid: int
    key: PatternKey
    a: object                    # CSRMatrix (first-seen per pattern wins)
    values: torch.Tensor         # (nnz,) float64, CSR-aligned
    b: torch.Tensor              # (n,) or (n, k) float64


@dataclasses.dataclass
class ServeResult:
    """Per-request outcome: the solution (a float64 tensor on the plan's
    device), its final relative residual, whether the plan came from
    cache, and which batched dispatch (and slot) computed it.  ``quality``
    (engines built with ``quality=True``) carries the factorization's
    ``QualityReport``."""

    rid: int
    x: torch.Tensor
    residual: float
    cache_hit: bool
    batch_id: int
    slot: int
    quality: Optional[QualityReport] = None


class SolverEngine:
    """Long-lived serving front end over the plan/factor session API.

    >>> eng = SolverEngine(LUOptions(concurrency=512), capacity=8,
    ...                    batch_slots=16)
    >>> eng.submit(a, values, b)          # -> request id
    >>> results = eng.flush()             # batched factorize + solve
    >>> eng.solve(a, values, b)           # submit + flush one request

    Results are bitwise those of ``analyze(a, options, device=device)
    .factorize(values).solve(b)`` per request — batching and slot padding
    change scheduling only, never a float op (the batched tier's
    contract).  ``device`` is passed to ``analyze`` (None: the card).
    """

    def __init__(self, options: Optional[LUOptions] = None, *,
                 capacity: int = 8, batch_slots: int = 16,
                 quality: bool = False, device=None):
        if batch_slots <= 0:
            raise ValueError(
                f"batch_slots must be positive, got {batch_slots}")
        self.options = options if options is not None else LUOptions()
        self.cache = PlanCache(capacity)
        self.batch_slots = batch_slots
        self.device = device
        # quality=True attaches a per-request QualityReport (growth /
        # condition / verdict) to every ServeResult — a few extra
        # triangular solves per dispatched slot
        self.quality = quality
        self._queue: List[ServeRequest] = []
        self._next_rid = 0
        self._next_batch = 0
        self.stats: Dict[str, float] = {
            "requests": 0, "cache_hits": 0, "cache_misses": 0,
            "cache_evictions": 0, "batches": 0, "padded_slots": 0,
            "quality_rejects": 0,
            "analyze_s": 0.0, "factor_s": 0.0, "solve_s": 0.0,
        }

    # -- plan cache ---------------------------------------------------------
    def plan_for(self, a) -> LUPlan:
        """The plan for ``a``'s pattern: cache hit (O(1) content-hash
        probe) or a full ``analyze`` inserted with LRU eviction."""
        return self._plan_for(a, pattern_fingerprint(a))[0]

    def _plan_for(self, a, key: PatternKey, values=None):
        plan = self.cache.get(key)
        if plan is not None:
            self.stats["cache_hits"] += 1
            if _ot.ENABLED:
                _om.registry().count("serve.cache.hit")
            return plan, True
        self.stats["cache_misses"] += 1
        if _ot.ENABLED:
            _om.registry().count("serve.cache.miss")
        t0 = time.perf_counter()
        # under static pivoting the first-seen request's values seed the
        # transversal (first-seen per pattern wins, like the structure)
        plan = analyze(a, self.options, values=values, device=self.device)
        self.stats["analyze_s"] += time.perf_counter() - t0
        if self.cache.put(key, plan) is not None:
            self.stats["cache_evictions"] += 1
            if _ot.ENABLED:
                _om.registry().count("serve.cache.evict")
        return plan, False

    # -- request queue ------------------------------------------------------
    def submit(self, a, values, b) -> int:
        """Queue one solve of ``values`` (CSR-aligned (nnz,)) / rhs ``b``
        ((n,) or (n, k)), numpy or tensors, on ``a``'s structure; returns
        the request id used to match ``flush`` results."""
        values = torch.as_tensor(values, dtype=torch.float64)
        b = torch.as_tensor(b, dtype=torch.float64)
        if tuple(values.shape) != (a.nnz,):
            raise ValueError(f"values must be CSR-aligned ({a.nnz},), got "
                             f"{tuple(values.shape)}")
        if b.dim() not in (1, 2) or b.shape[0] != a.n:
            raise ValueError(f"b must be ({a.n},) or ({a.n}, k), got "
                             f"{tuple(b.shape)}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(ServeRequest(rid=rid, key=pattern_fingerprint(a),
                                        a=a, values=values, b=b))
        self.stats["requests"] += 1
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue)

    def flush(self) -> List[ServeResult]:
        """Run every queued request through batched dispatches and return
        results in submission order.

        Requests are grouped by (pattern key, rhs shape); each group is cut
        into ``batch_slots``-wide chunks, the last chunk padded by
        repeating its final request.  Each chunk is ONE ``factorize_batch``
        + ``solve_batch`` pair.
        """
        queue, self._queue = self._queue, []
        if not queue:
            return []
        results: Dict[int, ServeResult] = {}
        groups: "Dict[tuple, List[ServeRequest]]" = {}
        for req in queue:
            groups.setdefault((req.key, tuple(req.b.shape)), []).append(req)
        with _ot.span("serve"):
            for (key, _shape), reqs in groups.items():
                plan, hit = self._plan_for(reqs[0].a, key,
                                           values=reqs[0].values)
                for lo in range(0, len(reqs), self.batch_slots):
                    chunk = reqs[lo:lo + self.batch_slots]
                    self._dispatch(plan, chunk, hit, results)
        return [results[req.rid] for req in queue]

    def _dispatch(self, plan: LUPlan, chunk: List[ServeRequest],
                  cache_hit: bool, results: Dict[int, ServeResult]) -> None:
        pad = self.batch_slots - len(chunk)
        padded = chunk + [chunk[-1]] * pad
        dev = resolve_device(plan.device)
        values = torch.stack([r.values.to(dev) for r in padded])
        b = torch.stack([r.b.to(dev) for r in padded])
        batch_id = self._next_batch
        self._next_batch += 1
        self.stats["batches"] += 1
        self.stats["padded_slots"] += pad
        if _ot.ENABLED:
            _om.registry().observe("serve.batch_occupancy",
                                   len(chunk) / self.batch_slots)
        t0 = time.perf_counter()
        factor = plan.factorize_batch(values)
        t1 = time.perf_counter()
        solved = factor.solve_batch(b)
        self.stats["factor_s"] += t1 - t0
        self.stats["solve_s"] += time.perf_counter() - t1
        for slot, req in enumerate(chunk):
            quality = None
            if self.quality:
                quality = factor.system(slot).quality()
                if quality.verdict == "reject":
                    self.stats["quality_rejects"] += 1
            results[req.rid] = ServeResult(
                rid=req.rid, x=solved.x[slot],
                residual=float(solved.residuals[slot][-1]),
                cache_hit=cache_hit, batch_id=batch_id, slot=slot,
                quality=quality)

    # -- one-shot convenience ----------------------------------------------
    def solve(self, a, values, b) -> ServeResult:
        """Submit one request and flush immediately (occupancy 1/slots —
        batch real workloads via ``submit`` + ``flush``)."""
        rid = self.submit(a, values, b)
        return next(r for r in self.flush() if r.rid == rid)
