"""Sparse solve on the packed supernodal factors (DESIGN.md §9).

Supernodal forward/backward triangular substitution over the packed device
blocks, plus iterative refinement:

* **Forward** (L y = b, unit diagonal): per level, solve every panel's
  diagonal block against y[s:e], then push ``y[below] -= L(below, J) @
  y[s:e]`` in ascending panel order.
* **Backward** (U x = y): per level, solve the upper diagonal blocks, then
  pull ``x[above] -= U(above, J) @ x[s:e]`` through the above-diagonal rows.
* **Level schedules** — substitution has its own dependency DAGs, not the
  factorization's (``build_solve_schedule``); the diagonal solves within a
  level are independent (run per device segment under a placement), the
  pushes are applied in ascending panel order.
* **Iterative refinement** — r = b - A x via the O(nnz) CSR matvec,
  re-solve on the factors, accept only improving corrections, so the
  recorded relative-residual history is non-increasing by construction.
* **Static pivoting** — with a ``transform`` (the plan's
  ``robust.DeviceRobust``) every inner factored solve runs on
  ``apply_rhs(rhs)`` and maps back through ``apply_solution``, while the
  refinement matvec stays against the ORIGINAL matrix and values.
* **Transposed substitution** — ``solve_factored_transposed`` (A_f^{-T}
  b = L^{-T} U^{-T} b) for the robust tier's condition estimate.

Everything runs on the factors' device; nothing materializes (n, n).

``solve_batch`` is the batched tier's counterpart over the B systems of a
``BatchedNumericResult``: the sequential ``solve`` on each system's
zero-copy store view — a batched cuBLAS product or triangular solve need
not be bitwise its per-matrix form, and every system's x, residual history
and accepted count must be bitwise the sequential ``solve``'s.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.numeric.storage import BatchedPanelStore, PanelStore
from repro_torch.numeric.supernodal import BatchedNumericResult, NumericResult
from repro_torch.obs import trace as _ot
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.numeric import CsrOperator


@dataclasses.dataclass
class SolveSchedule:
    """Dependency levels of the two substitution sweeps (panel ids per
    level, execution order: forward ascending, backward descending)."""

    fwd_levels: List[np.ndarray]
    bwd_levels: List[np.ndarray]

    @property
    def n_fwd_levels(self) -> int:
        return len(self.fwd_levels)

    @property
    def n_bwd_levels(self) -> int:
        return len(self.bwd_levels)


def build_solve_schedule(store: PanelStore) -> SolveSchedule:
    """Level both substitution DAGs from the packed row structure.

    Forward: K -> J iff panel K has below-diagonal rows inside J's column
    range (L block).  Backward: J -> K (J later) iff panel J has
    above-diagonal rows inside K's range (U block).
    """
    k = store.n_panels
    fwd = np.zeros(k, dtype=np.int64)
    bwd = np.zeros(k, dtype=np.int64)
    for j in range(k):
        s, e = store.supernodes[j]
        d = int(store.diag[j])
        below = store.rows[j][d + (e - s):]
        if len(below):
            tgt = np.unique(store.sup_of_col[below])
            fwd[tgt] = np.maximum(fwd[tgt], fwd[j] + 1)
    for j in range(k - 1, -1, -1):
        above = store.rows[j][:store.diag[j]]
        if len(above):
            tgt = np.unique(store.sup_of_col[above])
            bwd[tgt] = np.maximum(bwd[tgt], bwd[j] + 1)
    fwd_levels = [np.flatnonzero(fwd == lv)
                  for lv in range(int(fwd.max()) + 1 if k else 0)]
    bwd_levels = [np.flatnonzero(bwd == lv)
                  for lv in range(int(bwd.max()) + 1 if k else 0)]
    return SolveSchedule(fwd_levels=fwd_levels, bwd_levels=bwd_levels)


def _solve_schedule_of(store: PanelStore) -> SolveSchedule:
    sched = getattr(store, "_solve_schedule", None)
    if sched is None:
        sched = build_solve_schedule(store)
        store._solve_schedule = sched
    return sched


def _level_iter(store: PanelStore, level: np.ndarray):
    """Per-device segments of one level (the plan's ``PanelPlacement``,
    handed to the store as ``_placement``) — a single all-panels segment
    without one.  Diagonal solves within a level are independent and write
    disjoint ranges, so segment grouping never changes a float op."""
    placement = getattr(store, "_placement", None)
    if placement is None or placement.n_devices <= 1:
        return (level,)
    return tuple(seg for seg in placement.segments(level) if len(seg))


def _batched_solve_unit_lower(mats: torch.Tensor,
                              rhs: torch.Tensor) -> torch.Tensor:
    """Forward substitution over stacked panels: ``mats`` (p, w, w)
    L\\U-packed unit-lower blocks against ``rhs`` (p, w, k), in place — one
    row sweep per level-width group instead of p triangular solves."""
    w = mats.shape[1]
    for i in range(1, w):
        rhs[:, i, :] -= torch.einsum("pj,pjk->pk", mats[:, i, :i],
                                     rhs[:, :i, :])
    return rhs


def _batched_solve_upper(mats: torch.Tensor,
                         rhs: torch.Tensor) -> torch.Tensor:
    """Backward substitution over stacked panels (non-unit upper)."""
    w = mats.shape[1]
    for i in range(w - 1, -1, -1):
        if i + 1 < w:
            rhs[:, i, :] -= torch.einsum("pj,pjk->pk", mats[:, i, i + 1:],
                                         rhs[:, i + 1:, :])
        rhs[:, i, :] /= mats[:, i, i][:, None]
    return rhs


def _level_diag_solves(store: PanelStore, level: np.ndarray, y: torch.Tensor,
                       *, lower: bool, batched: bool) -> None:
    """Phase 1 of one substitution level: every panel's diagonal solve.

    ``batched=True`` groups the level's panels by width and runs ONE
    stacked row sweep per group; otherwise each panel is one triangular
    solve.  The solves touch disjoint ``y[s:e]`` ranges either way."""
    sn = store.supernodes
    widths = sn[level, 1] - sn[level, 0]
    if batched:
        multi = y.dim() == 2
        for w in np.unique(widths):
            ids = level[widths == w]
            if w == 1:
                if not lower:          # unit lower: nothing to solve
                    starts = torch.as_tensor(sn[ids, 0], device=y.device)
                    diag = torch.stack([store.diag_block(int(j))[0, 0]
                                        for j in ids])
                    y[starts] = y[starts] / (diag if y.dim() == 1
                                             else diag[:, None])
                continue
            mats = torch.stack([store.diag_block(int(j)) for j in ids])
            rhs = torch.stack([y[s:e] for s, e in sn[ids]])
            if not multi:
                rhs = rhs[:, :, None]
            rhs = (_batched_solve_unit_lower(mats, rhs) if lower
                   else _batched_solve_upper(mats, rhs))
            for i, (s, e) in enumerate(sn[ids]):
                y[s:e] = rhs[i] if multi else rhs[i, :, 0]
        return
    for seg in _level_iter(store, level):
        for j in seg:
            s, e = sn[j]
            w = e - s
            diag = store.diag_block(int(j))
            if lower:
                if w > 1:
                    rhs = y[s:e] if y.dim() == 2 else y[s:e, None]
                    sol = torch.linalg.solve_triangular(
                        diag, rhs, upper=False, unitriangular=True)
                    y[s:e] = sol if y.dim() == 2 else sol[:, 0]
            else:
                if w == 1:
                    y[s] = y[s] / diag[0, 0]
                else:
                    rhs = y[s:e] if y.dim() == 2 else y[s:e, None]
                    sol = torch.linalg.solve_triangular(diag, rhs,
                                                        upper=True)
                    y[s:e] = sol if y.dim() == 2 else sol[:, 0]


def _row_index(store: PanelStore):
    if store.index is None:
        raise ValueError("store has no device index; factor it first")
    return store.index


def forward_substitute(store: PanelStore, b: torch.Tensor, *,
                       batched: Optional[bool] = None) -> torch.Tensor:
    """y with L y = b (unit-lower L in the packed blocks).

    Each level runs in two phases: the independent diagonal solves (batched
    into one stacked sweep per level-width group when ``batched``; ``None``
    batches for multi-RHS ``b``), then the pushes in ascending panel order.
    """
    y = b.clone()
    if batched is None:
        batched = y.dim() == 2
    below_rows = _row_index(store).below
    with _ot.span("solve_forward"):
        for level in _solve_schedule_of(store).fwd_levels:
            with _ot.span("fwd_level"):
                _level_diag_solves(store, level, y, lower=True,
                                   batched=batched)
                for j in level:               # ascending: fwd_levels sorted
                    below = below_rows[j]
                    if below is not None:
                        s, e = store.supernodes[j]
                        lo = int(store.diag[j]) + int(e - s)
                        y[below] -= store.blocks[j][lo:] @ y[s:e]
    return y


def backward_substitute(store: PanelStore, y: torch.Tensor, *,
                        batched: Optional[bool] = None) -> torch.Tensor:
    """x with U x = y (upper U in the packed blocks); same two-phase level
    structure as ``forward_substitute``."""
    x = y.clone()
    if batched is None:
        batched = x.dim() == 2
    above_rows = _row_index(store).above
    with _ot.span("solve_backward"):
        for level in _solve_schedule_of(store).bwd_levels:
            with _ot.span("bwd_level"):
                _level_diag_solves(store, level, x, lower=False,
                                   batched=batched)
                for j in level:
                    above = above_rows[j]
                    if above is not None:
                        s, e = store.supernodes[j]
                        x[above] -= store.blocks[j][:int(store.diag[j])] \
                            @ x[s:e]
    return x


def solve_factored(num: NumericResult, b: torch.Tensor, *,
                   batched: Optional[bool] = None) -> torch.Tensor:
    """x = U^{-1} L^{-1} b on the packed factors (no refinement)."""
    return backward_substitute(num.store,
                               forward_substitute(num.store, b,
                                                  batched=batched),
                               batched=batched)


# -- transposed substitution (the robust tier's condition estimate) ---------
#
# Hager's 1-norm condition estimator needs A^{-T} applied to a vector, which
# the packed factors give as L^{-T} U^{-T}.  The sweeps mirror the primal
# ones with reading and writing roles swapped: L^T pulls a panel's own range
# from its *below* rows (owned by later panels, so a plain descending panel
# walk is topologically correct), U^T pulls from the *above* rows (earlier
# panels, ascending walk).  These are diagnostic paths (a handful of solves
# per quality estimate), so they stay serial and unscheduled.


def backward_substitute_t(store: PanelStore, b: torch.Tensor) -> torch.Tensor:
    """x with L^T x = b (unit-lower L in the packed blocks, transposed)."""
    x = b.clone()
    below_rows = _row_index(store).below
    with _ot.span("solve_backward_t"):
        for j in range(store.n_panels - 1, -1, -1):
            s, e = (int(v) for v in store.supernodes[j])
            d = int(store.diag[j])
            below = below_rows[j]
            if below is not None:
                x[s:e] -= store.blocks[j][d + e - s:].T @ x[below]
            if e - s > 1:
                x[s:e] = torch.linalg.solve_triangular(
                    store.blocks[j][d:d + e - s].T, x[s:e, None], upper=True,
                    unitriangular=True)[:, 0]
    return x


def forward_substitute_t(store: PanelStore, b: torch.Tensor) -> torch.Tensor:
    """w with U^T w = b (upper U in the packed blocks, transposed)."""
    y = b.clone()
    above_rows = _row_index(store).above
    with _ot.span("solve_forward_t"):
        for j in range(store.n_panels):
            s, e = (int(v) for v in store.supernodes[j])
            d = int(store.diag[j])
            above = above_rows[j]
            if above is not None:
                y[s:e] -= store.blocks[j][:d].T @ y[above]
            diag = store.blocks[j][d:d + e - s]
            if e - s == 1:
                y[s] = y[s] / diag[0, 0]
            else:
                y[s:e] = torch.linalg.solve_triangular(
                    diag.T, y[s:e, None], upper=False)[:, 0]
    return y


def solve_factored_transposed(num: NumericResult,
                              b: torch.Tensor) -> torch.Tensor:
    """z = A^{-T} b = L^{-T} U^{-T} b on the packed factors, ``b`` (n,)."""
    return backward_substitute_t(num.store,
                                 forward_substitute_t(num.store, b))


@dataclasses.dataclass
class SolveResult:
    """Solution + convergence history of one ``solve`` call.

    ``x`` is a float64 tensor on the factors' device, (n,) or (n, k); each
    ``residuals`` entry is the worst (max) per-column relative residual.
    ``factor_s`` is 0.0 here — the factorization time lives on the factor.
    """

    x: torch.Tensor
    residuals: List[float]       # relative 2-norm residuals: initial solve,
                                 # then after each *accepted* refinement
    num: NumericResult
    factor_s: float
    solve_s: float               # substitution + refinement time
    refine_accepted: int

    @property
    def residual(self) -> float:
        return self.residuals[-1]

    @property
    def elapsed_s(self) -> float:
        return self.factor_s + self.solve_s


def _col_residuals(matvec, x: torch.Tensor, b: torch.Tensor,
                   b_norms: torch.Tensor) -> np.ndarray:
    """(k,) per-column relative 2-norm residuals ((1,) for vector RHS)."""
    r = b - matvec(x)
    norms = torch.linalg.norm(r, dim=0).reshape(-1)
    return (norms / b_norms).cpu().numpy()


def solve(a: CSRMatrix, b, *, values, num: NumericResult,
          refine_iters: int = 2, refine_tol: Optional[float] = None,
          batched: Optional[bool] = None,
          matvec: Optional[CsrOperator] = None,
          transform=None) -> SolveResult:
    """Solve A x = b on the factors ``num`` of ``values`` (CSR-aligned, the
    values the factorization was built from), with iterative refinement.

    ``b`` is (n,) or (n, k) (numpy or tensor); it moves to the factors'
    device.  ``refine_iters`` bounds the refinement sweeps; a correction is
    accepted per column only if it lowers that column's relative residual,
    so the (worst-column) ``residuals`` history is non-increasing;
    refinement stops early once every column is at or below ``refine_tol``
    (default 1e-14).  ``matvec`` reuses a prebuilt ``CsrOperator`` of
    (a, values).

    ``transform`` (a ``robust.DeviceRobust``, or a ``RobustPlan``) wires the
    static-pivoting permutation and scalings around every inner factored
    solve: ``num`` holds the factors of ``A_f = Dr·P·A·Dc``, so each
    substitution runs on ``apply_rhs(rhs)`` and maps back through
    ``apply_solution``, while ``a``/``values``/``b`` stay the ORIGINAL
    system the refinement iterates against.  ``None`` leaves the float
    operations those of the untransformed path.
    """
    t0 = time.perf_counter()
    dev = num.store.device
    b = torch.as_tensor(b, dtype=torch.float64, device=dev)
    if (b.dim() not in (1, 2) or b.shape[0] != a.n
            or (b.dim() == 2 and b.shape[1] == 0)):
        raise ValueError(f"b must be ({a.n},) or ({a.n}, k>=1), "
                         f"got {tuple(b.shape)}")
    if matvec is None:
        matvec = CsrOperator(a, torch.as_tensor(values, dtype=torch.float64,
                                                device=dev))
    if refine_tol is None:
        refine_tol = 1e-14

    if transform is None:
        def fsolve(rhs):
            return solve_factored(num, rhs, batched=batched)
    else:
        def fsolve(rhs):
            return transform.apply_solution(
                solve_factored(num, transform.apply_rhs(rhs),
                               batched=batched))

    b_norms = torch.linalg.norm(b, dim=0).reshape(-1)
    b_norms = torch.where(b_norms == 0.0, 1.0, b_norms)
    with _ot.span("solve"):
        x = fsolve(b)
        res_cols = _col_residuals(matvec, x, b, b_norms)
        residuals = [float(res_cols.max())]
        accepted = 0
        for _ in range(max(0, refine_iters)):
            if res_cols.max() <= refine_tol:
                break
            with _ot.span("refine"):
                x_try = x + fsolve(b - matvec(x))
                res_try = _col_residuals(matvec, x_try, b, b_norms)
                improve = res_try < res_cols
                if not improve.any():
                    break              # no column improving — keep best x
                if x.dim() == 1:
                    x = x_try
                else:                  # accept only the improving columns
                    keep = torch.as_tensor(improve, device=dev)
                    x[:, keep] = x_try[:, keep]
                res_cols = np.where(improve, res_try, res_cols)
                residuals.append(float(res_cols.max()))
                accepted += 1
    return SolveResult(x=x, residuals=residuals, num=num, factor_s=0.0,
                       solve_s=time.perf_counter() - t0,
                       refine_accepted=accepted)


# -- batched-over-systems tier ----------------------------------------------


def forward_substitute_batch(bstore: BatchedPanelStore,
                             b: torch.Tensor) -> torch.Tensor:
    """y_i with L_i y_i = b_i for every system, ``b`` (B, n) or (B, n, k):
    ``forward_substitute`` on each system's zero-copy store view."""
    return torch.stack([forward_substitute(bstore.system(i), b[i])
                        for i in range(bstore.batch)])


def backward_substitute_batch(bstore: BatchedPanelStore,
                              y: torch.Tensor) -> torch.Tensor:
    """x_i with U_i x_i = y_i for every system (``backward_substitute`` on
    each system's view)."""
    return torch.stack([backward_substitute(bstore.system(i), y[i])
                        for i in range(bstore.batch)])


def solve_factored_batch(bnum: BatchedNumericResult,
                         b: torch.Tensor) -> torch.Tensor:
    """x_i = U_i^{-1} L_i^{-1} b_i for every system of the batched factors,
    ``b`` (B, n) or (B, n, k) (no refinement)."""
    return backward_substitute_batch(
        bnum.store, forward_substitute_batch(bnum.store, b))


@dataclasses.dataclass
class BatchedSolveResult:
    """Solutions + per-system convergence histories of one ``solve_batch``.

    ``x`` is (B, n) or (B, n, k) on the factors' device; ``residuals[i]``
    is system i's accepted worst-column relative-residual history and
    ``refine_accepted`` the (B,) accepted-correction counts — each what the
    sequential ``solve`` of that system records.
    """

    x: torch.Tensor
    residuals: List[List[float]]
    num: BatchedNumericResult
    solve_s: float
    refine_accepted: np.ndarray

    @property
    def batch(self) -> int:
        return self.num.batch

    @property
    def residual(self) -> np.ndarray:
        """(B,) final per-system worst-column relative residuals."""
        return np.array([h[-1] for h in self.residuals])

    def system(self, i: int) -> SolveResult:
        """System i as a sequential ``SolveResult`` (a view of ``x``)."""
        return SolveResult(x=self.x[i], residuals=list(self.residuals[i]),
                           num=self.num.system(i), factor_s=0.0,
                           solve_s=0.0,
                           refine_accepted=int(self.refine_accepted[i]))


def solve_batch(a: CSRMatrix, b, values_batch, bnum: BatchedNumericResult,
                *, refine_iters: int = 2, refine_tol: Optional[float] = None,
                matvecs: Optional[List[CsrOperator]] = None,
                transform=None) -> BatchedSolveResult:
    """Substitution + iterative refinement for all B factored systems:
    ``b`` is (B, n) or (B, n, k), ``values_batch`` the (B, nnz) stack
    ``bnum`` was factored from (each system refines against its OWN
    matrix; ``matvecs`` reuses prebuilt ``CsrOperator`` s).

    Each system is the sequential ``solve`` on its zero-copy store view and
    a fresh copy of its right-hand side, so every system's x, residual
    history and accepted count are that call's: the refinement stops per
    system and accepts whole x for a vector RHS, per column for (B, n, k).
    ``transform`` wires the static-pivoting transform around each system's
    factored solves, as in ``solve``.
    """
    t0 = time.perf_counter()
    bsz, n = bnum.batch, bnum.n
    dev = bnum.store.device
    b = torch.as_tensor(b, dtype=torch.float64, device=dev)
    if (b.dim() not in (2, 3) or b.shape[0] != bsz or b.shape[1] != n
            or (b.dim() == 3 and b.shape[2] == 0)):
        raise ValueError(f"b must be ({bsz}, {n}) or ({bsz}, {n}, k>=1), "
                         f"got {tuple(b.shape)}")
    values_batch = torch.as_tensor(values_batch, dtype=torch.float64,
                                   device=dev)
    if values_batch.dim() != 2 or values_batch.shape[0] != bsz:
        raise ValueError(f"values_batch must be ({bsz}, nnz), got "
                         f"{tuple(values_batch.shape)}")
    if matvecs is None:
        matvecs = [CsrOperator(a, values_batch[i]) for i in range(bsz)]
    with _ot.span("solve_batch"):
        res = [solve(a, b[i].clone(), values=values_batch[i],
                     num=bnum.system(i), refine_iters=refine_iters,
                     refine_tol=refine_tol, matvec=matvecs[i],
                     transform=transform)
               for i in range(bsz)]
    return BatchedSolveResult(
        x=torch.stack([r.x for r in res]),
        residuals=[r.residuals for r in res], num=bnum,
        solve_s=time.perf_counter() - t0,
        refine_accepted=np.array([r.refine_accepted for r in res],
                                 dtype=np.int64))
