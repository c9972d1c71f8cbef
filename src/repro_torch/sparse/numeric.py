"""Numeric helpers of the packed LU path: the pivot contract, generic values,
the CSR matvec of iterative refinement, the in-place diagonal-block LU and
its tiny-pivot perturbation (the robust tier).

``generic_values_csr`` stays numpy and keeps ``numpy.random.default_rng``'s
stream, so its values are bitwise those of the reference; ``csr_matvec`` and
``lu_inplace`` run on tensors on any device, and a ``PerturbState`` keeps its
count on the device, read once at the end of a sweep.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.csr import CSRMatrix


class ZeroPivotError(ArithmeticError):
    """No-pivot elimination hit a zero / near-zero / non-finite pivot.

    ``k`` is the global pivot column; the sweep that owns the failure
    annotates where it happened: ``panel``/``level`` from the supernodal
    level schedule, and ``system`` (the batch index) when the
    batched-systems tier trips it.
    """

    def __init__(self, k: int, piv: float, tol: float, *,
                 panel: int | None = None, level: int | None = None,
                 system: int | None = None):
        self.k = int(k)
        self.piv = float(piv)
        self.tol = float(tol)
        self.panel = None if panel is None else int(panel)
        self.level = None if level is None else int(level)
        self.system = None if system is None else int(system)
        super().__init__(self._message())

    def _message(self) -> str:
        where = "".join(
            f" {name} {val}" for name, val in
            (("panel", self.panel), ("level", self.level),
             ("system", self.system)) if val is not None)
        return (f"zero pivot at column {self.k}"
                + (f" [{where.strip()}]" if where else "")
                + f": |{self.piv:.3e}| <= tol {self.tol:.3e} "
                f"(matrix needs pivoting or is singular; "
                f"LUOptions(pivot='static', perturb=True) enables the "
                f"robust tier)")

    def with_context(self, *, panel: int | None = None,
                     level: int | None = None,
                     system: int | None = None) -> "ZeroPivotError":
        """Annotate in-flight attribution and refresh the message.  Returns
        ``self`` so callers can ``raise e.with_context(...)``."""
        if panel is not None:
            self.panel = int(panel)
        if level is not None:
            self.level = int(level)
        if system is not None:
            self.system = int(system)
        self.args = (self._message(),)
        return self


def pivot_tolerance(scale: float) -> float:
    """Default near-zero pivot threshold: machine epsilon at the matrix scale."""
    return np.finfo(np.float64).eps * max(float(scale), 0.0)


#: Default tiny-pivot perturbation magnitude relative to the matrix scale —
#: sqrt(machine eps), the SuperLU_DIST choice: large enough that 1/piv stays
#: harmless, small enough that iterative refinement recovers the accuracy.
PERTURB_EPS = float(np.sqrt(np.finfo(np.float64).eps))


def perturb_threshold(scale: float, eps: float | None = None) -> float:
    """Replacement magnitude for tiny pivots: ``eps·max|A|`` (``eps``
    defaults to ``PERTURB_EPS``)."""
    return (PERTURB_EPS if eps is None else float(eps)) * max(float(scale), 0.0)


class PerturbState:
    """Sweep-scope tiny-pivot perturbation on one device.

    ``threshold`` is the replacement magnitude eps·max|A|: a float for the
    single-system sweep, a (B,) float64 array for the batched tier (each
    system its own).  ``count`` is a device int64 tensor (0-d, or (B,))
    that every bump adds to without a host sync; ``total()`` reads it once.
    Non-finite pivots are never perturbed — they mean the sweep diverged,
    and the pivot check reports them.
    """

    __slots__ = ("threshold", "count", "_pos", "_neg", "_cmp", "_finite")

    def __init__(self, threshold, device):
        thr = np.asarray(threshold, dtype=np.float64)
        self.threshold = float(thr) if thr.ndim == 0 else thr
        self.count = torch.zeros(thr.shape, dtype=torch.int64, device=device)
        # the signed replacements as float64 device tensors, and the
        # comparison bound: a threshold that is not positive bumps nothing
        self._pos = torch.as_tensor(thr, device=device)
        self._neg = torch.as_tensor(-thr, device=device)
        self._cmp = torch.as_tensor(np.where(thr > 0.0, thr, -np.inf),
                                    device=device)
        # a finite threshold never reaches an infinite pivot, so the
        # isfinite test is needed only when a threshold is infinite
        self._finite = bool(np.isfinite(thr).all())

    def bump(self, piv: torch.Tensor) -> None:
        """Replace the tiny finite pivots of ``piv`` (a view of diagonal
        entries: 0-d, or one per system) in place by the signed threshold
        (``piv >= 0`` -> +threshold, so -0.0 goes to +threshold) and count
        them; a threshold of 0.0 bumps nothing."""
        tiny = piv.abs() <= self._cmp
        if not self._finite:
            tiny &= torch.isfinite(piv)
        piv.copy_(torch.where(tiny, torch.where(piv >= 0.0, self._pos,
                                                self._neg), piv))
        self.count += tiny

    def total(self) -> int:
        return int(self.count.sum())


def check_pivot(k: int, piv: float, piv_tol: float) -> None:
    """The pivot contract for one scalar pivot."""
    if not np.isfinite(piv) or abs(piv) <= piv_tol:
        raise ZeroPivotError(k, piv, piv_tol)


def check_pivots(cols: np.ndarray, pivs: torch.Tensor,
                 piv_tol: float) -> None:
    """The pivot contract for many pivots at one host sync: raise for the
    first failing entry (execution order) of ``pivs``, whose global columns
    are ``cols``."""
    bad = ~torch.isfinite(pivs) | (pivs.abs() <= piv_tol)
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0, 0])
        raise ZeroPivotError(int(cols[i]), float(pivs[i]), piv_tol)


def check_pivots_batched(cols: np.ndarray, pivs: torch.Tensor,
                         piv_tol: np.ndarray) -> None:
    """The pivot contract for B systems' pivots ``pivs`` (B, P) at one host
    sync, each system against its own threshold ``piv_tol[i]``: raise for
    the first failing column in execution order, at the lowest failing
    system there — the (column, system) the per-column batched elimination
    would stop at."""
    tol = torch.as_tensor(np.asarray(piv_tol, dtype=np.float64),
                          device=pivs.device)
    bad = ~torch.isfinite(pivs) | (pivs.abs() <= tol[:, None])
    if bool(bad.any()):
        c = int(torch.nonzero(bad.any(dim=0))[0, 0])
        i = int(torch.nonzero(bad[:, c])[0, 0])
        raise ZeroPivotError(int(cols[c]), float(pivs[i, c]),
                             float(piv_tol[i]), system=i)


def generic_values_csr(a: CSRMatrix, seed: int = 0) -> np.ndarray:
    """CSR-aligned (nnz,) random values on A's pattern, diagonally dominant so
    pivot-free elimination is numerically safe — bitwise the reference's
    (same ``default_rng`` stream, same diagonal rule).  Requires every
    diagonal entry to be structurally present."""
    rng = np.random.default_rng(seed)
    vals = np.empty(a.nnz, dtype=np.float64)
    diag_pos = np.full(a.n, -1, dtype=np.int64)
    row_abs_sum = np.zeros(a.n, dtype=np.float64)
    for i in range(a.n):
        lo, hi = int(a.indptr[i]), int(a.indptr[i + 1])
        cols = a.indices[lo:hi]
        v = rng.uniform(0.5, 1.5, size=len(cols))
        vals[lo:hi] = v
        row_abs_sum[i] = np.abs(v).sum()
        d = np.searchsorted(cols, i)
        if d >= len(cols) or cols[d] != i:
            raise ValueError(
                f"generic_values_csr needs a structural diagonal; row {i} "
                f"has none")
        diag_pos[i] = lo + d
    vals[diag_pos] = row_abs_sum + 1.0
    return vals


class CsrOperator:
    """y = A @ x with CSR-aligned float64 values on one device — the O(nnz)
    matvec of iterative refinement.  The row lengths and column indices go
    to the device once; ``x`` may be (n,) or a multi-RHS block (n, k),
    reduced one column at a time as the reference's per-column bincount.

    Each row is summed by ``torch.segment_reduce``, which takes no atomics:
    the same inputs give the same bits on every run, on the card too
    (``index_add_`` sums a row with atomics there, in whatever order they
    land), so a solve can be repeated — and the batched tier's solves
    checked — bitwise."""

    def __init__(self, a: CSRMatrix, vals: torch.Tensor):
        dev = vals.device
        self.n = a.n
        self.vals = vals
        self.lengths = torch.as_tensor(np.diff(a.indptr).astype(np.int64),
                                       device=dev)
        self.cols = torch.as_tensor(a.indices.astype(np.int64), device=dev)

    def _rows(self, prod: torch.Tensor) -> torch.Tensor:
        return torch.segment_reduce(prod, "sum", lengths=self.lengths,
                                    unsafe=True)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 1:
            return self._rows(x[self.cols] * self.vals)
        return torch.stack([self._rows(x[self.cols, c] * self.vals)
                            for c in range(x.shape[1])], dim=1)


def csr_matvec(a: CSRMatrix, vals: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """One-off ``A @ x`` (see ``CsrOperator`` for repeated products)."""
    return CsrOperator(a, vals)(x)


def lu_inplace(m: torch.Tensor, *,
               perturb: PerturbState | None = None) -> None:
    """In-place no-pivot right-looking elimination of the square block ``m``
    (L strictly below, U on/above the diagonal) on its device.  Pivots are
    not checked here: after the call ``m.diagonal()`` holds every pivot the
    elimination divided by, and the caller checks them in one batch
    (``check_pivots``) instead of one host sync per column.

    With ``perturb`` every column's pivot, the last one too, is bumped in
    place before its division (``PerturbState.bump``), so the check sees
    the bumped diagonal; with None the float operations are exactly the
    unperturbed ones."""
    w = m.shape[0]
    for t in range(w):
        if perturb is not None:
            perturb.bump(m[t, t])
        if t < w - 1:
            m[t + 1:, t] /= m[t, t]
            m[t + 1:, t + 1:] -= torch.outer(m[t + 1:, t], m[t, t + 1:])


def lu_inplace_batched(m: torch.Tensor, *,
                       perturb: PerturbState | None = None) -> None:
    """``lu_inplace`` over a leading system axis: ``m`` is (B, w, w), one
    same-structure diagonal block per system.  Every operation is
    elementwise (a division by the pivot and an outer-product update), so
    each slice is bitwise ``lu_inplace`` on that system alone; ``perturb``
    bumps each system's pivot against its own threshold.  Pivots are
    checked by the caller (``check_pivots_batched``)."""
    w = m.shape[1]
    for t in range(w):
        if perturb is not None:
            perturb.bump(m[:, t, t])
        if t < w - 1:
            m[:, t + 1:, t] /= m[:, t, t, None]
            m[:, t + 1:, t + 1:] -= (m[:, t + 1:, t, None]
                                     * m[:, t, None, t + 1:])
