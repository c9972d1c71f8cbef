"""Numeric helpers of the packed LU path: the pivot contract, generic values,
the CSR matvec of iterative refinement, and the in-place diagonal-block LU.

``generic_values_csr`` stays numpy and keeps ``numpy.random.default_rng``'s
stream, so its values are bitwise those of the reference; ``csr_matvec`` and
``lu_inplace`` run on tensors on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.csr import CSRMatrix


class ZeroPivotError(ArithmeticError):
    """No-pivot elimination hit a zero / near-zero / non-finite pivot.

    ``k`` is the global pivot column; the sweep that owns the failure
    annotates where it happened: ``panel``/``level`` from the supernodal
    level schedule.
    """

    def __init__(self, k: int, piv: float, tol: float, *,
                 panel: int | None = None, level: int | None = None):
        self.k = int(k)
        self.piv = float(piv)
        self.tol = float(tol)
        self.panel = None if panel is None else int(panel)
        self.level = None if level is None else int(level)
        super().__init__(self._message())

    def _message(self) -> str:
        where = "".join(
            f" {name} {val}" for name, val in
            (("panel", self.panel), ("level", self.level)) if val is not None)
        return (f"zero pivot at column {self.k}"
                + (f" [{where.strip()}]" if where else "")
                + f": |{self.piv:.3e}| <= tol {self.tol:.3e} "
                f"(matrix needs pivoting or is singular)")

    def with_context(self, *, panel: int | None = None,
                     level: int | None = None) -> "ZeroPivotError":
        """Annotate in-flight attribution and refresh the message.  Returns
        ``self`` so callers can ``raise e.with_context(...)``."""
        if panel is not None:
            self.panel = int(panel)
        if level is not None:
            self.level = int(level)
        self.args = (self._message(),)
        return self


def pivot_tolerance(scale: float) -> float:
    """Default near-zero pivot threshold: machine epsilon at the matrix scale."""
    return np.finfo(np.float64).eps * max(float(scale), 0.0)


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
    matvec of iterative refinement.  The row ids and column indices go to
    the device once; ``x`` may be (n,) or a multi-RHS block (n, k)."""

    def __init__(self, a: CSRMatrix, vals: torch.Tensor):
        dev = vals.device
        self.n = a.n
        self.vals = vals
        self.row_of = torch.as_tensor(
            np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr)),
            device=dev)
        self.cols = torch.as_tensor(a.indices.astype(np.int64), device=dev)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        prod = x[self.cols]
        prod = prod * (self.vals if x.dim() == 1 else self.vals[:, None])
        out = x.new_zeros((self.n,) + tuple(x.shape[1:]))
        return out.index_add_(0, self.row_of, prod)


def csr_matvec(a: CSRMatrix, vals: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """One-off ``A @ x`` (see ``CsrOperator`` for repeated products)."""
    return CsrOperator(a, vals)(x)


def lu_inplace(m: torch.Tensor) -> None:
    """In-place no-pivot right-looking elimination of the square block ``m``
    (L strictly below, U on/above the diagonal) on its device.  Pivots are
    not checked here: after the call ``m.diagonal()`` holds every pivot the
    elimination divided by, and the caller checks them in one batch
    (``check_pivots``) instead of one host sync per column."""
    w = m.shape[0]
    for t in range(w - 1):
        m[t + 1:, t] /= m[t, t]
        m[t + 1:, t + 1:] -= torch.outer(m[t + 1:, t], m[t, t + 1:])
