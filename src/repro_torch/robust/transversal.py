"""Static-pivoting pre-pass: maximum-product transversal + equilibration.

The numeric sweep runs without pivoting on a pattern fixed at analyze time,
so the pivoting budget is spent **once, at analyze time** (the SuperLU_DIST
/ HYLU / GLU3.0 answer): a row permutation that puts the largest attainable
entries on the diagonal (a maximum-weight transversal of the bipartite
value graph, MC64 job=5 style), then row and column scalings that make
every scaled entry O(1), and the permuted, scaled ``A_f = Dr·P·A·Dc`` is
factored with no pivoting.  The permutation and scalings are plan
properties: a refactorization replays an O(nnz) gather + scale of its
values (``DeviceRobust.transform_values`` on the plan's device) — no
symbolic work, no new matching.

The matching and the scaling run on the host (scipy's sparse LAPJVsp,
numpy), once per analysis; ``RobustPlan`` keeps numpy arrays only, so a
plan pickles.  ``RobustPlan.on(device)`` puts the index and scale arrays on
a device once (``LUPlan`` keeps them in its device cache), and the solve
side's transforms run there on tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.sparse.csr import CSRMatrix


class StructurallySingularError(ValueError):
    """The pattern admits no complete transversal: some set of k rows
    touches fewer than k columns (Hall violation), so *no* row permutation
    can produce a zero-free diagonal — the matrix is singular for every
    value assignment and static pivoting cannot help."""


def _entry_triplets(a: CSRMatrix, values: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, |values|) of every stored entry, CSR order."""
    values = np.asarray(values, dtype=np.float64)
    rows = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    cols = a.indices.astype(np.int64)
    if values.ndim == 2:                 # dense (n, n) convenience form
        absv = np.abs(values[rows, cols])
    else:
        if values.shape != (a.nnz,):
            raise ValueError(f"values must be CSR-aligned ({a.nnz},) or "
                             f"dense ({a.n}, {a.n}), got {values.shape}")
        absv = np.abs(values)
    return rows, cols, absv


def _matching(n: int, rows: np.ndarray, cols: np.ndarray,
              weights: np.ndarray) -> np.ndarray:
    """perm with ``perm[j]`` = the row matched to column j, maximizing the
    product of ``weights`` over the transversal.  Raises ``ValueError``
    (from scipy) when no complete matching exists on these edges."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching

    # max prod w_ij == min sum (log colmax_j - log w_ij); the +1 shift keeps
    # every stored cost strictly positive (scipy treats stored zeros as
    # absent edges)
    colmax = np.zeros(n, dtype=np.float64)
    np.maximum.at(colmax, cols, weights)
    cost = np.log(colmax[cols]) - np.log(weights) + 1.0
    graph = sp.csr_matrix((cost, (rows, cols)), shape=(n, n))
    row_ind, col_ind = min_weight_full_bipartite_matching(graph)
    perm = np.empty(n, dtype=np.int64)
    perm[col_ind] = row_ind
    return perm


def max_product_transversal(a: CSRMatrix, values: np.ndarray) -> np.ndarray:
    """Row permutation ``perm`` with factored row j = original row
    ``perm[j]``, chosen to maximize ``prod_j |A[perm[j], j]|``.

    Zero-valued stored entries are excluded from the weighted matching
    (log-weight undefined; a zero on the diagonal is exactly what we are
    permuting *away* from).  If the nonzero-value support has no complete
    matching, falls back to a structural matching over the full pattern
    (unit weights); only a pattern-level Hall violation raises
    ``StructurallySingularError``.
    """
    rows, cols, absv = _entry_triplets(a, values)
    live = absv > 0.0
    if live.any():
        try:
            return _matching(a.n, rows[live], cols[live], absv[live])
        except ValueError:
            pass                    # value support deficient — go structural
    try:
        return _matching(a.n, rows, cols, np.ones(len(rows)))
    except ValueError:
        raise StructurallySingularError(
            f"pattern has no complete transversal at n={a.n} — the matrix "
            f"is structurally singular; no static pivoting can repair it"
        ) from None


def equilibrate(n: int, rows: np.ndarray, cols: np.ndarray,
                absv: np.ndarray, *, iters: int = 8
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Ruiz row/column equilibration of the |A| triple: returns positive
    ``(r, c)`` with ``r[rows] * absv * c[cols]`` having row and column
    sup-norms approaching 1.  A fixed iteration count (convergence is
    quadratic; 8 is ample) keeps results deterministic and refactorization
    value-only.  All-zero rows/columns keep scale 1.0."""
    r = np.ones(n, dtype=np.float64)
    c = np.ones(n, dtype=np.float64)
    for _ in range(max(1, iters)):
        s = absv * r[rows] * c[cols]
        rmax = np.zeros(n, dtype=np.float64)
        np.maximum.at(rmax, rows, s)
        r /= np.sqrt(np.where(rmax > 0.0, rmax, 1.0))
        s = absv * r[rows] * c[cols]
        cmax = np.zeros(n, dtype=np.float64)
        np.maximum.at(cmax, cols, s)
        c /= np.sqrt(np.where(cmax > 0.0, cmax, 1.0))
    return r, c


@dataclasses.dataclass(frozen=True)
class DeviceRobust:
    """A ``RobustPlan``'s index and scale arrays on one device, with the
    transforms on tensors there (elementwise products and gathers, so each
    is bitwise the numpy form on the same inputs)."""

    perm: torch.Tensor
    row_scale: torch.Tensor
    col_scale: torch.Tensor
    value_map: torch.Tensor
    value_scale: torch.Tensor

    def transform_values(self, values: torch.Tensor) -> torch.Tensor:
        """CSR values of A -> CSR values of A_f; (nnz,) or (B, nnz)."""
        return values[..., self.value_map] * self.value_scale

    def apply_rhs(self, b: torch.Tensor) -> torch.Tensor:
        """b of ``A x = b`` -> rhs of the factored system: Dr·P·b
        ((n,) or multi-RHS (n, k))."""
        pb = b[self.perm]
        return (self.row_scale * pb if b.dim() == 1
                else self.row_scale[:, None] * pb)

    def apply_solution(self, y: torch.Tensor) -> torch.Tensor:
        """Solution y of the factored system -> x of ``A x = b``: Dc·y."""
        return (self.col_scale * y if y.dim() == 1
                else self.col_scale[:, None] * y)

    def apply_rhs_batch(self, b: torch.Tensor) -> torch.Tensor:
        """``apply_rhs`` over a leading system axis: (B, n) or (B, n, k)."""
        pb = b[:, self.perm]
        return (self.row_scale * pb if b.dim() == 2
                else self.row_scale[None, :, None] * pb)

    def apply_solution_batch(self, y: torch.Tensor) -> torch.Tensor:
        return (self.col_scale * y if y.dim() == 2
                else self.col_scale[None, :, None] * y)


@dataclasses.dataclass(frozen=True)
class RobustPlan:
    """The value-independent static-pivoting state stored on an ``LUPlan``
    (plain numpy arrays only — plans keep pickling).

    The factored system is ``A_f = Dr · P · A · Dc``: factored row j is
    original row ``perm[j]`` scaled by ``row_scale[j]``; column j is scaled
    by ``col_scale[j]``.  ``A x = b`` becomes ``A_f y = apply_rhs(b)`` with
    ``x = apply_solution(y)``.  ``value_map``/``value_scale`` replay the
    whole transform on a CSR value vector in O(nnz):
    ``A_f values[p] = values[value_map[p]] * value_scale[p]``.

    ``transform_values``/``transform_dense`` are the host (numpy) forms;
    ``on(device)`` puts the index and scale arrays on a device as a
    ``DeviceRobust``, whose ``transform_values`` and ``apply_*`` take and
    return tensors there (``LUPlan`` keeps one per device in its cache).
    """

    perm: np.ndarray          # (n,) factored row j <- original row perm[j]
    row_scale: np.ndarray     # (n,) Dr, indexed by *factored* row
    col_scale: np.ndarray     # (n,) Dc, indexed by column
    value_map: np.ndarray     # (nnz,) factored CSR slot -> original CSR slot
    value_scale: np.ndarray   # (nnz,) Dr·Dc factor per factored slot

    @property
    def n(self) -> int:
        return len(self.perm)

    def on(self, device) -> DeviceRobust:
        """The index and scale arrays on ``device``."""
        return DeviceRobust(*(torch.as_tensor(getattr(self, f.name),
                                              device=device)
                              for f in dataclasses.fields(DeviceRobust)))

    # -- value transform (the per-refactorization O(nnz) work), on the host
    def transform_values(self, values: np.ndarray) -> np.ndarray:
        """CSR values of A -> CSR values of A_f; ``values`` is (nnz,) or a
        batched (B, nnz) stack (the gather/scale broadcasts)."""
        values = np.asarray(values, dtype=np.float64)
        return values[..., self.value_map] * self.value_scale

    def transform_dense(self, dense: np.ndarray) -> np.ndarray:
        """Dense (n, n) values of A -> dense values of A_f."""
        dense = np.asarray(dense, dtype=np.float64)
        return (dense[self.perm] * self.row_scale[:, None]
                * self.col_scale[None, :])


def build_robust_prepass(a: CSRMatrix, values: np.ndarray, *,
                         scale_iters: int = 8
                         ) -> Tuple[CSRMatrix, RobustPlan]:
    """The analyze-time static-pivoting pre-pass: returns the permuted
    structural matrix ``a_f`` (whose pattern the symbolic fixpoint runs on)
    and the ``RobustPlan`` that replays the transform per value set.

    ``values`` is the *representative* value set the permutation is chosen
    from: one matching serves a whole refactorization stream whose values
    drift but whose magnitude structure persists (Newton iterations,
    transient sweeps); tiny-pivot perturbation + iterative refinement
    absorb the drift, and a fresh ``analyze`` re-picks the transversal when
    they do not.
    """
    rows, cols, absv = _entry_triplets(a, values)
    perm = max_product_transversal(a, values)
    inv = np.empty(a.n, dtype=np.int64)
    inv[perm] = np.arange(a.n, dtype=np.int64)
    new_rows = inv[rows]
    order = np.lexsort((cols, new_rows))
    indptr = np.zeros(a.n + 1, dtype=np.int64)
    np.add.at(indptr, new_rows + 1, 1)
    a_f = CSRMatrix(n=a.n, indptr=np.cumsum(indptr),
                    indices=cols[order].astype(np.int32))
    fr, fc = new_rows[order], cols[order]
    r, c = equilibrate(a.n, fr, fc, absv[order], iters=scale_iters)
    robust = RobustPlan(perm=perm, row_scale=r, col_scale=c,
                        value_map=order, value_scale=r[fr] * c[fc])
    return a_f, robust
