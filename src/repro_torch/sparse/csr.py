"""CSR sparse-matrix container and conversions used by the symbolic-factorization core.

The graph G(A) of a square sparse matrix A has an edge u -> w for every structural
nonzero A[u, w] with u != w (diagonal entries are self-loops and are dropped — the
paper does the same, Fig 1).  The GSoFa fixpoint consumes the *in-neighbor* lists
(transpose graph) in padded ELL form so that one relaxation superstep is a dense
gather + masked min, which is the TPU-idiomatic shape (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Structural CSR (pattern only — symbolic factorization ignores values)."""

    n: int
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32, column ids, sorted within each row

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i]:self.indptr[i + 1]]

    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def to_dense(self) -> np.ndarray:
        dense = np.zeros((self.n, self.n), dtype=bool)
        for i in range(self.n):
            dense[i, self.row(i)] = True
        return dense

    def struct_symmetry(self) -> float:
        """Fraction of off-diagonal nonzeros whose transpose position is
        also nonzero."""
        d = self.to_dense()
        np.fill_diagonal(d, False)
        total = int(d.sum())
        if total == 0:
            return 1.0
        return float((d & d.T).sum()) / total

    def validate(self) -> None:
        assert self.indptr.shape == (self.n + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)
        assert np.all(np.diff(self.indptr) >= 0)
        if len(self.indices):
            assert self.indices.min() >= 0 and self.indices.max() < self.n
        for i in range(self.n):
            r = self.row(i)
            assert np.all(np.diff(r) > 0), f"row {i} not strictly sorted"


def csr_from_coo(n: int, rows: np.ndarray, cols: np.ndarray, *,
                 drop_diagonal: bool = False) -> CSRMatrix:
    """Build a deduplicated, row-sorted structural CSR from COO index lists."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if drop_diagonal:
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
    # dedup via linear keys
    keys = rows * n + cols
    keys = np.unique(keys)
    rows, cols = keys // n, keys % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(n=n, indptr=indptr, indices=cols.astype(np.int32))


def csr_from_dense(dense: np.ndarray, *, drop_diagonal: bool = False) -> CSRMatrix:
    dense = np.asarray(dense) != 0
    rows, cols = np.nonzero(dense)
    return csr_from_coo(dense.shape[0], rows, cols, drop_diagonal=drop_diagonal)


def transpose_csr(a: CSRMatrix) -> CSRMatrix:
    """Pattern transpose (gives the in-neighbor graph)."""
    rows = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    return csr_from_coo(a.n, a.indices.astype(np.int64), rows)


def csr_to_ell(a: CSRMatrix, *, pad_value: int | None = None,
               drop_diagonal: bool = True) -> Tuple[np.ndarray, int]:
    """Convert to padded ELL: (n, K) int32 neighbor table.

    ``pad_value`` defaults to ``n`` — the GSoFa relaxation masks neighbors with
    ``u < src``; since ``src < n`` always, a pad id of ``n`` is masked for free.
    """
    if pad_value is None:
        pad_value = a.n
    rows = []
    kmax = 1
    for i in range(a.n):
        r = a.row(i)
        if drop_diagonal:
            r = r[r != i]
        rows.append(r)
        kmax = max(kmax, len(r))
    ell = np.full((a.n, kmax), pad_value, dtype=np.int32)
    for i, r in enumerate(rows):
        ell[i, : len(r)] = r
    return ell, kmax


def drop_diagonal_csr(a: CSRMatrix) -> CSRMatrix:
    rows = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    return csr_from_coo(a.n, rows, a.indices.astype(np.int64), drop_diagonal=True)


def union_csr(a: CSRMatrix, b: CSRMatrix) -> CSRMatrix:
    assert a.n == b.n
    ra = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    rb = np.repeat(np.arange(b.n, dtype=np.int64), np.diff(b.indptr))
    return csr_from_coo(a.n, np.concatenate([ra, rb]),
                        np.concatenate([a.indices.astype(np.int64),
                                        b.indices.astype(np.int64)]))


def dense_block_adjacency(a: CSRMatrix, block: int, *,
                          transpose: bool = True) -> np.ndarray:
    """Dense (n_pad, n_pad) uint8 adjacency, padded up to a multiple of ``block``.

    ``adj[u, v] == 1`` iff edge u -> v (in the *original* orientation when
    ``transpose=False``; the relaxation kernel wants in-edges as rows of the
    u-axis so the default materializes A's own orientation: row u lists the
    vertices v that u points to — the kernel reduces over u).
    """
    n_pad = ((a.n + block - 1) // block) * block
    adj = np.zeros((n_pad, n_pad), dtype=np.uint8)
    for u in range(a.n):
        r = a.row(u)
        r = r[r != u]
        adj[u, r] = 1
    if transpose:
        pass  # row u -> columns v is already the reduce-over-u layout
    return adj
