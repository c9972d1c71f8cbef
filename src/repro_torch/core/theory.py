"""Ground-truth oracles for symbolic LU fill (Theorem 1, Rose & Tarjan).

Two independent oracles (dense, O(n^3), small-n test use only):

1. ``elimination_fill`` — simulate symbolic Gaussian elimination directly
   (the *definition* of fill).
2. ``minimax_fill`` — Floyd-Warshall in the (min, max) "bottleneck path"
   semiring; fill at (i, j) iff the minimal-over-paths maximum intermediate
   vertex on an i->j path is < min(i, j).  This is Theorem 1 verbatim and is
   also the fixpoint the GSoFa label array converges to (DESIGN.md §2).

Agreement of the two (tests/test_torch_bubble.py) validates the
bottleneck-semiring reading of Theorem 1 that K1 (the CUDA min-max relax)
relies on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.csr import CSRMatrix

INF = np.int64(1 << 40)


def elimination_fill(a: CSRMatrix) -> np.ndarray:
    """Dense boolean L+U pattern by symbolic right-looking elimination."""
    s = a.to_dense().copy()
    np.fill_diagonal(s, True)
    n = a.n
    for k in range(n):
        rows = np.nonzero(s[k + 1:, k])[0] + k + 1
        if len(rows):
            s[np.ix_(rows, np.arange(k + 1, n))] |= s[k, k + 1:]
    return s


def minimax_closure(a: CSRMatrix) -> np.ndarray:
    """B[i, j] = min over directed paths i->j of (max intermediate vertex id),
    with -1 for a direct edge and INF when unreachable.  Floyd-Warshall in the
    (min, max) semiring, k ascending."""
    n = a.n
    b = np.full((n, n), INF, dtype=np.int64)
    for i in range(n):
        cols = a.row(i)
        b[i, cols[cols != i]] = -1
    for k in range(n):
        via = np.maximum.outer(b[:, k], b[k, :])
        via = np.maximum(via, k)
        via[b[:, k] >= INF] = INF
        via[:, b[k, :] >= INF] = INF
        b = np.minimum(b, via)
    return b


def minimax_fill(a: CSRMatrix) -> np.ndarray:
    """Dense boolean L+U pattern via Theorem 1 on the minimax closure."""
    b = minimax_closure(a)
    n = a.n
    i = np.arange(n)
    thresh = np.minimum.outer(i, i)
    filled = b < thresh
    np.fill_diagonal(filled, True)
    return filled


def fill_ratio(a: CSRMatrix, filled: np.ndarray) -> float:
    """#fill-ins / nnz(A) — the Table I '#Fill-in/nnz(A)' statistic."""
    orig = a.to_dense()
    np.fill_diagonal(orig, True)
    new = filled & ~orig
    return float(new.sum()) / max(1, int(orig.sum()))
