"""Fill-reducing orderings.

The paper reorders with ParMETIS before symbolic factorization.  Ordering quality
is orthogonal to the symbolic *algorithm* (DESIGN.md §8.5); we provide RCM (via
scipy), natural, and random orderings so benchmarks can show the algorithm across
ordering regimes.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from repro_torch.sparse.csr import CSRMatrix, csr_from_coo


def _to_scipy(a: CSRMatrix) -> sp.csr_matrix:
    data = np.ones(a.nnz, dtype=np.float32)
    return sp.csr_matrix((data, a.indices.astype(np.int64), a.indptr), shape=(a.n, a.n))


def natural_order(a: CSRMatrix) -> np.ndarray:
    return np.arange(a.n, dtype=np.int64)


def random_order(a: CSRMatrix, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(a.n).astype(np.int64)


def rcm_order(a: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee on the symmetrized pattern (standard practice for
    nonsymmetric LU: order A + A^T)."""
    s = _to_scipy(a)
    sym = ((s + s.T) > 0).astype(np.float32)
    perm = reverse_cuthill_mckee(sp.csr_matrix(sym), symmetric_mode=True)
    return np.asarray(perm, dtype=np.int64)


def permute_csr(a: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Symmetric permutation: B = P A P^T, with
    B[new_i, new_j] = A[perm[new_i], perm[new_j]]."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(a.n, dtype=np.int64)
    rows = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    cols = a.indices.astype(np.int64)
    return csr_from_coo(a.n, inv[rows], inv[cols])
