"""Structural CSR from COO index lists, as plain numpy arrays.

A frozen copy of the arithmetic of ``repro_torch.sparse.csr.csr_from_coo``,
so the benchmark's inputs do not move when the program's helpers do."""
from __future__ import annotations

import numpy as np


def with_diagonal(n: int, rows, cols):
    rows = np.concatenate([np.asarray(rows, dtype=np.int64),
                           np.arange(n, dtype=np.int64)])
    cols = np.concatenate([np.asarray(cols, dtype=np.int64),
                           np.arange(n, dtype=np.int64)])
    return rows, cols


def csr_from_coo(n: int, rows, cols):
    """(indptr int64 (n+1,), indices int32 (nnz,)): deduplicated, each row's
    columns sorted."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    keys = np.unique(rows * n + cols)
    rows, cols = keys // n, keys % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols.astype(np.int32)
